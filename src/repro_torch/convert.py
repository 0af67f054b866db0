"""Carry an index built by the JAX package across to the port.

The JAX package's FAVOR state is numpy on the host -- the HNSW arrays, the
attribute table and the schema -- so it crosses as plain arrays and the
port builds its device state from them.  ``FavorIndex.load`` of an index the
JAX package saved goes through the same function.
"""
from __future__ import annotations

import numpy as np

from .core import filters as F
from .core.favor import FavorIndex
from .core.hnsw import HnswIndex, HnswParams

_PARAM_FIELDS = ("M", "M0", "efc", "ml", "alpha", "heuristic", "seed")


def _params(params) -> HnswParams:
    if isinstance(params, HnswParams):
        return params
    get = (params.get if isinstance(params, dict)
           else lambda k, default=None: getattr(params, k, default))
    return HnswParams(**{k: get(k) for k in _PARAM_FIELDS
                         if get(k) is not None})


def _schema(schema) -> F.Schema:
    """A Schema, an object with ``.columns`` (the JAX package's Schema), or
    a sequence of columns / (name, kind, vocab) triples."""
    if isinstance(schema, F.Schema):
        return schema
    cols = getattr(schema, "columns", schema)
    out = []
    for c in cols:
        name, kind, vocab = ((c.name, c.kind, c.vocab)
                             if hasattr(c, "name") else tuple(c))
        out.append(F.ColumnSpec(str(name), str(kind),
                                int(vocab) if str(kind) == "int" else None))
    return F.Schema(tuple(out))


def from_reference_arrays(*, vectors, levels, node_level, entry_point,
                          delta_d, params, ints, floats, schema,
                          max_level: int | None = None, norms=None,
                          spec=None, device=None) -> FavorIndex:
    """Build the port's FavorIndex on ``device`` (None = the CUDA device)
    from the JAX package's index state as numpy arrays: the HnswIndex's
    vectors, levels, node_level, entry_point, delta_d and params (an
    HnswParams of either package or a dict), the attribute ints/floats and
    the schema.  ``norms`` (N,) are recomputed from the vectors when not
    given, as ``HnswIndex.load`` does."""
    levels = [np.asarray(lv, np.int32) for lv in levels]
    if max_level is None:
        max_level = len(levels) - 1 if int(entry_point) >= 0 else -1
    index = HnswIndex(
        vectors=np.ascontiguousarray(vectors, np.float32),
        levels=levels,
        node_level=np.asarray(node_level, np.int16),
        entry_point=int(entry_point),
        max_level=int(max_level),
        delta_d=float(delta_d),
        params=_params(params),
        norms=None if norms is None else np.asarray(norms, np.float32))
    attrs = F.AttributeTable(_schema(schema), np.asarray(ints, np.int32),
                             np.asarray(floats, np.float32))
    return FavorIndex(index, attrs, spec, device=device)
