"""Carry an index built by the JAX package, or a model's parameters, across
to the port.

The JAX package's FAVOR state is numpy on the host -- the HNSW arrays, the
attribute table, the schema and, for a quantized index, the codebook and
the codes -- so it crosses as plain arrays and the port builds its device
state from them: a JAX-built quantized index serves the same codes and LUTs
in both packages.  ``FavorIndex.load`` of an index the
JAX package saved goes through the same function.

A model's parameters cross as their tree: nested dicts of arrays, path for
path (``params_from_reference``); the model modules' ``named_parameters()``
are those paths joined by ``.``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import filters as F
from .core.favor import FavorIndex
from .core.hnsw import HnswIndex, HnswParams
from .device import resolve_device
from .quant import PQCodebook, SQCodebook

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
                          centroids=None, lo=None, scale=None, codes=None,
                          spec=None, device=None) -> FavorIndex:
    """Build the port's FavorIndex on ``device`` (None = the CUDA device)
    from the JAX package's index state as numpy arrays: the HnswIndex's
    vectors, levels, node_level, entry_point, delta_d and params (an
    HnswParams of either package or a dict), the attribute ints/floats and
    the schema.  ``norms`` (N,) are recomputed from the vectors when not
    given, as ``HnswIndex.load`` does.  A quantized index also passes its
    codebook -- PQ ``centroids`` (M, K, dsub), or SQ ``lo`` and ``scale``
    (d,) -- and optionally its ``codes`` (N, M or d) uint8; without codes
    the port encodes the rows itself."""
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
    codebook = None
    if centroids is not None:
        codebook = PQCodebook(np.asarray(centroids, np.float32), index.dim)
    elif lo is not None:
        codebook = SQCodebook(np.asarray(lo, np.float32),
                              np.asarray(scale, np.float32), index.dim)
    return FavorIndex(index, attrs, spec, codebook=codebook, codes=codes,
                      device=device)


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_reference(tree, *, device=None, dtype=None) -> dict:
    """The port's parameter tree from the JAX package's: nested dicts of
    arrays (numpy, or anything ``np.asarray`` reads, bf16 included) to
    nested dicts of tensors on ``device`` (None = the CUDA device), path for
    path, each in its own dtype unless ``dtype`` is given."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, dev, dtype)

    return walk(tree)
