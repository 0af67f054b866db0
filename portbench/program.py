"""The system under test, the PyTorch/CUDA port (``repro_torch``), seen
from the benchmark: its index loader, its filters, its batch entry point
and the counters its results carry.  Nothing else of the program is used.

The window drives ``repro_torch.core.router.execute(backend, queries,
filters, opts, defer=True)``: ``FavorIndex.query``'s own path with the
deferred finish, so one batch's host phase can run while the batch before
it is still on the device (``Runner.dispatch`` / ``Runner.finish``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import from_reference_arrays
from repro_torch.core import filters as F
from repro_torch.core.hnsw import HnswParams
from repro_torch.core.options import (BuildSpec, ObsSpec, QuantSpec,
                                     SearchOptions)
from repro_torch.core.router import execute
from repro_torch.core.selector import SelectorConfig
from repro_torch.obs import Obs

from . import data

# The keys a configuration may carry: ``search`` (read by the harness and
# the index, then the optional ``SearchOptions`` fields) and the optional
# ``quant`` object (``QuantSpec``'s fields: the compressed format the
# loader trains and encodes at set-up).  Only the fields a deployment
# states; the rest keep the port's defaults, and the re-rank depth has one
# source, ``quant.rerank``.
SEARCH_KEYS = ("k", "ef", "width", "lam")
SEARCH_OPTION_KEYS = ("use_pq", "graph_quant")
QUANT_KEYS = ("kind", "m", "nbits", "rerank")


def build_spec(cfg: dict) -> BuildSpec:
    """The index's ``BuildSpec``: the selector's lambda and, where the
    configuration has a ``quant`` object, its ``QuantSpec`` (the codebook is
    trained from ``HnswParams.seed``, so every run serves the same codes)."""
    q = cfg.get("quant")
    return BuildSpec(selector=SelectorConfig(lam=cfg["search"]["lam"]),
                     quant=None if q is None else QuantSpec(**q))


def search_options(cfg: dict, max_steps: int = 0) -> SearchOptions:
    """The window's ``SearchOptions``: k, ef, and the optional fields the
    configuration's ``search`` object names."""
    s = cfg["search"]
    return SearchOptions(k=s["k"], ef=s["ef"], max_steps=max_steps,
                         **{key: s[key] for key in SEARCH_OPTION_KEYS
                            if key in s})


def to_filter(spec) -> F.Filter:
    """The port's filter for one drawn spec (``traffic``)."""
    op = spec[0]
    if op == "and":
        return F.And(*(to_filter(s) for s in spec[1:]))
    if op == "or":
        return F.Or(*(to_filter(s) for s in spec[1:]))
    if op == "not":
        return F.Not(to_filter(spec[1]))
    if op == "eq":
        return F.Equality(spec[1], spec[2])
    if op == "in":
        return F.Inclusion(spec[1], spec[2])
    if op == "range":
        return F.Range(spec[1], spec[2], spec[3])
    raise ValueError(f"unknown filter op {op!r}")


def make_index(cfg: dict, base: dict, graph: dict, seed: int, device):
    """The port's FavorIndex over the benchmark's rows and graph, through
    the loader ``FavorIndex.load`` uses (host arrays in, the port's own
    padding, upload and selectivity sample, and under ``quant`` the
    codebook's training and the rows' encoding on ``device``)."""
    h = cfg["hnsw"]
    icols, fcols = data.schema_columns(cfg)
    schema = [(n, k, v or 0) for n, k, v in icols + fcols]
    params = HnswParams(M=h["M"], M0=h["M0"], efc=h["efc"], alpha=h["alpha"],
                        seed=int(seed) % (1 << 31))
    return from_reference_arrays(
        vectors=base["vectors"].cpu().numpy(), levels=graph["levels"],
        node_level=graph["node_level"], entry_point=graph["entry_point"],
        max_level=graph["max_level"], delta_d=graph["delta_d"], params=params,
        ints=base["ints"].cpu().numpy(), floats=base["floats"].cpu().numpy(),
        schema=schema, spec=build_spec(cfg), device=device)


class Runner:
    """One index and its options; ``traced`` turns on the router's span
    trace (the ``compile`` and ``graph`` spans) and the profiler ranges of
    its dispatches.  ``max_steps`` > 0 cuts every traversal to that many
    waves (``SearchOptions.max_steps``): a planted fault, never a cell's
    setting."""

    def __init__(self, fi, cfg: dict, *, traced: bool = False,
                 max_steps: int = 0):
        self.fi = fi
        self.n = fi.index.n
        self.opts = search_options(cfg, max_steps)
        self.obs = (Obs(ObsSpec(trace_cap=1, slow_ms=None,
                                kernel_annotations=True))
                    if traced else None)

    def dispatch(self, queries: torch.Tensor, filters: list):
        """The batch's host phase and device dispatch (a pending result)."""
        return execute(self.fi.backend, queries, filters, self.opts,
                       obs=self.obs, defer=True)

    def finish(self, pending) -> dict:
        """Wait for a dispatched batch; its answers and counters."""
        res = pending.finish()
        out = {"ids": res.ids, "dists": res.dists,
               "routed_brute": np.asarray(res.routed_brute, bool)}
        graph = ~out["routed_brute"]
        out["waves"] = (int(res.waves[graph].max())
                        if res.waves is not None and graph.any() else 0)
        out["hops"] = (int(res.hops[graph].sum())
                       if res.hops is not None and graph.any() else 0)
        if self.obs is not None:
            spans = self.obs.tracer.traces[-1].stage_ms()
            out["compile_ms"] = spans.get("compile", 0.0)
            out["graph_ms"] = spans.get("graph", 0.0)
        return out

    def query(self, queries, filters):
        """``FavorIndex.query`` on one batch (the serial path)."""
        return self.fi.query(queries, filters, self.opts)

