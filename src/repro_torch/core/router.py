"""Selector routing: the host-side online pipeline (paper section 4.1).

    compile filters -> estimate p_hat -> plan routes -> partition the batch
    -> backend.search_graph / backend.search_brute -> reassemble

``execute()`` is the single entry point; ``FavorIndex.query`` calls it with
its ``LocalBackend``.  The JAX package's serving hooks on the same function
-- tenant ``scopes``, ``obs`` tracing, deferred finishing (``defer``) and the
bucket ``registry`` -- come with the serving slice of the port and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import filters as F
from . import selector
from .options import ROUTES, SearchOptions


@dataclass
class SearchResult:
    ids: np.ndarray      # (B, k) int64, -1 padded
    dists: np.ndarray    # (B, k) float32, +inf padded
    p_hat: np.ndarray    # (B,)
    routed_brute: np.ndarray  # (B,) bool
    # per-query graph traversal diagnostics: 0 for brute-routed queries
    hops: np.ndarray | None     # (B,)
    path_td: np.ndarray | None  # (B,)
    # waves: loop iterations the graph sub-batch's lane-compacted traversal
    # ran (shared by every lane of the sub-batch)
    waves: np.ndarray | None = None  # (B,)
    elapsed_s: float = 0.0

    @property
    def qps(self) -> float:
        return len(self.ids) / max(self.elapsed_s, 1e-12)


@dataclass(frozen=True)
class RoutePlan:
    """Per-query routing decision: True -> PreFBF brute scan."""
    p_hat: np.ndarray
    brute: np.ndarray

    @property
    def graph_idx(self) -> np.ndarray:
        return np.nonzero(~self.brute)[0]

    @property
    def brute_idx(self) -> np.ndarray:
        return np.nonzero(self.brute)[0]


def broadcast_filters(filters, batch: int) -> list:
    """One filter -> one per query; otherwise the count must match."""
    if isinstance(filters, F.Filter):
        filters = [filters] * batch
    filters = list(filters)
    if len(filters) != batch:
        raise ValueError(f"expected one filter per query: got {len(filters)} "
                         f"filters for {batch} queries")
    return filters


def compile_programs(filters, schema: F.Schema, batch: int,
                     width: int = 8, *, device) -> dict:
    """Compile + stack one DNF program per query into tensors on
    ``device``: valid/flo/fhi float32, imask int64 (uint32 bitmasks)."""
    filters = broadcast_filters(filters, batch)
    progs = [F.compile_filter(f, schema, width) for f in filters]
    stacked = F.stack_programs(progs)
    stacked["imask"] = stacked["imask"].astype(np.int64)
    return {k: torch.as_tensor(v, device=device) for k, v in stacked.items()}


def plan_routes(p_hat: np.ndarray, lam: float,
                force: str | None = None) -> RoutePlan:
    """Route each query by estimated selectivity (p_hat < lambda -> brute);
    ``force`` pins every query to one route."""
    if force not in ROUTES:
        raise ValueError(f"force must be one of {ROUTES}, got {force!r}")
    p_hat = np.nan_to_num(np.asarray(p_hat, np.float32), nan=1.0)
    if force == "brute":
        brute = np.ones(p_hat.shape, bool)
    elif force == "graph":
        brute = np.zeros(p_hat.shape, bool)
    else:
        brute = selector.route(p_hat, lam)
    return RoutePlan(p_hat, brute)


def take_programs(programs: dict, idx) -> dict:
    """Row-slice a stacked program dict to a sub-batch (on its device)."""
    any_t = next(iter(programs.values()))
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=any_t.device)
    return {k: v.index_select(0, idx) for k, v in programs.items()}


def execute(backend, queries, filters, opts: SearchOptions, *,
            registry=None, scopes=None, obs=None,
            defer: bool = False) -> SearchResult:
    """Run one filtered-ANNS batch through ``backend`` (paper Fig. 1 online
    phase): estimate -> route -> per-route execution -> reassembly."""
    for name, val in (("registry", registry), ("scopes", scopes),
                      ("obs", obs)):
        if val is not None:
            raise NotImplementedError(f"execute({name}=...) comes with the "
                                      "serving slice of the port")
    if defer:
        raise NotImplementedError("execute(defer=True) comes with the "
                                  "serving slice of the port")
    dev = backend.device
    if isinstance(queries, torch.Tensor):
        queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    else:
        queries = torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                                  device=dev)
    b = queries.shape[0]
    programs = compile_programs(filters, backend.schema, b, device=dev)

    t0 = time.perf_counter()
    ids = np.full((b, opts.k), -1, np.int64)
    dists = np.full((b, opts.k), np.inf, np.float32)
    hops = np.zeros((b,), np.int64)
    path_td = np.zeros((b,), np.int64)
    waves = np.zeros((b,), np.int64)

    p_hat = backend.estimate(programs).cpu().numpy()
    plan = plan_routes(p_hat, backend.sel_cfg.lam, opts.force)
    gi, bi = plan.graph_idx, plan.brute_idx
    graph_out = brute_out = None
    if len(gi):
        whole = len(gi) == b
        gq = queries if whole else queries[torch.as_tensor(gi, device=dev)]
        gprogs = programs if whole else take_programs(programs, gi)
        gp = torch.as_tensor(plan.p_hat[gi], device=dev)
        graph_out = backend.search_graph(gq, gprogs, gp, opts)
    if len(bi):
        whole = len(bi) == b
        bq = queries if whole else queries[torch.as_tensor(bi, device=dev)]
        bprogs = programs if whole else take_programs(programs, bi)
        brute_out = backend.search_brute(bq, bprogs, opts)

    if graph_out is not None:
        ids[gi] = graph_out["ids"].cpu().numpy()
        dists[gi] = graph_out["dists"].cpu().numpy()
        hops[gi] = graph_out["hops"].cpu().numpy()
        path_td[gi] = graph_out["path_td"].cpu().numpy()
        waves[gi] = graph_out["waves"].cpu().numpy()
    if brute_out is not None:
        ids[bi] = brute_out[0].cpu().numpy()
        dists[bi] = brute_out[1].cpu().numpy()
    # the .cpu() copies above waited for the device work
    return SearchResult(ids, dists, plan.p_hat, plan.brute, hops, path_td,
                        waves=waves, elapsed_s=time.perf_counter() - t0)
