"""Selector routing: the host-side online pipeline (paper section 4.1).

    compile filters -> estimate p_hat -> plan routes -> partition the batch
    -> backend.search_graph / backend.search_brute -> reassemble

``execute()`` is the single entry point; ``FavorIndex.query`` and
``ServeEngine`` call it with their backend.  With ``SearchOptions.batch``
set it bucket-pads the estimate call and each route's sub-batch
(core.batching) and records every shape into ``registry=`` when one is
given.  The serving hooks are those of the JAX package's ``execute``:
tenant ``scopes`` for a scope-aware backend, ``obs`` spans and profiler
ranges, the duck-typed ``lookup_result`` / ``record_result`` backend hooks,
and deferred finishing (``defer=True`` -> ``PendingExecution``).
"""
from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from . import batching
from . import filters as F
from . import selector
from .options import ROUTES, SearchOptions
from ..device import to_host as _host
from ..obs.trace import host_wait


@dataclass
class SearchResult:
    ids: np.ndarray      # (B, k) int64, -1 padded
    dists: np.ndarray    # (B, k) float32, +inf padded
    p_hat: np.ndarray    # (B,)
    routed_brute: np.ndarray  # (B,) bool
    # per-query graph traversal diagnostics: 0 for brute-routed (and
    # cache-served) queries, and ``None`` for the whole batch when a graph
    # sub-batch ran on a backend that does not report them
    hops: np.ndarray | None     # (B,) or None
    path_td: np.ndarray | None  # (B,) or None
    # waves: loop iterations the graph sub-batch's lane-compacted traversal
    # ran (shared by every lane of the sub-batch)
    waves: np.ndarray | None = None  # (B,) or None
    elapsed_s: float = 0.0

    @property
    def qps(self) -> float:
        return len(self.ids) / max(self.elapsed_s, 1e-12)


@dataclass(eq=False)
class PendingExecution:
    """In-flight result of ``execute(..., defer=True)``.

    The host phase (filter compile, cache lookup, selectivity estimate,
    routing, bucket padding, backend dispatch) has already run; what is
    left in flight is the device work the backend queued without waiting
    for it (the brute scans, and the graph route's last copies -- the
    traversal waits on the device once per wave, so it has finished).
    Dispatch ended by queuing the copies of the outputs to the host behind
    that work (``copy_down``), so ``finish()`` waits for this batch alone,
    not for a batch dispatched after it; it then reassembles the batch and
    fires the backend's ``record_result`` hook plus the obs trace.
    Passing ``hook_lock`` runs only those *mutating* host hooks under the
    lock -- the device wait never holds it.  ``finish()`` is idempotent
    and may be called from any thread: the first call materializes the
    SearchResult, later (or concurrent) calls return the same object.
    """
    backend: object
    opts: SearchOptions
    b: int
    t0: float
    ids: np.ndarray
    dists: np.ndarray
    p_hat: np.ndarray
    routed_brute: np.ndarray
    hops: np.ndarray
    path_td: np.ndarray
    waves: np.ndarray
    miss: np.ndarray
    tr: object = None
    obs: object = None
    programs: dict | None = None
    mq: object = None
    mprogs: dict | None = None
    mp_hat: np.ndarray | None = None
    plan: RoutePlan | None = None
    gi: np.ndarray | None = None
    bi: np.ndarray | None = None
    graph_out: dict | None = None
    brute_out: tuple | None = None
    graph_diag: bool = True
    waves_diag: bool = True
    # one per card the outputs are on, recorded behind their copies
    events: list = field(default_factory=list)
    _result: SearchResult | None = None
    _once: threading.Lock = field(default_factory=threading.Lock)

    def finish(self, hook_lock=None) -> SearchResult:
        if self._result is not None:
            return self._result
        with self._once:
            if self._result is None:
                self._result = self._finish(hook_lock)
        return self._result

    def copy_down(self) -> None:
        """Queue, behind the batch's device work, the copies to the host
        that ``_finish`` reads: the outputs, the queries a
        ``record_result`` hook takes and, in a sampled trace, the device
        scalars of its spans; then record an event per card behind them.
        Pinned buffers and non-blocking copies on a card; elsewhere the
        values stay as they are (a CPU tensor's ``.cpu()`` is itself)."""
        cards = set()

        def down(t):
            if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
                return t
            cards.add(t.device)
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t, non_blocking=True)

        if self.graph_out is not None:
            self.graph_out = {k: down(v) for k, v in self.graph_out.items()}
        if self.brute_out is not None:
            self.brute_out = tuple(down(v) for v in self.brute_out)
        if getattr(self.backend, "record_result", None) is not None:
            self.mq = down(self.mq)
        if self.tr is not None:
            self.tr.map_scalars(down)
        for card in sorted(cards, key=str):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(card))
            self.events.append(ev)

    def _finish(self, hook_lock) -> SearchResult:
        ids, dists, miss = self.ids, self.dists, self.miss
        gi, bi = self.gi, self.bi
        # whether the copies had landed before the finish asked
        ready = (all(ev.query() for ev in self.events)
                 if self.tr is not None else None)
        # the wait for this batch's copies: the trace's ``finish_wait_ms``
        with (self.tr.wait("finish_wait_ms", "favor/finish/wait")
              if self.tr is not None else nullcontext()):
            for ev in self.events:
                ev.synchronize()
            graph = ({k: _host(v) for k, v in self.graph_out.items()}
                     if self.graph_out is not None else None)
            brute = (tuple(_host(v) for v in self.brute_out)
                     if self.brute_out is not None else None)
        if graph is not None:
            ids[miss[gi]] = graph["ids"][:len(gi)]
            dists[miss[gi]] = graph["dists"][:len(gi)]
            if "hops" in graph:
                self.hops[miss[gi]] = graph["hops"][:len(gi)]
                self.path_td[miss[gi]] = graph["path_td"][:len(gi)]
            else:
                self.graph_diag = False
            if "waves" in graph:
                self.waves[miss[gi]] = graph["waves"][:len(gi)]
            else:
                self.waves_diag = False
        if brute is not None:
            ids[miss[bi]] = brute[0][:len(bi)]
            dists[miss[bi]] = brute[1][:len(bi)]
        elapsed = time.perf_counter() - self.t0
        with (hook_lock if hook_lock is not None else nullcontext()):
            record = getattr(self.backend, "record_result", None)
            if record is not None and len(miss):
                with (self.tr.span("cache_record") if self.tr is not None
                      else nullcontext()):
                    record(_host(self.mq), self.mprogs, self.opts,
                           ids[miss], dists[miss], self.mp_hat,
                           self.plan.brute)
            if self.tr is not None:
                self.tr.attrs["finish_ready"] = int(ready)
                self.tr.attrs["cache_hits"] = int(self.b - len(miss))
                self.tr.attrs["graph"] = int(
                    self.b - int(self.routed_brute.sum()))
                self.tr.attrs["brute"] = int(self.routed_brute.sum())
                programs = self.programs
                self.obs.finish_trace(
                    self.tr, p_hat=self.p_hat,
                    routed_brute=self.routed_brute, ef=self.opts.ef,
                    signatures=lambda: F.batch_signatures(programs))
        return SearchResult(
            ids, dists, self.p_hat, self.routed_brute,
            self.hops if self.graph_diag else None,
            self.path_td if self.graph_diag else None,
            waves=self.waves if self.waves_diag else None,
            elapsed_s=elapsed)


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
    ``device``: valid/flo/fhi float32, imask int64 (uint32 bitmasks).
    Inside a traced ``compile`` span the upload is its ``upload_ms``."""
    stacked = F.compile_stacked(broadcast_filters(filters, batch), schema,
                                width)
    stacked["imask"] = stacked["imask"].astype(np.int64)
    with host_wait("upload_ms", "favor/compile/upload"):
        return {k: _upload(v, device) for k, v in stacked.items()}


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """``a`` on ``device``.  To a card it goes through pinned memory as a
    non-blocking copy, so the host does not wait for the work queued there
    (a pageable copy waits for the whole stream); elsewhere
    ``torch.as_tensor``."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a).pin_memory().to(device, non_blocking=True)


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
            defer: bool = False) -> SearchResult | PendingExecution:
    """Run one filtered-ANNS batch through ``backend`` (paper Fig. 1 online
    phase): result-cache fast path -> estimate -> route -> per-route
    execution -> reassembly.

    When ``opts.batch`` is a BatchSpec, the estimate call and each route
    sub-batch are bucket-padded before they reach the backend: pad rows
    carry an always-false filter program and a False entry in the ``valid``
    mask the backend receives, and are stripped on reassembly, so results
    are bit-identical to the unpadded path.  ``registry`` (a
    batching.ShapeRegistry) records every entry-point shape and the pad
    overhead paid.

    Backends may implement two duck-typed hooks (plain backends need
    neither):

      lookup_result(queries, programs, opts) -> None | {"hit": (B,) bool,
          "ids"/"dists"/"p_hat"/"routed_brute": hit-row arrays}
          served *before* estimation, so a hit skips the whole pipeline.
      record_result(queries, programs, opts, ids, dists, p_hat, routed_brute)
          called with the freshly computed miss rows after execution.

    ``scopes`` is an optional (B,) int array of per-request tenant/session
    scope ids (0 = unscoped).  It rides the stacked program dict as a
    ``"scope"`` sidecar row (sliced, padded with 0 and sub-batched in
    lockstep with the filter programs), but only when the backend declares
    ``scope_aware``; other backends never see it.

    ``obs`` is an optional ``repro_torch.obs.Obs``: when its tracer samples
    this batch, every stage below runs inside a span (wall time, route,
    bucket shape, pad fraction, cache hits), and -- when the spec enables
    kernel annotations -- inside a ``torch.profiler.record_function`` range
    named by the span's path (``favor/graph/search``).  The host's waits on
    the device are span attributes: ``compile``'s ``upload_ms``,
    ``estimate``'s ``read_ms``, the trace's ``finish_wait_ms``; the graph
    traversal adds its wave counters to ``search`` (``core.search``).
    Obs hooks only *observe*; results are bit-identical with obs absent,
    disabled, or sampled out.

    ``defer=True`` returns a ``PendingExecution`` after the host phase: the
    backend searches are dispatched and the copies of their outputs to the
    host queued behind them, but not waited for, and no mutating hook has
    fired.  The caller finishes the step -- possibly from another thread,
    possibly after dispatching more steps -- with ``pending.finish()``,
    which yields the identical SearchResult the synchronous path returns.
    """
    backend.validate(opts)
    dev = backend.device
    if isinstance(queries, torch.Tensor):
        queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    else:
        queries = _upload(np.ascontiguousarray(queries, np.float32), dev)
    b = queries.shape[0]

    tr = obs.start_trace(b) if obs is not None else None
    if tr is None:
        def _span(name, **attrs):
            return nullcontext()
    else:
        _span = tr.span

    with _span("compile", rows=b):
        programs = compile_programs(filters, backend.schema, b, device=dev)
    if scopes is not None and getattr(backend, "scope_aware", False):
        scopes = np.asarray(scopes, np.int32)
        if scopes.shape != (b,):
            raise ValueError(f"scopes must be shaped ({b},), "
                             f"got {scopes.shape}")
        if scopes.any():   # all-zero means unscoped: skip the sidecar
            programs["scope"] = _upload(scopes, dev)
    spec = opts.batch

    t0 = time.perf_counter()
    ids = np.full((b, opts.k), -1, np.int64)
    dists = np.full((b, opts.k), np.inf, np.float32)
    p_hat = np.zeros((b,), np.float32)
    routed_brute = np.zeros((b,), bool)
    hops = np.zeros((b,), np.int64)
    path_td = np.zeros((b,), np.int64)
    waves = np.zeros((b,), np.int64)
    lookup = getattr(backend, "lookup_result", None)
    with _span("cache_lookup") as sp:
        cached = (lookup(_host(queries), programs, opts)
                  if lookup else None)
        if sp is not None:
            sp.attrs["hits"] = (int(np.asarray(cached["hit"]).sum())
                                if cached is not None else 0)
    if cached is not None:
        hi = np.nonzero(np.asarray(cached["hit"], bool))[0]
        ids[hi] = _host(cached["ids"])
        dists[hi] = _host(cached["dists"])
        p_hat[hi] = _host(cached["p_hat"])
        routed_brute[hi] = _host(cached["routed_brute"])
        miss = np.nonzero(~np.asarray(cached["hit"], bool))[0]
    else:
        miss = np.arange(b)

    pend = PendingExecution(
        backend=backend, opts=opts, b=b, t0=t0, ids=ids, dists=dists,
        p_hat=p_hat, routed_brute=routed_brute, hops=hops, path_td=path_td,
        waves=waves, miss=miss, tr=tr, obs=obs, programs=programs)

    if len(miss):
        # no re-slicing when a sub-batch is the whole batch -- the common
        # case for plain (hook-less) backends
        full = len(miss) == b
        mq = queries if full else queries[torch.as_tensor(miss, device=dev)]
        mprogs = programs if full else take_programs(programs, miss)
        with _span("estimate", rows=len(miss)) as sp:
            if spec is None:
                batching.record(registry, "estimate", len(miss), len(miss))
                est = backend.estimate(mprogs)
            else:
                eprogs, evalid = batching.pad_programs(spec, mprogs)
                batching.record(registry, "estimate", len(evalid), len(miss))
                if sp is not None:
                    sp.attrs["bucket"] = int(len(evalid))
                est = backend.estimate(eprogs, valid=evalid)
            with host_wait("read_ms", "favor/estimate/read"):
                mp_hat = _host(est)[:len(miss)]
        with _span("route") as sp:
            plan = plan_routes(mp_hat, backend.sel_cfg.lam, opts.force)
            if sp is not None:
                sp.attrs["graph"] = int(len(plan.graph_idx))
                sp.attrs["brute"] = int(len(plan.brute_idx))
        p_hat[miss] = plan.p_hat
        routed_brute[miss] = plan.brute

        gi, bi = plan.graph_idx, plan.brute_idx
        pend.mq, pend.mprogs, pend.mp_hat = mq, mprogs, mp_hat
        pend.plan, pend.gi, pend.bi = plan, gi, bi
        if len(gi):
            with _span("graph", rows=len(gi)) as gspan:
                whole = len(gi) == len(miss)
                gq = mq if whole else mq[torch.as_tensor(gi, device=dev)]
                gprogs = mprogs if whole else take_programs(mprogs, gi)
                gp = mp_hat if whole else mp_hat[gi]
                gvalid = None
                if spec is not None:
                    with _span("pad"):
                        gq, gprogs, gp, gvalid = batching.pad_to_bucket(
                            spec, gq, gprogs, gp)
                bucket = int(gq.shape[0])
                if gspan is not None:
                    gspan.attrs["bucket"] = bucket
                    gspan.attrs["pad_frac"] = 1.0 - len(gi) / bucket
                batching.record(registry, "graph", bucket, len(gi), opts)
                with _span("search"):
                    pend.graph_out = backend.search_graph(
                        gq, gprogs, torch.as_tensor(gp, device=dev), opts,
                        valid=gvalid)
        if len(bi):
            with _span("brute", rows=len(bi)) as bspan:
                whole = len(bi) == len(miss)
                bq = mq if whole else mq[torch.as_tensor(bi, device=dev)]
                bprogs = mprogs if whole else take_programs(mprogs, bi)
                bvalid = None
                if spec is not None:
                    with _span("pad"):
                        bq, bprogs, _, bvalid = batching.pad_to_bucket(
                            spec, bq, bprogs)
                bucket = int(bq.shape[0])
                if bspan is not None:
                    bspan.attrs["bucket"] = bucket
                    bspan.attrs["pad_frac"] = 1.0 - len(bi) / bucket
                batching.record(registry, "brute", bucket, len(bi), opts)
                with _span("search"):
                    pend.brute_out = backend.search_brute(bq, bprogs, opts,
                                                          valid=bvalid)

    pend.copy_down()
    return pend if defer else pend.finish()
