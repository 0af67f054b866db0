"""Batched FAVOR serving engine (paper Figure 1 online phase, production
shape): request queue -> batch assembly -> selector routing -> per-route
compiled executables -> response reassembly + latency accounting.

Routing (section 4.1) happens on estimated selectivity *before* search; the
router splits each assembled batch into a brute sub-batch and a graph
sub-batch, bucket-padded when ``SearchOptions.batch`` is set.

The engine drives its backend through the shared ``router.execute``
pipeline, configured by one frozen ``SearchOptions``:

    eng = ServeEngine(LocalBackend(fi), SearchOptions(k=10, ef=96))

Passing a FavorIndex (optionally with the legacy k=/ef=/use_pq= kwargs)
still works and wraps it in a LocalBackend.  The port of the JAX package's
``repro.serving.engine``: the same API, instruments and stats; the device
work runs on the CUDA card unless the index lives on the CPU.

Pipelining: ``begin_batch`` runs the host phase and dispatches the device
work under the engine lock, ``finish_batch`` waits for it outside the lock.
The graph route waits on the device once per traversal wave, so its work
is done when ``begin_batch`` returns; what overlaps the next step's host
phase is the brute scans and the copies of the results.
"""
from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..core import batching
from ..core import filters as F
from ..core import router
from ..core.backend import LocalBackend
from ..core.batching import BatchSpec, ShapeRegistry
from ..core.favor import FavorIndex
from ..core.options import ObsSpec, SearchOptions
from ..obs import Obs

# p_hat lives in [0,1]; bounds straddle the default route lambda (0.01) so
# the selectivity-band request distribution is readable off one histogram
P_HAT_BUCKETS = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0)

# traversal wave counts: bounded by SearchConfig.steps (default 64 plus a
# compaction-ladder tail), pow-2 edges so the lane-compaction win (fewer
# full-width waves) shows up as mass shifting left
WAVE_BUCKETS = (4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


@dataclass
class Request:
    rid: int
    query: np.ndarray
    flt: "F.Filter"
    scope: int = 0
    t_submit: float = field(default_factory=time.perf_counter)


@dataclass
class Response:
    rid: int
    ids: np.ndarray
    dists: np.ndarray
    route: str
    p_hat: float
    latency_s: float


@dataclass(eq=False)
class _InflightStep:
    """One dispatched-but-unfinished engine step (``begin_batch`` output):
    the host phase ran and the device work is queued; ``finish_batch``
    waits for it and does the per-request accounting."""
    batch: list[Request]
    pending: "router.PendingExecution"
    queries: np.ndarray
    flts: list


def _bucket(n: int, spec: BatchSpec | None = None) -> int:
    """Bucket size for an n-row batch off the one BatchSpec ladder (the
    engine's legacy whole-batch pre-pad and the router's sub-batch padding
    round against the same source of truth; the old hardcoded
    (8, ..., 512) tuple was exactly BatchSpec's default ladder)."""
    return (spec or BatchSpec()).bucket_for(n)


class ServeEngine:
    """Queue/batch/deadline front-end over one execution backend."""

    def __init__(self, backend, opts: SearchOptions | None = None, *,
                 max_batch: int = 256, max_wait_ms: float = 2.0,
                 latency_window: int = 4096,
                 merge_delta_frac: float | None = None,
                 merge_background: bool = False,
                 obs: "Obs | ObsSpec | None" = None,
                 time_fn=time.perf_counter,
                 k: int | None = None, ef: int | None = None,
                 use_pq: bool | None = None):
        if isinstance(backend, FavorIndex):
            backend = LocalBackend(backend)
        if isinstance(opts, int) and not isinstance(opts, bool):
            # pre-1.1 second positional was k: ServeEngine(fi, 10)
            if k is not None:
                raise ValueError("k passed both positionally and by keyword")
            k, opts = opts, None
        if opts is not None and not isinstance(opts, SearchOptions):
            raise TypeError("opts must be a SearchOptions, got "
                            f"{type(opts).__name__}")
        if k is not None or ef is not None or use_pq is not None:
            if opts is not None:
                raise ValueError("pass either opts=SearchOptions(...) or "
                                 "legacy k=/ef=/use_pq= kwargs, not both")
            warnings.warn(
                "ServeEngine(k=, ef=, use_pq=) is deprecated; pass "
                "SearchOptions(...)", DeprecationWarning, stacklevel=2)
            opts = SearchOptions(k=k if k is not None else 10,
                                 ef=ef if ef is not None else 100,
                                 use_pq=bool(use_pq))
        self.backend = backend
        self.opts = opts or SearchOptions()
        # incompatible (backend, opts) pairs fail here, not mid-serve
        backend.validate(self.opts)
        self.max_batch = max_batch
        # one bucket ladder everywhere: the router pads sub-batches with
        # opts.batch; the legacy whole-batch pre-pad (opts.batch None)
        # rounds against the same BatchSpec ladder (its defaults ARE the
        # old hardcoded bucket tuple)
        self.pad_spec = self.opts.batch or BatchSpec()
        self.max_wait_s = max_wait_ms / 1e3
        if latency_window < 1:
            raise ValueError(f"latency_window must be >= 1, "
                             f"got {latency_window}")
        self.queue: list[Request] = []
        # injectable monotonic clock: latency/deadline behavior becomes
        # deterministic under a fake clock (obs + tests share it)
        self._time = time_fn
        # bounded rolling window: long-running engines must not grow memory
        # with request count (percentiles are over the last N requests)
        self.latencies: deque[float] = deque(maxlen=latency_window)
        self._next_rid = 0
        # compiled-shape + pad-overhead ledger (core.batching); fed by every
        # router.execute call and by warmup()
        self.registry = ShapeRegistry()
        # graph-traversal diagnostics are None-safe "unknown" once a backend
        # that doesn't report them (the sharded serve path) handled a graph
        # sub-batch
        self._diag_known = True
        # live-index mutation plumbing: merge_delta_frac schedules a
        # background compaction between steps once the unmerged delta grows
        # past that fraction of the base row count (None = manual merge only)
        if merge_delta_frac is not None and merge_delta_frac <= 0.0:
            raise ValueError(f"merge_delta_frac must be > 0, "
                             f"got {merge_delta_frac}")
        self.merge_delta_frac = merge_delta_frac
        # one reentrant lock guards every host-side mutable surface (queue,
        # counters, cache/backend hooks, merge commit).  Device work is
        # dispatched *inside* the lock but waited for *outside* it
        # (PendingExecution.finish), so pipelined steps overlap their
        # device waits while host phases stay serialized.  Reentrant
        # because finish-side hooks (_maybe_merge -> backend.merge) and the
        # merge controller's commit both re-enter engine methods.
        self._lock = threading.RLock()
        # one metrics registry serves every stats surface (repro.obs): the
        # engine records typed instruments, and nested legacy dicts (shape
        # ledger, cache layers, scorers, live gauges) join as views, so
        # snapshot()/prometheus_text() export the whole stack
        if obs is None or isinstance(obs, ObsSpec):
            obs = Obs(obs, time_fn=time_fn)
        elif not isinstance(obs, Obs):
            raise TypeError("obs must be an Obs, ObsSpec or None, got "
                            f"{type(obs).__name__}")
        self.obs = obs
        reg = obs.registry
        self._m_requests = reg.counter(
            "favor_requests_total", "Requests served, by route",
            labels=("route",))
        self._m_batches = reg.counter(
            "favor_batches_total", "Engine batches dispatched")
        self._m_latency = reg.histogram(
            "favor_request_latency_seconds",
            "End-to-end request latency (submit to response)",
            buckets=obs.spec.latency_buckets)
        self._m_p_hat = reg.histogram(
            "favor_p_hat", "Estimated selectivity of served requests",
            buckets=P_HAT_BUCKETS)
        self._m_hops = reg.counter(
            "favor_graph_hops_total",
            "Graph-traversal hops across served requests")
        self._m_path_td = reg.counter(
            "favor_graph_path_td_total",
            "Exclusion-distance path totals across served requests")
        self._m_waves = reg.histogram(
            "favor_graph_waves",
            "Traversal wave count (lane-compacted while_loop iterations) "
            "observed by each served request, by route",
            labels=("route",), buckets=WAVE_BUCKETS)
        self._m_bytes_hop = reg.gauge(
            "favor_bytes_per_hop",
            "Bytes one gathered neighbor row streams from HBM under this "
            "engine's graph scorer (4*d f32, M codes PQ, d codes SQ)")
        bph = getattr(self._base_backend(), "bytes_per_hop", None)
        if bph is not None:
            self._m_bytes_hop.set(float(bph(self.opts)))
        self._m_mutations = reg.counter(
            "favor_mutations_total", "Live-index mutations, by operation",
            labels=("op",))
        self._m_inflight = reg.gauge(
            "favor_inflight_steps",
            "Engine steps dispatched to the device but not yet finished "
            "(pipelined serving depth)")
        self._last_step_end = 0.0   # perf_counter of last finish_batch
        self._m_merge_active = reg.gauge(
            "favor_merge_active",
            "1 while a background merge is building or committing")
        self._m_merge_s = reg.histogram(
            "favor_merge_seconds",
            "Wall time of one whole merge (prepare + commit)",
            buckets=(0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0))
        self._m_merge_stall = reg.histogram(
            "favor_merge_stall_seconds",
            "Time a merge commit held the engine lock (the only slice of a "
            "background merge that can stall a step)",
            buckets=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0))
        reg.register_view("batching", self.registry.stats)
        reg.register_view("scorers", self._route_scorers)
        reg.register_view("mutations", self._mutation_view)
        cache_stats = getattr(backend, "cache_stats", None)
        if cache_stats is not None:
            reg.register_view("cache", cache_stats)
        live_stats = getattr(backend, "live_stats", None)
        if live_stats is not None:
            reg.register_view("live", live_stats)
        # resets cascade: obs.reset() zeroes the instruments above, then
        # these hooks clear every legacy counter the registry can't own
        reg.on_reset(self._on_registry_reset)
        cache_reset = getattr(backend, "reset_cache_counters", None)
        if callable(cache_reset):
            reg.on_reset(cache_reset)
        # background incremental merge: a MergeController worker owns the
        # expensive build phase off the serving path; _maybe_merge pokes it
        # instead of merging inline
        self._merge_ctl = None
        if merge_background:
            from .merge import MergeController
            self._merge_ctl = MergeController(self)

    def close(self) -> None:
        """Stop the background merge worker (if any).  Idempotent; the
        engine itself keeps serving after close -- only the worker dies."""
        if self._merge_ctl is not None:
            self._merge_ctl.stop()
            self._merge_ctl = None

    # -- live-index mutation API ---------------------------------------------
    def _mutable(self, op: str):
        fn = getattr(self.backend, op, None)
        if fn is None:
            raise ValueError(
                f"backend {type(self.backend).__name__} does not support "
                f"live mutation ({op}); use a LocalBackend/ShardedBackend "
                f"(optionally cache-wrapped)")
        return fn

    def upsert(self, vectors, ints=None, floats=None, *, replace=None):
        """Stream rows into the backend's live delta; returns their ids."""
        with self._lock:
            ids = self._mutable("upsert")(vectors, ints, floats,
                                          replace=replace)
            self._m_mutations.inc(int(len(ids)), op="upserts")
            return ids

    def delete(self, ids) -> int:
        """Tombstone ids; returns how many were found alive."""
        with self._lock:
            n = int(self._mutable("delete")(ids))
            self._m_mutations.inc(n, op="deletes")
            return n

    def merge(self, *, wave: int = 512) -> dict:
        """Fold the delta into the base index now (manual compaction)."""
        with self._lock:
            out = self._mutable("merge")(wave=wave)
            self._m_mutations.inc(op="merges")
            return out

    def _merge_due(self) -> bool:
        """True once the unmerged delta crosses ``merge_delta_frac`` of the
        base row count (shared trigger for the inline scheduler and the
        background controller)."""
        if self.merge_delta_frac is None:
            return False
        live_stats = getattr(self.backend, "live_stats", None)
        if live_stats is None:
            return False
        st = live_stats()
        return bool(st["delta_rows"] and
                    (st["delta_rows"] >=
                     self.merge_delta_frac * max(st["base_rows"], 1)))

    def _maybe_merge(self) -> None:
        """Between-steps merge scheduling: compact once the delta fraction
        crosses ``merge_delta_frac`` (checked after each served batch, so
        compaction cost never lands inside a request's latency path).  With
        a background controller attached, this only *pokes* the worker --
        the build runs off-thread and commits via an epoch-guarded swap."""
        if self._merge_ctl is not None:
            if self._merge_due():
                self._merge_ctl.poke()
            return
        if self._merge_due():
            self._mutable("merge")()
            self._m_mutations.inc(op="merges")
            self._m_mutations.inc(op="auto_merges")

    def _base_backend(self):
        """The innermost backend (cache decorators unwrapped)."""
        target = self.backend
        inner = getattr(target, "inner", None)
        while inner is not None:
            target, inner = inner, getattr(inner, "inner", None)
        return target

    def _route_scorers(self) -> dict:
        """Which scorer serves each route under this engine's options:
        the graph route per ``opts.graph_quant`` (core.scoring), the brute
        route per ``opts.use_pq`` + the backend's code kind.  ``use_pallas``
        keeps the JAX package's key and reports whether the hand-written
        kernels serve the routes: true on the card, where no option selects
        the plain versions; false on the CPU, where the plain versions
        run."""
        target = self._base_backend()
        kind = getattr(target, "quant", None)
        if kind is None:
            kind = getattr(getattr(target, "index", None), "quantize", None)
        dev = getattr(target, "device", None)
        return {"graph": self.opts.graph_quant or "exact",
                "brute": (kind or "exact") if self.opts.use_pq else "exact",
                "use_pallas": getattr(dev, "type", None) == "cuda"}

    def _mutation_view(self) -> dict:
        """Engine mutation counters + the backend's live-state gauges
        (delta/tombstone occupancy) when it supports streaming mutation."""
        out = {op: int(self._m_mutations.value(op=op))
               for op in ("upserts", "deletes", "merges", "auto_merges")}
        live_stats = getattr(self.backend, "live_stats", None)
        if live_stats is not None:
            out.update(live_stats())
        return out

    @property
    def stats(self) -> dict:
        """Thin view over the one metrics registry (``self.obs.registry``):
        routing counters; ``scorers`` -- which scorer (exact/pq/sq) serves
        each route under the engine's options; ``hops``/``path_td``
        graph-traversal totals (``None`` -- not silently 0 -- when the
        backend does not report them, e.g. the sharded top-k merge);
        ``batching`` compiled-shape and pad-overhead counters; the
        backend's per-layer cache hit/miss/bypass counters when it is
        cache-capable (CachingBackend); ``obs`` -- trace/slow-query ring
        occupancy.  ``obs.snapshot()`` / ``obs.prometheus_text()`` export
        the same registry for machines."""
        reg = self.obs.registry
        out = {"graph": int(self._m_requests.value(route="graph")),
               "brute": int(self._m_requests.value(route="brute")),
               "batches": int(self._m_batches.value())}
        out["scorers"] = reg.view("scorers")
        out["hops"] = (int(self._m_hops.value())
                       if self._diag_known else None)
        out["path_td"] = (int(self._m_path_td.value())
                          if self._diag_known else None)
        out["bytes_per_hop"] = (int(self._m_bytes_hop.value())
                                or None)  # 0 = backend doesn't report it
        n_waves = self._m_waves.count(route="graph")
        out["graph_waves_avg"] = (self._m_waves.sum(route="graph") / n_waves
                                  if n_waves else None)
        out["batching"] = reg.view("batching")
        if reg.has_view("cache"):
            out["cache"] = reg.view("cache")
        out["mutations"] = reg.view("mutations")
        out["obs"] = self.obs.summary()
        return out

    def _on_registry_reset(self) -> None:
        """Legacy-state half of the reset cascade (see reset_stats)."""
        self.latencies.clear()
        self._diag_known = True
        self.registry.reset_rows()

    def reset_stats(self) -> None:
        """Zero every counter in the stack through the registry's reset
        cascade: routing/mutation/latency instruments, diagnostics,
        pad-overhead rows, trace + slow-query rings, cache layer counters,
        and any front-end tenant/coalesce ledgers hooked onto this engine.
        The compiled-shape set survives (it mirrors still-live
        executables), as do cached *entries*; use backend.clear() to drop
        those too."""
        self.obs.reset()

    def warmup(self, buckets=None) -> tuple[int, ...]:
        """Drive every (estimate/graph/brute, bucket) entry point now, so
        first-request traffic never pays a kernel build or a first
        allocation of its bucket's buffers.  Requires
        ``opts.batch`` to be set (raises ValueError otherwise: unpadded
        traffic would never reuse the warmed shapes); routes pinned away by
        ``opts.force`` are skipped.  Returns the warmed ladder."""
        ladder = batching.warmup(self.backend, self.opts, buckets=buckets,
                                 registry=self.registry)
        # warmup batches are 100% pad rows; drop them from the row counters
        # so stats["batching"]["pad_overhead"] reflects live traffic only
        # (the compiled-shape set they created survives)
        self.registry.reset_rows()
        return ladder

    @property
    def k(self) -> int:
        return self.opts.k

    @property
    def ef(self) -> int:
        return self.opts.ef

    def submit(self, query: np.ndarray, flt: "F.Filter",
               scope: int = 0) -> int:
        """Enqueue one request; ``scope`` is the optional tenant/session
        scope id (0 = unscoped) the cache subsystem keys its semantic and
        candidate layers on -- the async front-end sets it per tenant."""
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self.queue.append(Request(rid, np.asarray(query, np.float32),
                                      flt, scope=int(scope),
                                      t_submit=self._time()))
            return rid

    def _assemble(self) -> list[Request]:
        take = min(len(self.queue), self.max_batch)
        batch, self.queue = self.queue[:take], self.queue[take:]
        return batch

    def _due(self) -> bool:
        """A batch is due when it is full or the oldest request has waited
        past the max_wait_ms deadline (latency/throughput trade-off knob)."""
        if not self.queue:
            return False
        if len(self.queue) >= self.max_batch:
            return True
        return self._time() - self.queue[0].t_submit >= self.max_wait_s

    def begin_batch(self, force: bool = False) -> "_InflightStep | None":
        """Host phase of one step: assemble a due batch, run routing +
        bucket padding, *dispatch* the per-route device work, and return
        without copying its results to the host.  The whole phase runs
        under the engine lock; the graph route's traversal waits on the
        device once per wave, so only the brute scans and the result
        copies are still in flight when it returns.  Returns None when no
        batch is due."""
        with self._lock:
            if not self.queue or not (force or self._due()):
                return None
            batch = self._assemble()
            self._m_batches.inc()
            queries = np.stack([r.query for r in batch])
            flts = [r.flt for r in batch]
            scopes = [r.scope for r in batch]
            if self.opts.batch is None:
                # legacy whole-batch repeat-padding to the bucket ladder,
                # as in the JAX package (the post-route sub-batches keep
                # their raw sizes).  With opts.batch set the router
                # bucket-pads every sub-batch itself (mask rows,
                # bit-identical results) so no pre-padding is needed
                b = _bucket(len(batch), self.pad_spec)
                if b > len(batch):
                    queries = np.concatenate(
                        [queries,
                         np.repeat(queries[-1:], b - len(batch), 0)])
                    flts = flts + [flts[-1]] * (b - len(batch))
                    scopes = scopes + [scopes[-1]] * (b - len(batch))
            pending = router.execute(
                self.backend, queries, flts, self.opts,
                registry=self.registry, scopes=scopes,
                obs=self.obs if self.obs.enabled else None, defer=True)
            self._m_inflight.add(1.0)
            return _InflightStep(batch, pending, queries, flts)

    def finish_batch(self, step: "_InflightStep") -> list[Response]:
        """Device phase of one step: wait for the dispatched work (no lock
        held -- other threads keep dispatching/submitting), then do the
        per-request accounting under the lock."""
        try:
            # mutating finish hooks (cache record, obs trace) take the
            # engine lock; the device wait itself runs outside it
            res = step.pending.finish(hook_lock=self._lock)
        finally:
            self._m_inflight.add(-1.0)
            # lets the merge controller tell "between steps" from "no
            # traffic" when pacing its build waves
            self._last_step_end = time.perf_counter()
        batch = step.batch
        with self._lock:
            t_done = self._time()
            if res.hops is None:
                self._diag_known = False
            else:  # slice off legacy whole-batch pad rows, if any
                self._m_hops.inc(int(res.hops[:len(batch)].sum()))
                self._m_path_td.inc(int(res.path_td[:len(batch)].sum()))
            out = []
            for i, r in enumerate(batch):
                route = "brute" if res.routed_brute[i] else "graph"
                self._m_requests.inc(route=route)
                # waves==0 means no traversal ran for this lane (cache
                # hit): keep those out of the traversal-depth histogram
                if (res.waves is not None and route == "graph"
                        and res.waves[i]):
                    self._m_waves.observe(float(res.waves[i]), route=route)
                lat = t_done - r.t_submit
                self.latencies.append(lat)
                self._m_latency.observe(lat)
                out.append(Response(r.rid, res.ids[i], res.dists[i], route,
                                    float(res.p_hat[i]), lat))
            self._m_p_hat.observe_many(res.p_hat[:len(batch)])
            if self.obs.enabled and self.obs.wants_probe:
                self.obs.probe(self.backend, step.queries[:len(batch)],
                               step.flts[:len(batch)], res, self.opts)
            self._maybe_merge()
            return out

    def step(self, force: bool = False) -> list[Response]:
        """Drain one batch if it is due (or ``force``); returns completed
        responses ([] when the engine decided to keep waiting for more
        requests to fill the batch).  Equivalent to ``begin_batch`` +
        ``finish_batch`` back to back; pipelined callers (the front-end's
        executor slots) call the two halves from different threads."""
        step = self.begin_batch(force)
        return [] if step is None else self.finish_batch(step)

    def run(self, until_empty: bool = True) -> list[Response]:
        """until_empty=True serves the whole queue *deadline-aware*: full
        batches flush immediately, but a straggling partial batch waits out
        the remainder of ``max_wait_ms`` (its coalescing window) before it
        is forced -- so a near-future arrival can still join it, instead of
        the pre-1.7 behavior of forcing sub-batches the instant the queue
        was non-empty.  Shutdown paths that must not wait use ``drain()``.
        until_empty=False processes only batches that are already due and
        leaves the rest waiting for the deadline."""
        out = []
        if until_empty:
            while self.queue:
                if not self._due():
                    rem = self.max_wait_s - (self._time()
                                             - self.queue[0].t_submit)
                    if rem > 0:
                        time.sleep(rem)
                out.extend(self.step(force=True))
        else:
            while self._due():
                out.extend(self.step())
        return out

    def drain(self) -> list[Response]:
        """Force every queued request out NOW, ignoring ``max_wait_ms``
        (the front-end shutdown path: nothing new is coming, so waiting out
        straggler deadlines would only add latency)."""
        out = []
        while self.queue:
            out.extend(self.step(force=True))
        return out

    def latency_percentiles(self) -> dict:
        if not self.latencies:
            return {}
        arr = np.asarray(self.latencies) * 1e3
        return {f"p{p}": float(np.percentile(arr, p)) for p in (50, 90, 99)}
