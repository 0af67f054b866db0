"""Asyncio multi-tenant serving front-end over one ServeEngine.

``FrontEnd.submit`` is the production traffic entry point: every request
gets an asyncio future, a scheduler task drains the per-tenant queues into
``ServeEngine.step()`` batches, and the response resolves the future --
concurrent, bursty, tenant-scoped traffic over the same synchronous engine
a caller can drive directly, with bit-identical results.  The port of the
JAX package's ``repro.serving.frontend``: the same API, policies and stats.

Three serving policies compose here (all pure config, ``FrontEndSpec``):

  * **Cross-step batch coalescing** -- an under-filled batch is held up to
    ``coalesce_ms`` for more arrivals before dispatch, so low arrival rates
    stop paying bucket-pad overhead (every lone request otherwise pads to
    the smallest bucket; the engine's ShapeRegistry ledger measures the
    pad fraction either way).  Held batches release early when they reach
    ``coalesce_target`` rows or when a request's deadline approaches.
  * **Admission control / load shedding** -- per-tenant token buckets
    (rate_qps/burst) and bounded queues shed excess load at the door with
    a structured ``Overloaded`` (reason + retry_after_ms); queued requests
    whose deadline lapses are shed at dispatch time, never served late.
    Shed requests NEVER reach the backend.
  * **Weighted fair dequeue** -- dispatch slots are split across
    backlogged tenants by ``TenantSpec.weight`` (start-time fair queuing),
    so one hot tenant cannot starve the rest; ``fair=False`` degrades to
    global FIFO (the no-QoS baseline).

Tenancy also scopes the cache subsystem: when the engine's backend is a
``CachingBackend``, each tenant name is interned to a scope id and every
request carries it, so semantic/candidate cache entries are per-tenant
(tenant A's hits can never serve tenant B) and per-tenant hit rates land in
``stats["tenants"]``.  Multiple FrontEnds -- each its own spec, tenants and
engine -- can share one backend: isolation is config, not copies.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from ...core.options import FrontEndSpec, TenantSpec
from ..engine import Response, ServeEngine
from .admission import Pending, TenantState, TokenBucket, WeightedFairScheduler


@dataclass
class Overloaded(Exception):
    """Structured load-shed response: the request never reached the backend.

    ``reason`` is one of "rate_limit" (token bucket empty), "queue_full"
    (tenant queue at queue_cap), "deadline" (still queued past its
    deadline), or "closed" (front-end shut down).  ``retry_after_ms`` is
    populated for rate-limit sheds (when the bucket will hold a token).
    """
    tenant: str
    reason: str
    retry_after_ms: float | None = None

    def __str__(self):
        retry = (f", retry_after_ms={self.retry_after_ms:.1f}"
                 if self.retry_after_ms is not None else "")
        return f"Overloaded(tenant={self.tenant!r}, reason={self.reason!r}{retry})"


class FrontEnd:
    """Async multi-tenant entry point over one ServeEngine (see module doc).

    One FrontEnd binds to one asyncio event loop (the one running when the
    first ``submit`` arrives).  The engine runs inside the default executor,
    so arrivals keep accumulating -- and coalescing -- while a batch is on
    the device.
    """

    def __init__(self, engine: ServeEngine, spec: FrontEndSpec | None = None,
                 *, clock=time.monotonic):
        if not isinstance(engine, ServeEngine):
            raise TypeError("FrontEnd wraps a ServeEngine, got "
                            f"{type(engine).__name__} (build one over your "
                            "backend first: ServeEngine(backend, opts))")
        self.engine = engine
        self.spec = spec or FrontEndSpec()
        self._clock = clock
        self._tenants: dict[str, TenantState] = {}
        self._fair = WeightedFairScheduler()
        self._dispatch_cap = self.spec.max_batch or engine.max_batch
        self._target = min(self.spec.coalesce_target or self._dispatch_cap,
                           self._dispatch_cap)
        self._seq = 0
        self._closing = False
        self._task: asyncio.Task | None = None
        self._wake: asyncio.Event | None = None
        self._dispatches = 0
        self._dispatched_rows = 0
        # pipelined step dispatch: up to parallel_steps engine steps ride
        # the executor at once.  Each slot runs the engine's host phase
        # (serialized by the engine lock) then blocks on its own device
        # work -- so slot k+1's routing/cache work overlaps slot k's device
        # wait.  Results resolve strictly in dispatch order (the scheduler
        # only settles the pipeline head).
        self._slots = self.spec.parallel_steps
        self._exec = ThreadPoolExecutor(max_workers=self._slots,
                                        thread_name_prefix="favor-step")
        self._inflight: deque[asyncio.Future] = deque()
        # join the engine's metrics registry: tenant/coalesce ledgers become
        # a view (snapshot + prometheus exposition), and engine.reset_stats()
        # cascades here, so a warm-up's per-tenant counters and dispatch
        # ledger are zeroed without rebuilding the front-end
        reg = engine.obs.registry
        reg.register_view("frontend", self._ledger_view)
        reg.on_reset(self._reset_ledgers)

    # -- tenant bookkeeping ---------------------------------------------------
    def _scope_for(self, name: str) -> int:
        """Tenant name -> cache scope id: interned on the backend when it is
        scope-aware (shared across every front-end over that backend), a
        local intern otherwise (the engine then carries it inertly)."""
        scope_id = getattr(self.engine.backend, "scope_id", None)
        if scope_id is not None:
            return int(scope_id(name))
        return 1 + len(self._tenants)  # called once per new tenant name

    def _tenant(self, name: str) -> TenantState:
        st = self._tenants.get(name)
        if st is None:
            spec = self.spec.tenant(name)
            bucket = (TokenBucket(spec.rate_qps, spec.burst, self._clock)
                      if spec.rate_qps is not None else None)
            st = TenantState(name=name, spec=spec, scope=self._scope_for(name),
                             bucket=bucket)
            st.latencies = deque(maxlen=self.spec.latency_window)
            self._tenants[name] = st
        return st

    def _pending(self) -> int:
        return sum(len(st.queue) for st in self._tenants.values())

    # -- submission -----------------------------------------------------------
    async def submit(self, query, flt, *, tenant: str = "default",
                     deadline_ms: float | None = None) -> Response:
        """Submit one request; resolves to the engine Response (with
        ``latency_s`` rewritten to the end-to-end front-end latency) or
        raises a structured ``Overloaded`` when the request is shed."""
        loop = asyncio.get_running_loop()
        st = self._tenant(tenant)
        st.submitted += 1
        if self._closing:
            st.shed["closed"] += 1
            raise Overloaded(tenant, "closed")
        if self.spec.admission:
            if st.bucket is not None and not st.bucket.try_take():
                st.shed["rate_limit"] += 1
                raise Overloaded(tenant, "rate_limit",
                                 retry_after_ms=st.bucket.retry_after_s() * 1e3)
            if len(st.queue) >= st.spec.queue_cap:
                st.shed["queue_full"] += 1
                raise Overloaded(tenant, "queue_full")
        now = self._clock()
        if deadline_ms is None:
            deadline_ms = st.spec.deadline_ms
        deadline = now + deadline_ms / 1e3 if deadline_ms is not None else None
        p = Pending(query=np.asarray(query, np.float32), flt=flt,
                    tenant=tenant, future=loop.create_future(),
                    t_submit=now, deadline=deadline, seq=self._seq)
        self._seq += 1
        if self.spec.fair:
            self._fair.on_enqueue(st)
        st.queue.append(p)
        self._ensure_scheduler(loop)
        self._wake.set()
        return await p.future

    # -- scheduler ------------------------------------------------------------
    def _ensure_scheduler(self, loop) -> None:
        if self._task is None or self._task.done():
            self._wake = asyncio.Event()
            self._task = loop.create_task(self._run())

    def _hold_delay(self) -> float:
        """Seconds to keep coalescing before dispatch (0.0 = dispatch now):
        a batch goes out when it reaches the coalesce target, when its
        oldest request has waited out the window, when a deadline is about
        to lapse, or immediately during shutdown drain."""
        if self._closing or self.spec.coalesce_ms <= 0.0:
            return 0.0
        if self._pending() >= self._target:
            return 0.0
        now = self._clock()
        oldest = min(st.queue[0].t_submit
                     for st in self._tenants.values() if st.queue)
        delay = self.spec.coalesce_ms / 1e3 - (now - oldest)
        for st in self._tenants.values():
            for p in st.queue:
                if p.deadline is not None:
                    delay = min(delay, p.deadline - now)
        return max(delay, 0.0)

    def _dequeue(self) -> list[Pending]:
        """Pull up to one dispatch of requests: weighted-fair across
        backlogged tenants (or global FIFO), shedding any whose deadline
        already lapsed -- those resolve with Overloaded and are never
        submitted to the engine."""
        batch: list[Pending] = []
        now = self._clock()
        while len(batch) < self._dispatch_cap:
            if self.spec.fair:
                st = self._fair.pick(self._tenants.values())
            else:
                st = min((s for s in self._tenants.values() if s.queue),
                         key=lambda s: s.queue[0].seq, default=None)
            if st is None:
                break
            p = st.queue.popleft()
            if self.spec.fair:
                self._fair.on_dequeue(st)
            if p.deadline is not None and now > p.deadline:
                st.shed["deadline"] += 1
                if not p.future.done():
                    p.future.set_exception(Overloaded(st.name, "deadline"))
                continue
            batch.append(p)
        return batch

    def _serve(self, batch: list[Pending]):
        """Runs in an executor slot: submit + host-phase dispatch under the
        engine lock (atomic, so a concurrent slot can never steal this
        batch's rows), then block on the device work with no lock held.
        Returns (pending, engine Response) pairs."""
        eng = self.engine
        with eng._lock:
            by_rid = {}
            for p in batch:
                rid = eng.submit(p.query, p.flt,
                                 scope=self._tenants[p.tenant].scope)
                by_rid[rid] = p
            steps = []
            while True:
                s = eng.begin_batch(force=True)
                if s is None:
                    break
                steps.append(s)
        out = []
        for s in steps:
            out.extend(eng.finish_batch(s))
        return [(by_rid[r.rid], r) for r in out if r.rid in by_rid]

    def _settle(self, pairs) -> None:
        """Resolve one completed step's futures (loop thread only)."""
        now = self._clock()
        for p, r in pairs:
            st = self._tenants[p.tenant]
            st.served += 1
            lat = now - p.t_submit
            st.latencies.append(lat)
            if not p.future.done():
                p.future.set_result(Response(
                    r.rid, r.ids, r.dists, r.route, r.p_hat, lat))

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            # settle whatever finished at the head of the pipeline first
            # (strictly in dispatch order: only the head is ever popped)
            while self._inflight and self._inflight[0].done():
                self._settle(self._inflight.popleft().result())
            if self._inflight and len(self._inflight) >= self._slots:
                # every slot busy: wait for the oldest step, keep order
                self._settle(await self._inflight.popleft())
                continue
            if not self._pending():
                if self._closing:
                    if self._inflight:
                        # drain: join outstanding device phases before the
                        # scheduler exits -- a dispatched request always
                        # resolves with its real result, never a cancel
                        self._settle(await self._inflight.popleft())
                        continue
                    return
                self._wake.clear()
                if (not self._pending() and not self._closing
                        and not (self._inflight
                                 and self._inflight[0].done())):
                    await self._wake.wait()
                continue
            delay = self._hold_delay()
            if delay > 0.0:
                # hold for more arrivals; a new submit may hit the target
                # and wake us early, otherwise the window lapses
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=delay)
                except asyncio.TimeoutError:
                    pass
                continue
            batch = self._dequeue()
            if not batch:
                continue
            self._dispatches += 1
            self._dispatched_rows += len(batch)
            fut = loop.run_in_executor(self._exec, self._serve, batch)
            # completion must wake the scheduler even when no new submits
            # arrive (callback runs on the loop thread)
            fut.add_done_callback(lambda _f: self._wake.set())
            self._inflight.append(fut)

    # -- shutdown -------------------------------------------------------------
    async def close(self, *, drain: bool = True) -> None:
        """Stop the front-end.  ``drain=True`` serves everything already
        queued (coalescing windows collapse -- shutdown never waits on a
        hold), then stops; ``drain=False`` cancels every still-queued
        future instead (clean cancellation: callers see CancelledError,
        the backend never sees the requests).  New submits raise
        ``Overloaded(reason="closed")`` either way.

        Either way, steps already *dispatched* to an executor slot are
        joined -- the scheduler drains the whole pipeline before exiting,
        so a dispatched request always resolves with its real result;
        cancellation only ever reaches requests still sitting in a tenant
        queue, and a post-close ``submit`` sheds at the door without racing
        any in-flight step."""
        self._closing = True
        if not drain:
            # cancel only still-queued requests: in-flight executor work is
            # past the point of no return and resolves normally below
            for st in self._tenants.values():
                while st.queue:
                    p = st.queue.popleft()
                    if not p.future.done():
                        p.future.cancel()
        if self._task is not None and not self._task.done():
            self._wake.set()
            await self._task
        self._task = None
        # scheduler exit already joined every in-flight step; this just
        # reaps the worker threads
        self._exec.shutdown(wait=True)

    # -- accounting -----------------------------------------------------------
    def _ledger_view(self) -> dict:
        """Tenant + coalesce ledgers as one nested dict: the front-end's
        view on the engine's metrics registry (joins every registry
        snapshot and Prometheus scrape)."""
        sem_scope, cand_scope = {}, {}
        cache_stats = getattr(self.engine.backend, "cache_stats", None)
        if cache_stats is not None:
            cs = cache_stats()
            sem_scope = cs["semantic"].get("by_scope", {})
            cand_scope = cs["candidates"].get("by_scope", {})
        tenants = {}
        for name, st in self._tenants.items():
            d = {"scope": st.scope, "submitted": st.submitted,
                 "served": st.served, "shed": dict(st.shed),
                 "shed_total": sum(st.shed.values()),
                 "queued": len(st.queue)}
            if st.latencies:
                arr = np.asarray(st.latencies) * 1e3
                d["p50_ms"] = float(np.percentile(arr, 50))
                d["p99_ms"] = float(np.percentile(arr, 99))
            if st.scope in sem_scope:
                d["semantic"] = sem_scope[st.scope]
            if st.scope in cand_scope:
                d["candidates"] = cand_scope[st.scope]
            tenants[name] = d
        return {
            "tenants": tenants,
            "coalesce": {
                "dispatches": self._dispatches,
                "rows": self._dispatched_rows,
                "mean_batch": (self._dispatched_rows / self._dispatches
                               if self._dispatches else 0.0),
                "slots": self._slots,
                "inflight": len(self._inflight),
            },
        }

    def _reset_ledgers(self) -> None:
        """engine.reset_stats() cascade target: zero the per-tenant
        submitted/served/shed counters, latency windows and the coalesce
        dispatch ledger (tenant identities, scopes and queued requests
        survive -- only the accounting resets)."""
        self._dispatches = 0
        self._dispatched_rows = 0
        for st in self._tenants.values():
            st.submitted = 0
            st.served = 0
            for k in st.shed:
                st.shed[k] = 0
            st.latencies.clear()

    def reset_stats(self) -> None:
        """Zero the whole stack's counters (cascades through the engine's
        registry: engine + cache + obs + this front-end's ledgers)."""
        self.engine.reset_stats()

    @property
    def stats(self) -> dict:
        """``tenants`` -- per-tenant submitted/served/shed counters, queue
        depth, end-to-end p50/p99 and (under a CachingBackend) per-tenant
        semantic/candidate hit rates; ``coalesce`` -- dispatch count and
        mean coalesced batch size; ``engine`` -- the engine's own stats
        (routing, batching/pad ledger, cache layers, mutations)."""
        out = self._ledger_view()
        out["engine"] = self.engine.stats
        return out
