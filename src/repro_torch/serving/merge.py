"""Background incremental merge: the delta-fold build phase off the serving
path.

The inline scheduler (``ServeEngine._maybe_merge``) compacts the live delta
*between* steps -- correct, but the whole bulk build (seconds at scale)
lands on the serving thread and every queued request waits it out.  The
controller moves the expensive phase to a worker:

    poke -> snapshot delta under component epochs -> device-parallel bulk
    build (merge_prepare; no engine lock held) -> epoch-guarded atomic swap
    (merge_commit; engine lock held only for the pointer swap)

``merge_prepare`` reads a point-in-time snapshot of the delta (slot count
captured before any array ref; appends past it are invisible, and the base
graph is immutable between commits) and records the graph epoch it built
against.  ``merge_commit`` re-checks that epoch under the engine lock: if a
foreground rebuild moved the graph meanwhile, the prepared merge is stale
and is thrown away (the worker just retries).  Deletes that landed *during*
the build are not lost -- commit re-reads the delta's alive mask at swap
time, and rows upserted during the build are carried into the fresh delta
with their ids intact (positional-id discipline: old id = old_base + slot =
new_base + carried_slot).

The only slice of a background merge that can stall a ``step()`` is the
commit swap itself -- host pointer swaps plus the tombstone mask's upload --
which ``favor_merge_stall_seconds`` measures.  Everything else overlaps
serving.

The port of the JAX package's ``repro.serving.merge``.  The worker runs on
the default CUDA stream, as the serving threads do: the build's waves
(``gather_distance`` launches), its uploads and the code re-encode are
queued in one order with the steps' kernels, so a tensor handed from the
worker to the serving threads at commit needs no stream event or
``record_stream``.  The host linking of ``bulk_add`` is Python and shares
the interpreter with the steps.
"""
from __future__ import annotations

import threading
import time


class _Aborted(Exception):
    """Raised inside a build wave when the controller is stopping."""


class MergeController:
    """Worker thread running epoch-guarded background merges for one
    engine.  Started by ``ServeEngine(merge_background=True)``; poked by
    ``_maybe_merge`` when the delta crosses ``merge_delta_frac``, stopped
    by ``engine.close()``.
    """

    def __init__(self, engine, *, wave: int = 512,
                 poll_s: float = 0.05, max_yield_s: float = 0.02,
                 idle_grace_s: float = 0.05, commit_retries: int = 3):
        self.engine = engine
        self.wave = wave
        self.poll_s = poll_s
        # upper bound on how long one build wave defers to foreground
        # steps: prevents a saturated pipeline from starving the build
        self.max_yield_s = max_yield_s
        # no step has *finished* for this long -> the engine is idle (not
        # merely between steps) and waves launch without waiting for one
        self.idle_grace_s = idle_grace_s
        self.commit_retries = commit_retries
        self.merges = 0       # committed background merges
        self.stale = 0        # prepared merges thrown away (epoch moved)
        self._stop = threading.Event()
        self._poke = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="favor-merge", daemon=True)
        self._thread.start()

    # -- lifecycle ----------------------------------------------------------
    def poke(self) -> None:
        """Ask the worker to check the merge trigger now."""
        self._poke.set()

    def stop(self) -> None:
        """Stop and join the worker; an in-flight build aborts at its next
        wave boundary, an in-flight commit completes first."""
        self._stop.set()
        self._poke.set()
        self._thread.join()

    @property
    def active(self) -> bool:
        return self._thread.is_alive()

    # -- worker -------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            self._poke.wait(self.poll_s)
            self._poke.clear()
            if self._stop.is_set():
                return
            try:
                if self.engine._merge_due():
                    self.merge_once()
            except _Aborted:
                return

    def _on_wave(self) -> None:
        """Between-waves pacing point (runs with NO lock held), called
        immediately before each device burst of the build.  Edge-triggered:
        the wave launches right after a foreground step *finishes*
        (busy->idle transition of ``favor_inflight_steps``) so the burst
        lands at the start of the inter-step gap instead of anywhere inside
        it -- on a timeshared host an unpaced burst overlapping a step
        roughly doubles that step's latency.  Two fallbacks keep the build
        moving: an idle engine (no step *finished* within ``idle_grace_s``
        -- a recent finish means we are merely between steps) launches
        immediately, and a saturated pipeline (steps always in flight)
        launches after ``max_yield_s``."""
        deadline = time.perf_counter() + self.max_yield_s
        saw_step = False
        while time.perf_counter() < deadline:
            if self._stop.is_set():
                raise _Aborted()
            if self.engine._m_inflight.value() > 0:
                saw_step = True     # mid-step: wait for its finish
            else:
                if saw_step:        # busy->idle edge: gap starts now
                    return
                # idle right now -- but a *recent* finish means we are in
                # the gap between steps (launching here would overlap the
                # next step), so keep waiting for the next edge
                since = time.perf_counter() - self.engine._last_step_end
                if since >= self.idle_grace_s:
                    return          # no traffic: build at full speed
            time.sleep(2.5e-4)
        if self._stop.is_set():
            raise _Aborted()

    def merge_once(self) -> dict | None:
        """Run one background merge to completion; returns the commit
        summary, or None when there was nothing to merge (or every prepared
        build went stale ``commit_retries`` times -- the next poke retries).
        Falls back to a foreground (lock-held) merge for backends that
        don't implement the prepare/commit split."""
        eng = self.engine
        prepare = getattr(eng.backend, "merge_prepare", None)
        commit = getattr(eng.backend, "merge_commit", None)
        eng._m_merge_active.set(1.0)
        t0 = time.perf_counter()
        try:
            if prepare is None or commit is None:
                with eng._lock:
                    out = eng.backend.merge(wave=self.wave)
            else:
                out = None
                for _ in range(self.commit_retries):
                    prep = prepare(wave=self.wave, on_wave=self._on_wave)
                    if prep is None:
                        return None       # nothing to merge
                    t_swap = time.perf_counter()
                    with eng._lock:
                        out = commit(prep)
                    if out is not None:
                        eng._m_merge_stall.observe(
                            time.perf_counter() - t_swap)
                        break
                    self.stale += 1       # epoch moved under us: rebuild
                if out is None:
                    return None
            self.merges += 1
            eng._m_mutations.inc(op="merges")
            eng._m_mutations.inc(op="auto_merges")
            eng._m_merge_s.observe(time.perf_counter() - t0)
            return out
        finally:
            eng._m_merge_active.set(0.0)
