"""Fault tolerance for long runs: preemption-safe training loop, straggler
watchdog, and restart glue -- the JAX package's module, its loop
restoring the checkpoint onto the devices the state lives on.

* ``PreemptionGuard`` converts SIGTERM/SIGINT into a cooperative "save and
  exit" flag checked once per step (the preemption notice pattern).
* ``StragglerWatchdog`` tracks a robust step-time median; steps slower than
  ``threshold``x the median are logged and counted -- at scale this signal
  feeds the scheduler to drain the slow host (here: surfaced in metrics).
* ``run_loop`` wires both to the checkpoint module: restore-latest on start
  (each tensor of the state comes back on its device, an ``OptState`` as
  an ``OptState``), periodic + on-preemption saves, crash-consistent
  resume (the data pipeline state is part of the checkpoint, so resumed
  runs are bitwise continuable).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

import numpy as np

from . import checkpoint as ckpt


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._old = {}
        for s in signals:
            try:
                self._old[s] = signal.signal(s, self._handler)
            except ValueError:  # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore_handlers(self):
        for s, h in self._old.items():
            signal.signal(s, h)


@dataclass
class StragglerWatchdog:
    threshold: float = 2.0
    window: int = 50
    times: list = field(default_factory=list)
    slow_steps: int = 0

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        slow = len(self.times) >= 5 and dt > self.threshold * med
        if slow:
            self.slow_steps += 1
        return slow

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


def run_loop(step_fn, state: dict, data_iter, *, n_steps: int, ckpt_dir: str,
             save_every: int = 100, log_every: int = 10, log=print,
             guard: PreemptionGuard | None = None):
    """Generic fault-tolerant loop.

    state: {"params":..., "opt":..., "data_state":..., "step": int}
    step_fn(state, batch) -> (state, metrics); data_iter(data_state) ->
    (batch, data_state).  Resumes from the latest checkpoint if present.
    """
    guard = guard or PreemptionGuard()
    watchdog = StragglerWatchdog()

    latest = ckpt.latest_step(ckpt_dir)
    if latest is not None:
        tree, meta = ckpt.restore(ckpt_dir, latest,
                                  shardings=ckpt.device_tree(state))
        state = tree
        log(f"[ft] resumed from step {latest}")

    start = int(state["step"])
    metrics = {}
    for i in range(start, n_steps):
        t0 = time.perf_counter()
        batch, state["data_state"] = data_iter(state["data_state"])
        state, metrics = step_fn(state, batch)
        state["step"] = i + 1
        dt = time.perf_counter() - t0
        slow = watchdog.record(dt)
        if slow:
            log(f"[ft] straggler step {i}: {dt:.3f}s vs median {watchdog.median:.3f}s")
        if (i + 1) % log_every == 0:
            loss = metrics.get("loss")
            log(f"step {i + 1}: loss={float(loss):.4f} dt={dt * 1e3:.1f}ms")
        if (i + 1) % save_every == 0 or guard.requested:
            ckpt.save(ckpt_dir, i + 1, state)
        if guard.requested:
            log(f"[ft] preemption requested; saved at step {i + 1}, exiting")
            break
    return state, metrics, watchdog
