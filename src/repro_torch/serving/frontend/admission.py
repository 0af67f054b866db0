"""Admission control and fair scheduling primitives for the async front-end.

Host-side policy only -- nothing here touches the device or the engine:

  TokenBucket            -- classic leaky-bucket rate limiter; ``try_take``
                            refills from elapsed wall time and spends one
                            token per admitted request, ``retry_after_s``
                            tells a shed client when one token will exist.
  TenantState            -- one tenant's runtime: its TenantSpec, scope id,
                            bucket, bounded FIFO of pending requests, fair-
                            queue virtual time, and served/shed accounting.
  WeightedFairScheduler  -- start-time weighted fair queuing over the
                            tenant queues: dequeue picks the smallest
                            virtual time, and each dequeue advances that
                            tenant's clock by 1/weight -- so a tenant with
                            weight w receives a w-proportional share of
                            dequeue slots under contention and a hot tenant
                            can delay, but never starve, the others.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from ...core.options import TenantSpec

SHED_REASONS = ("rate_limit", "queue_full", "deadline", "closed")


class TokenBucket:
    """rate_qps tokens/s up to ``burst``; one token per admitted request."""

    def __init__(self, rate_qps: float, burst: int, clock=time.monotonic):
        if not rate_qps > 0.0:
            raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate_qps)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._clock = clock
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        self.tokens = min(self.burst, self.tokens + (now - self._t) * self.rate)
        self._t = now

    def try_take(self) -> bool:
        self._refill()
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_after_s(self) -> float:
        """Seconds until one token exists (0.0 when one already does)."""
        self._refill()
        return max(0.0, (1.0 - self.tokens) / self.rate)


@dataclass
class Pending:
    """One queued request: payload plus its future and timing metadata."""
    query: object
    flt: object
    tenant: str
    future: object              # asyncio.Future resolved by the scheduler
    t_submit: float             # front-end arrival (frontend clock)
    deadline: float | None      # absolute shed deadline, or None
    seq: int                    # global arrival order (FIFO mode)


@dataclass
class TenantState:
    """Runtime state for one tenant under a front-end."""
    name: str
    spec: TenantSpec
    scope: int
    bucket: TokenBucket | None
    queue: deque = field(default_factory=deque)
    vtime: float = 0.0          # weighted-fair virtual finish time
    submitted: int = 0
    served: int = 0
    shed: dict = field(default_factory=lambda: {r: 0 for r in SHED_REASONS})
    latencies: deque = field(default_factory=lambda: deque(maxlen=4096))


class WeightedFairScheduler:
    """Start-time weighted fair queuing across TenantState queues."""

    def __init__(self):
        self._vnow = 0.0

    def on_enqueue(self, st: TenantState) -> None:
        """Call BEFORE appending to ``st.queue``: a tenant going from idle
        to backlogged re-enters at the current virtual time (it must not
        bank credit from its idle period, or a sleeping tenant could burst
        past everyone on wake)."""
        if not st.queue:
            st.vtime = max(st.vtime, self._vnow)

    def pick(self, states) -> TenantState | None:
        """The backlogged tenant with the smallest virtual time."""
        best = None
        for st in states:
            if st.queue and (best is None or st.vtime < best.vtime):
                best = st
        return best

    def on_dequeue(self, st: TenantState) -> None:
        """Advance the picked tenant's clock by one weighted quantum."""
        self._vnow = st.vtime
        st.vtime += 1.0 / st.spec.weight
