"""Per-request route traces and the slow-query log.

``router.execute`` opens one ``RequestTrace`` per (sampled) batch and wraps
every pipeline stage -- compile/signature, cache lookup, estimate, route
decision, bucket/pad, graph/brute search, cache record -- in a ``span``,
recording wall time plus stage attributes (route, bucket shape, pad
fraction, cache hits).  Spans nest: the pad step inside a route sub-batch is
a child of that route's span, so traces read like the pipeline executes.

The ``Tracer`` keeps the last ``trace_cap`` traces in a ring buffer, feeds
every top-level span into a per-stage latency histogram on the registry, and
-- when a traced batch's wall time crosses ``slow_ms`` -- logs one
``SlowQuery`` entry per request (canonical filter signature, estimated
selectivity, route, ef, per-stage timings) into a second ring.  Sampling is
deterministic 1-in-N on the batch counter, so two runs over the same
workload trace the same batches.

The port's copy of the JAX package's ``repro.obs.trace`` (pure Python);
``tests/test_torch_obs.py`` holds the two to the same behaviour.  The port
adds:

 * under ``ObsSpec.kernel_annotations`` each span is also a
   ``torch.profiler.record_function`` range named ``favor/<span path>``
   (``favor/graph/search``), opened and closed at the span's instants, so
   a device trace puts every idle gap under the stage the host was in;
 * ``host_wait`` / ``RequestTrace.wait`` time a host wait on the device
   (a ``.cpu()`` read, an upload, a wave's sync) into a span or trace
   attribute with ``time.perf_counter`` -- never the injected clock, so
   fake-clock span trees keep their durations -- inside a range of its own;
 * ``open_span()`` hands code below the router (the graph traversal) the
   innermost open span of a sampled trace through a context variable, so
   it can add its counters without a new parameter; a device scalar left
   as an attribute is read to a number when the trace finishes, after the
   batch's outputs were copied;
 * ``finished`` keeps the process's last finished traces across tracers,
   for a reader that outlives the engine that made them (a benchmark's
   metric, a dump at exit).
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from dataclasses import dataclass, field

#: The last traces any ``Tracer`` of the process finished, oldest first.
finished: deque = deque(maxlen=4096)

# (trace, span): the innermost span open in this context, of a sampled trace
_OPEN: ContextVar = ContextVar("favor_open_span", default=None)


def open_span():
    """(RequestTrace, Span) of the innermost span open in this context, or
    None when no sampled trace has one open."""
    return _OPEN.get()


def host_wait(key: str, name: str):
    """Time a host wait on the device into the open span's ``key`` (ms,
    summed over calls) inside range ``name``; a no-op without an open
    span."""
    cur = _OPEN.get()
    if cur is None:
        return nullcontext()
    tr, sp = cur
    return tr.wait(key, name, sp.attrs)


def sample_period(fraction: float) -> int:
    """1-in-N period for a [0,1] sampling fraction (0 disables)."""
    if fraction <= 0.0:
        return 0
    return max(1, int(round(1.0 / fraction)))


@dataclass
class Span:
    name: str
    t0: float
    t1: float | None = None
    attrs: dict = field(default_factory=dict)
    children: list = field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return (self.t1 or self.t0) - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "duration_ms": self.duration_s * 1e3,
                "attrs": dict(self.attrs),
                "children": [c.to_dict() for c in self.children]}


class RequestTrace:
    """Span tree for one engine batch through ``router.execute``."""

    def __init__(self, trace_id: int, batch: int, time_fn, *,
                 annotate: bool = False):
        self.trace_id = trace_id
        self.batch = batch
        self._time = time_fn
        self._annotate = annotate
        self.t0 = time_fn()
        self.t1: float | None = None
        self.spans: list[Span] = []
        self.attrs: dict = {}
        self._stack: list[Span] = []

    @contextmanager
    def span(self, name: str, **attrs):
        sp = Span(name, self._time(), attrs=attrs)
        (self._stack[-1].children if self._stack else self.spans).append(sp)
        self._stack.append(sp)
        token = _OPEN.set((self, sp))
        rng = (self.range("favor/" + "/".join(s.name for s in self._stack))
               if self._annotate else nullcontext())
        try:
            with rng:
                yield sp
        finally:
            _OPEN.reset(token)
            sp.t1 = self._time()
            self._stack.pop()

    def range(self, name: str):
        """A ``torch.profiler.record_function`` range named ``name`` when
        the trace annotates, else a ``nullcontext``."""
        if not self._annotate:
            return nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    @contextmanager
    def wait(self, key: str, name: str, attrs: dict | None = None):
        """Time a host wait on the device into ``attrs[key]`` (the trace's
        own attributes by default; ms, summed) inside range ``name``."""
        attrs = self.attrs if attrs is None else attrs
        t = time.perf_counter()
        try:
            with self.range(name):
                yield
        finally:
            attrs[key] = attrs.get(key, 0.0) + (time.perf_counter() - t) * 1e3

    def finish(self) -> None:
        if self.t1 is None:
            self.t1 = self._time()
            _read_scalars(self.spans)

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else self._time()) - self.t0

    def stage_ms(self) -> dict:
        """Top-level stage name -> wall ms (duplicate names summed)."""
        out: dict[str, float] = {}
        for sp in self.spans:
            out[sp.name] = out.get(sp.name, 0.0) + sp.duration_s * 1e3
        return out

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "batch": self.batch,
                "duration_ms": self.duration_s * 1e3, "attrs": dict(self.attrs),
                "spans": [s.to_dict() for s in self.spans]}


def _read_scalars(spans) -> None:
    """Device scalars left as span attributes -> host numbers."""
    from torch import Tensor
    for sp in spans:
        for k, v in sp.attrs.items():
            if isinstance(v, Tensor):
                sp.attrs[k] = v.item()
        _read_scalars(sp.children)


@dataclass
class SlowQuery:
    """One slow-batch request in the ring: everything an operator needs to
    reproduce it (signature identifies the filter, route+ef the execution)."""
    trace_id: int
    signature: str
    p_hat: float
    route: str
    ef: int
    total_ms: float
    stages_ms: dict

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "signature": self.signature,
                "p_hat": self.p_hat, "route": self.route, "ef": self.ef,
                "total_ms": self.total_ms, "stages_ms": dict(self.stages_ms)}


class Tracer:
    def __init__(self, spec, registry, time_fn=time.perf_counter):
        self.spec = spec
        self._time = time_fn
        self.traces: deque[RequestTrace] = deque(maxlen=spec.trace_cap)
        self.slow_log: deque[SlowQuery] = deque(maxlen=spec.slow_cap)
        self._seq = 0
        self._period = sample_period(spec.trace_sample)
        self._m_traced = registry.counter(
            "favor_traces_total", "Engine batches traced (post-sampling)")
        self._m_slow = registry.counter(
            "favor_slow_queries_total",
            "Requests logged to the slow-query ring")
        self._m_stage = registry.histogram(
            "favor_stage_seconds",
            "Per-stage wall time inside router.execute", labels=("stage",),
            buckets=spec.latency_buckets)

    def start(self, batch: int) -> RequestTrace | None:
        """A RequestTrace for this batch, or None when sampled out."""
        self._seq += 1
        if not self._period or (self._seq - 1) % self._period:
            return None
        return RequestTrace(self._seq, batch, self._time,
                            annotate=self.spec.kernel_annotations)

    def finish(self, tr: RequestTrace, *, p_hat=None, routed_brute=None,
               signatures=None, ef: int = 0) -> None:
        """Close a trace: ring-buffer it, feed the stage histogram, and --
        when the batch crossed slow_ms -- log per-query slow entries.
        ``signatures`` is a zero-arg thunk (the canonical signature is only
        worth computing for slow batches)."""
        tr.finish()
        self.traces.append(tr)
        finished.append(tr)
        self._m_traced.inc()
        for sp in tr.spans:
            self._m_stage.observe(sp.duration_s, stage=sp.name)
        if self.spec.slow_ms is None:
            return
        total_ms = tr.duration_s * 1e3
        if total_ms < self.spec.slow_ms:
            return
        stages = tr.stage_ms()
        sigs = list(signatures()) if callable(signatures) else []
        for i in range(tr.batch):
            route = "unknown"
            if routed_brute is not None and i < len(routed_brute):
                route = "brute" if routed_brute[i] else "graph"
            ph = float(p_hat[i]) if p_hat is not None and i < len(p_hat) \
                else float("nan")
            sig = sigs[i] if i < len(sigs) else ""
            self.slow_log.append(SlowQuery(tr.trace_id, sig, ph, route,
                                           int(ef), total_ms, stages))
            self._m_slow.inc()

    def stats(self) -> dict:
        return {"traced": len(self.traces), "sampled_seq": self._seq,
                "slow": len(self.slow_log),
                "last_trace": (self.traces[-1].to_dict()
                               if self.traces else None)}

    def reset(self) -> None:
        self.traces.clear()
        self.slow_log.clear()
        self._seq = 0
