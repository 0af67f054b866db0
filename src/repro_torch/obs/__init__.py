"""Unified observability layer for the FAVOR serving stack.

One ``Obs`` object per ``ServeEngine`` bundles the four pieces this package
provides behind a single ``ObsSpec`` (``core.options``):

  registry   -- MetricsRegistry: every counter/gauge/histogram plus the
                stats *views* (cache layers, ShapeRegistry ledger, frontend
                tenant ledgers), exported via ``snapshot()`` (JSON) and
                ``prometheus_text()``.  ``ServeEngine.stats`` is a thin
                read through it.
  tracer     -- per-request route traces through ``router.execute`` with a
                slow-query ring (``trace.py``).
  probes     -- estimator-accuracy + route-confusion probes (``probes.py``).
  profiling  -- gated ``torch.profiler.record_function`` dispatch ranges
                (``profiling.py``).

``ObsSpec(enabled=False)`` degrades every per-request hook to a no-op while
keeping the registry live (stats still work); results are bit-identical
either way -- the obs layer observes, it never steers.
"""
from __future__ import annotations

import time
from contextlib import nullcontext

from . import profiling
from .probes import EstimatorProbe, RouteConfusion
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .trace import RequestTrace, SlowQuery, Span, Tracer

__all__ = ["Counter", "EstimatorProbe", "Gauge", "Histogram",
           "MetricsRegistry", "Obs", "RequestTrace", "RouteConfusion",
           "SlowQuery", "Span", "Tracer", "profiling"]


class Obs:
    """Facade owning one registry + tracer + probe set (module docstring).

    ``time_fn`` is the injected monotonic clock shared with the engine, so
    latency/deadline tests drive spans and histograms deterministically.
    """

    def __init__(self, spec=None, *, time_fn=time.perf_counter,
                 registry: MetricsRegistry | None = None):
        # lazy: core.options pulls in the whole core package; obs must stay
        # importable from anywhere (kernels, backends) without a cycle
        from ..core.options import ObsSpec
        if spec is None:
            spec = ObsSpec()
        if not isinstance(spec, ObsSpec):
            raise TypeError(f"Obs takes an ObsSpec, got {type(spec).__name__}")
        self.spec = spec
        self.time_fn = time_fn
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = (Tracer(spec, self.registry, time_fn)
                       if spec.enabled and spec.trace_sample > 0 else None)
        self.estimator_probe = (EstimatorProbe(spec, self.registry)
                                if spec.enabled and spec.probe_sample > 0
                                else None)
        self.route_confusion = (RouteConfusion(spec, self.registry, time_fn)
                                if spec.enabled and spec.shadow_sample > 0
                                else None)
        if spec.enabled and spec.kernel_annotations:
            profiling.set_kernel_annotations(True)
        self._annotate = spec.enabled and spec.kernel_annotations
        self.registry.on_reset(self._reset_components)

    @property
    def enabled(self) -> bool:
        return self.spec.enabled

    # -- tracing --------------------------------------------------------------
    def start_trace(self, batch: int) -> RequestTrace | None:
        if self.tracer is None:
            return None
        return self.tracer.start(batch)

    def finish_trace(self, tr: RequestTrace, **kw) -> None:
        if self.tracer is not None:
            self.tracer.finish(tr, **kw)

    # -- kernel dispatch annotation -------------------------------------------
    def annotate(self, name: str):
        """Host-side profiler range (nullcontext unless the spec enables
        kernel annotations)."""
        if not self._annotate:
            return nullcontext()
        return profiling.annotate(name)

    # -- probes ---------------------------------------------------------------
    @property
    def wants_probe(self) -> bool:
        return (self.estimator_probe is not None
                or self.route_confusion is not None)

    def probe(self, backend, queries, flts, res, opts) -> None:
        """Run whichever sampled probes the spec enabled on this batch."""
        if self.estimator_probe is not None:
            self.estimator_probe.maybe_probe(backend, flts, res)
        if self.route_confusion is not None:
            self.route_confusion.maybe_shadow(backend, queries, flts, res,
                                              opts)

    # -- export ---------------------------------------------------------------
    def summary(self) -> dict:
        """The obs layer's own health corner of ``ServeEngine.stats``."""
        out = {"enabled": self.spec.enabled,
               "trace_sample": self.spec.trace_sample}
        if self.tracer is not None:
            st = self.tracer.stats()
            out["traces"] = st["traced"]
            out["slow_queries"] = st["slow"]
        return out

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()

    def reset(self) -> None:
        """Zero everything: instruments, ring buffers, and every legacy
        counter hooked onto the registry's reset cascade."""
        self.registry.reset()

    def _reset_components(self) -> None:
        for c in (self.tracer, self.estimator_probe, self.route_confusion):
            if c is not None:
                c.reset()
