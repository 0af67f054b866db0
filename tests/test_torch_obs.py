"""Port parity, observability: ``repro_torch.obs`` and ``ObsSpec`` against
the JAX package's ``repro.obs`` (``tests/test_obs.py``).

The registry and trace modules are copies of the JAX package's: every test
here runs the same instrument operations through both packages and holds
the results equal -- ``snapshot()`` as a dict, ``prometheus_text()`` line
for line, span trees under a fake clock attribute for attribute.  The JAX
package's golden exposition test runs through both.  No tolerance: these
are host-side counters and clocks, equal or not."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ObsSpec as RObsSpec  # noqa: E402
from repro.obs import Obs as RObs  # noqa: E402
from repro.obs import registry as r_registry  # noqa: E402
from repro.obs import trace as r_trace  # noqa: E402
from repro_torch.core.options import ObsSpec  # noqa: E402
from repro_torch.obs import Obs, profiling  # noqa: E402
from repro_torch.obs import registry as p_registry  # noqa: E402
from repro_torch.obs import trace as p_trace  # noqa: E402

REGISTRY = {"jax": r_registry, "torch": p_registry}
TRACE = {"jax": r_trace, "torch": p_trace}


class FakeClock:
    """Monotonic fake: every call advances by ``tick`` seconds."""

    def __init__(self, tick=0.001):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _script(mod):
    """One run of every instrument kind, labels, views and a reset hook
    through a registry of ``mod``; returns (registry, events)."""
    reg = mod.MetricsRegistry()
    events = []
    c = reg.counter("favor_requests_total", "Requests served, by route",
                    labels=("route",))
    c.inc(3, route="graph")
    c.inc(route="brute")
    c.inc(0.25, route="brute")
    g = reg.gauge("favor_inflight_steps", "in flight")
    g.add(2.0)
    g.add(-1.0)
    lg = reg.gauge("favor_delta_rows", "Live delta rows", labels=("shard",))
    lg.set(12, shard="0")
    lg.set(7.5, shard="1")
    h = reg.histogram("favor_latency_seconds", "Latency",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.001, 0.02, 0.5, 3.0):
        h.observe(v)
    h.observe_many(np.linspace(0.0, 2.0, 17))
    lh = reg.histogram("favor_stage_seconds", "Stages", labels=("stage",),
                       buckets=(0.01, 0.1))
    lh.observe(0.05, stage="estimate")
    lh.observe_many([0.001, 0.2], stage="graph")
    reg.register_view("cache", lambda: {"semantic": {"hits": 2, "misses": 1,
                                                     "note": "text"},
                                        "flag": True, "ratio": 0.5})
    reg.register_view("batching", lambda: {"sizes": {"graph": (4, 8)},
                                           "pad_rows": 3})
    reg.on_reset(lambda: events.append("reset"))
    return reg, events


def test_registry_copy_same_snapshot_and_exposition():
    out = {}
    for pkg, mod in REGISTRY.items():
        reg, events = _script(mod)
        before = (json.loads(json.dumps(reg.snapshot())),
                  reg.prometheus_text())
        h = reg.histogram("favor_latency_seconds")
        stats = (h.count(), h.sum(), [h.percentile(p) for p in
                                      (1, 25, 50, 90, 99, 100)],
                 reg.counter("favor_requests_total",
                             labels=("route",)).total(),
                 reg.has_view("cache"), reg.view("batching"))
        reg.reset()
        after = (reg.snapshot(), reg.prometheus_text(), list(events))
        out[pkg] = (before, stats, after)
    assert out["torch"][0][0] == out["jax"][0][0]
    assert (out["torch"][0][1].splitlines()
            == out["jax"][0][1].splitlines())
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]
    assert out["torch"][2][2] == ["reset"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_prometheus_exposition_golden(pkg):
    """The JAX package's golden exposition (tests/test_obs.py), run through
    each package's registry."""
    reg = REGISTRY[pkg].MetricsRegistry()
    c = reg.counter("favor_requests_total", "Requests served, by route",
                    labels=("route",))
    c.inc(3, route="graph")
    c.inc(route="brute")
    reg.gauge("favor_delta_rows", "Live delta rows").set(12)
    h = reg.histogram("favor_latency_seconds", "Latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0):
        h.observe(v)
    reg.register_view("cache", lambda: {"semantic": {"hits": 2, "misses": 1,
                                                     "note": "non-numeric"}})
    assert reg.prometheus_text() == """\
# HELP favor_requests_total Requests served, by route
# TYPE favor_requests_total counter
favor_requests_total{route="brute"} 1
favor_requests_total{route="graph"} 3
# HELP favor_delta_rows Live delta rows
# TYPE favor_delta_rows gauge
favor_delta_rows 12
# HELP favor_latency_seconds Latency
# TYPE favor_latency_seconds histogram
favor_latency_seconds_bucket{le="0.1"} 1
favor_latency_seconds_bucket{le="1"} 2
favor_latency_seconds_bucket{le="+Inf"} 3
favor_latency_seconds_sum 2.55
favor_latency_seconds_count 3
# HELP favor_view Flattened numeric leaves of registered stats views
# TYPE favor_view gauge
favor_view{view="cache",path="semantic.hits"} 2
favor_view{view="cache",path="semantic.misses"} 1
"""


@pytest.mark.parametrize("call,match", [
    (lambda reg: reg.counter("favor_c_total", "c").inc(-1.0),
     "cannot decrease"),
    (lambda reg: reg.counter("favor_l_total", "l", labels=("route",)).inc(
        tenant="a"), "labels"),
    (lambda reg: reg.counter("favor-bad", "x"), "bad metric name"),
    (lambda reg: (reg.counter("favor_d_total", "d"),
                  reg.gauge("favor_d_total")), "already registered"),
    (lambda reg: reg.histogram("favor_h", "h", buckets=(1.0, 1.0)),
     "strictly"),
])
def test_registry_errors_match(call, match):
    msgs = []
    for mod in REGISTRY.values():
        with pytest.raises(ValueError, match=match) as ei:
            call(mod.MetricsRegistry())
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("fraction", [0.0, 1.0, 0.5, 0.1, 0.3, 1e-9])
def test_sample_period_matches(fraction):
    assert (p_trace.sample_period(fraction)
            == r_trace.sample_period(fraction))
    assert p_trace.sample_period(fraction) >= (0 if fraction == 0 else 1)


def _span_tree(mod):
    clock = FakeClock(tick=1.0)
    tr = mod.RequestTrace(1, batch=4, time_fn=clock)
    with tr.span("outer", rows=4):
        with tr.span("inner"):
            pass
        with tr.span("inner2", bucket=8) as sp:
            sp.attrs["pad_frac"] = 0.5
    with tr.span("outer"):
        pass
    tr.finish()
    return tr


def test_span_nesting_under_fake_clock_matches():
    r, p = _span_tree(r_trace), _span_tree(p_trace)
    assert p.to_dict() == r.to_dict()
    assert p.stage_ms() == r.stage_ms()
    assert [s.name for s in p.spans] == ["outer", "outer"]
    outer = p.spans[0]
    assert [c.name for c in outer.children] == ["inner", "inner2"]
    assert outer.duration_s == pytest.approx(5.0)
    assert p.duration_s == pytest.approx(9.0)
    assert p.stage_ms() == {"outer": pytest.approx(6000.0)}


@pytest.mark.parametrize("slow_ms", [None, 0.0, 1e9])
def test_tracer_slow_log_matches(slow_ms):
    out = {}
    for pkg, (spec_cls, mod, reg_mod) in {
            "jax": (RObsSpec, r_trace, r_registry),
            "torch": (ObsSpec, p_trace, p_registry)}.items():
        spec = spec_cls(trace_sample=0.5, slow_ms=slow_ms, slow_cap=5)
        reg = reg_mod.MetricsRegistry()
        tracer = mod.Tracer(spec, reg, FakeClock(0.002))
        traced = []
        for i in range(5):
            tr = tracer.start(3)
            if tr is None:
                continue
            with tr.span("estimate", rows=3):
                pass
            tracer.finish(tr, p_hat=np.array([0.5, 0.001, 0.2], np.float32),
                          routed_brute=np.array([False, True, False]),
                          signatures=lambda: ["a", "b", "c"], ef=48)
            traced.append(tr.to_dict())
        st = tracer.stats()
        out[pkg] = (traced, st, [s.to_dict() for s in tracer.slow_log],
                    reg.snapshot())
        tracer.reset()
        assert tracer.stats()["traced"] == 0
    assert out["torch"] == out["jax"]
    assert len(out["torch"][0]) == 3          # batches 1, 3 and 5 traced


@pytest.mark.parametrize("kw,match", [
    ({"trace_sample": 1.5}, "trace_sample"),
    ({"probe_sample": -0.1}, "probe_sample"),
    ({"shadow_sample": 2.0}, "shadow_sample"),
    ({"trace_cap": 0}, "trace_cap"),
    ({"slow_cap": 0}, "slow_cap"),
    ({"slow_ms": -1.0}, "slow_ms"),
    ({"latency_buckets": (0.1, 0.1)}, "latency_buckets"),
    ({"latency_buckets": ()}, "latency_buckets"),
])
def test_obsspec_validation_matches(kw, match):
    msgs = []
    for cls in (RObsSpec, ObsSpec):
        with pytest.raises(ValueError, match=match) as ei:
            cls(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_obsspec_fields_and_defaults_match():
    import dataclasses
    r, p = RObsSpec(), ObsSpec()
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert ObsSpec(slow_ms=None).slow_ms is None
    assert ObsSpec().with_(probe_sample=0.5).probe_sample == 0.5
    assert ObsSpec(latency_buckets=[1, 2]).latency_buckets == (1.0, 2.0)
    with pytest.raises(TypeError):
        Obs("not a spec")
    with pytest.raises(TypeError):
        Obs(RObsSpec())        # the other package's spec is not the port's


def test_obs_facade_summary_and_reset_match():
    out = {}
    for pkg, (obs_cls, spec_cls) in {"jax": (RObs, RObsSpec),
                                     "torch": (Obs, ObsSpec)}.items():
        obs = obs_cls(spec_cls(trace_sample=1.0, probe_sample=0.5,
                               shadow_sample=0.25),
                      time_fn=FakeClock())
        tr = obs.start_trace(2)
        with tr.span("compile", rows=2):
            pass
        obs.finish_trace(tr, p_hat=np.zeros(2, np.float32),
                         routed_brute=np.zeros(2, bool), ef=10)
        before = (obs.summary(), obs.wants_probe, obs.snapshot())
        obs.reset()
        out[pkg] = (before, obs.summary(), obs.prometheus_text())
    assert out["torch"] == out["jax"]


def test_annotate_is_gated_record_function():
    from contextlib import nullcontext
    profiling.set_kernel_annotations(False)
    try:
        assert isinstance(profiling.annotate("favor/x"), nullcontext)
        obs = Obs(ObsSpec(kernel_annotations=False))
        assert isinstance(obs.annotate("favor/x"), nullcontext)
        obs = Obs(ObsSpec(kernel_annotations=True))
        assert profiling.kernel_annotations_enabled()
        ctx = obs.annotate("favor/graph/b8")
        assert isinstance(ctx, torch.profiler.record_function)
        # the range shows up in a CPU profiler capture under its name
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with ctx:
                torch.ones(4).sum()
        assert "favor/graph/b8" in {e.key for e in prof.key_averages()}
        # a disabled spec never turns annotations on
        profiling.set_kernel_annotations(False)
        obs = Obs(ObsSpec(enabled=False, kernel_annotations=True))
        assert isinstance(obs.annotate("favor/x"), nullcontext)
    finally:
        profiling.set_kernel_annotations(False)
