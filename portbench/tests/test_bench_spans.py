"""The readers of the program's spans and counters (``portbench/spans.py``
and the five ``metrics/`` files that use it) on a tiny traced run on the
CPU: each reads a value where its cell has the work and None where it has
not, reads the same from a batch record's ``trace`` field as from the
port's ring of finished traces, and nothing from a program without the
ring; the readers that were there read the same either way."""
import contextlib
import json

import pytest

from benchcell import ROOT, tiny
from portbench import harness, profile, spans

NEW = ("graph.sync_ms_per_wave", "graph.lane_active_pct",
       "graph.useful_ids_pct", "router.dispatch_wait_ms_per_kq",
       "router.finish_wait_ms_per_kq")
GRAPH_ONLY = NEW[:3]
METRICS = ROOT / "portbench" / "metrics"


def _read(name, ctx):
    return harness.load_reader(name, METRICS).read(ctx)


@contextlib.contextmanager
def _no_profiler(out):
    """``profile.traced`` without the card: the router's spans only."""
    yield


@pytest.fixture(scope="module")
def runs():
    from repro_torch.obs import profiling
    mp = pytest.MonkeyPatch()
    mp.setattr(profile, "traced", _no_profiler)
    out = {}
    try:
        for traffic in ("paper-graph.b10000", "lowsel.b1000"):
            cfg, trf = tiny(traffic=traffic)
            if traffic == "lowsel.b1000":
                # at 3,000 rows a few of these filters estimate above 1 %:
                # route every query to the scan, as the full-size cell does
                cfg["search"]["lam"] = 1.01
            fields, ctx, _ = harness.run_cell(
                cfg, trf, seed=2**31 + 7, seconds=1.0, trace=True,
                device="cpu", log=lambda s: None)
            assert fields["correct"]
            out[traffic] = (ctx, {n: _read(n, ctx) for n in NEW},
                            spans.window_traces(ctx))
    finally:
        mp.undo()
        profiling.set_kernel_annotations(False)
    return out


@pytest.mark.parametrize("traffic", ["paper-graph.b10000", "lowsel.b1000"])
def test_new_readers_read_the_window(runs, traffic):
    ctx, got, traces = runs[traffic]
    assert len(traces) == len(ctx["batches"])
    assert [t["batch"] for t in traces] == [r["queries"]
                                            for r in ctx["batches"]]
    assert got["router.dispatch_wait_ms_per_kq"] >= 0.0
    assert got["router.finish_wait_ms_per_kq"] >= 0.0
    graph = any(r["waves"] for r in ctx["batches"])
    assert graph == (traffic == "paper-graph.b10000")
    for name in GRAPH_ONLY:
        if not graph:
            assert got[name] is None, name
        elif name.endswith("_pct"):
            assert 0.0 < got[name] <= 100.0, name
        else:
            assert got[name] >= 0.0, name
    if graph:
        waves = sum(s["waves"] for s in spans.span_attrs(
            traces, ("graph", "search")))
        assert waves == sum(r["waves"] for r in ctx["batches"])


@pytest.mark.parametrize("traffic", ["paper-graph.b10000", "lowsel.b1000"])
def test_readers_read_the_same_from_a_trace_field(runs, traffic):
    """Every reader of the benchmark reads the same on the recorded run
    with and without each batch record's ``trace`` field; the new readers
    read the field as they read the ring."""
    ctx, got, traces = runs[traffic]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    before = {n: _read(n, ctx) for n in names}
    with_field = dict(ctx, batches=[dict(r, trace=t) for r, t in
                                    zip(ctx["batches"], traces)])
    after = {n: _read(n, with_field) for n in names}
    assert after == before
    assert {n: after[n] for n in NEW} == got


def test_readers_read_nothing_without_the_ring(runs, monkeypatch):
    """On a program without ``obs.trace.finished``, or a window without
    traces, the new readers return None and do not raise."""
    from repro_torch.obs import trace
    ctx = runs["paper-graph.b10000"][0]
    late = dict(ctx, batches=[dict(r, t_dispatch=r["t_finish"] + 1e6)
                              for r in ctx["batches"]])
    assert all(_read(n, late) is None for n in NEW)
    monkeypatch.delattr(trace, "finished")
    assert spans.window_traces(ctx) == []
    assert all(_read(n, ctx) is None for n in NEW)
