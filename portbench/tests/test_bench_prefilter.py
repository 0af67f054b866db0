"""``brute.prefilter_pct``: the share of the profiled batches' brute
queries that ``filtered_topk`` served filter first, read from the
``prefiltered_queries`` counter of their ``brute``/``search`` spans against
the brute queries of ``ft_calls``; None where there is nothing to read."""
import pytest

from benchcell import ROOT
from portbench import harness

METRICS = ROOT / "portbench" / "metrics"


def _read(ctx):
    return harness.load_reader("brute.prefilter_pct", METRICS).read(ctx)


def _trace(served):
    search = {"name": "search", "duration_ms": 1.0, "children": [],
              "attrs": ({} if served is None else
                        {"prefiltered_queries": served})}
    brute = {"name": "brute", "duration_ms": 1.0, "attrs": {},
             "children": [search]}
    return {"trace_id": 1, "batch": 1000, "duration_ms": 1.0, "attrs": {},
            "spans": [brute]}


def _ctx(served, brute, calls, trace_batches=3):
    rows = [{"queries": 1000, "brute": b, "t_dispatch": float(i),
             "t_finish": float(i) + 1.0, "trace": _trace(s)}
            for i, (s, b) in enumerate(zip(served, brute))]
    return {"batches": rows, "traffic": {"trace_batches": trace_batches},
            "trace": {"ft_calls": calls}}


def test_prefilter_pct_hand_computed():
    """Batches 2..4 are profiled; batch 3 sent no query to the brute route,
    so ``ft_calls`` holds batches 2 and 4: (990 + 400) of (1,000 + 500)
    brute queries served filter first.  The other batches are not read."""
    ctx = _ctx([7, 7, 990, 7, 400, 7], [1000, 1000, 1000, 0, 500, 1000],
               [(1000, 4_000), (500, 2_000)])
    assert _read(ctx) == pytest.approx(100.0 * 1390 / 1500)


@pytest.mark.parametrize("case", ["no_counter", "no_trace", "no_calls",
                                  "pq_calls_only", "calls_misaligned"])
def test_prefilter_pct_reads_nothing(case):
    ctx = _ctx([5, 5, 5, 5, 5], [1000] * 5, [(1000, 100)] * 3)
    if case == "no_counter":        # a program without the counter
        ctx = _ctx([None] * 5, [1000] * 5, [(1000, 100)] * 3)
    elif case == "no_trace":
        ctx["trace"] = None
    elif case == "no_calls":
        ctx["trace"]["ft_calls"] = []
    elif case == "pq_calls_only":   # a compressed route's cell
        ctx["trace"] = {"pq_calls": [(1000, 100)] * 3}
    else:
        ctx["trace"]["ft_calls"] = [(1000, 100)] * 2
    assert _read(ctx) is None


def test_prefilter_pct_is_declared_for_the_f32_brute_cell():
    import json
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"]
            if m["name"] == "brute.prefilter_pct"]
    assert m["workloads"] == ["gist1m-f32.lowsel.b1000"]
    assert (m["layer"], m["source"], m["moves"]) == (
        "kernels", "program_counter", "qps")
