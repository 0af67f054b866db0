"""``router.finish_ready_pct``: the share of the window's traces whose
deferred finish found its copies landed (the trace's ``finish_ready``);
None where no trace has the attribute."""
import json

import pytest

from benchcell import ROOT
from portbench import harness

METRICS = ROOT / "portbench" / "metrics"


def _read(ctx):
    return harness.load_reader("router.finish_ready_pct", METRICS).read(ctx)


def _ctx(ready):
    rows = [{"queries": 1000, "brute": 1000, "t_dispatch": float(i),
             "t_finish": float(i) + 1.0,
             "trace": {"trace_id": i, "batch": 1000, "duration_ms": 1.0,
                       "spans": [],
                       "attrs": ({} if r is None else {"finish_ready": r})}}
            for i, r in enumerate(ready)]
    return {"batches": rows}


@pytest.mark.parametrize("ready,pct", [([1, 1, 1, 0], 75.0),
                                       ([1] * 9, 100.0),
                                       ([0, 0], 0.0),
                                       ([1, None, 1, 0], 50.0)])
def test_finish_ready_pct_hand_computed(ready, pct):
    """Every window trace counts; one without the attribute (none should
    be, on a program that has it) counts as not ready."""
    assert _read(_ctx(ready)) == pytest.approx(pct)


@pytest.mark.parametrize("ready", [[None, None], []])
def test_finish_ready_pct_reads_nothing_without_the_attribute(ready):
    """A program without ``finish_ready``, or a window without traces."""
    assert _read(_ctx(ready)) is None


def test_finish_ready_pct_is_declared_for_the_brute_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"]
            if m["name"] == "router.finish_ready_pct"]
    assert m["workloads"] == ["gist1m-f32.lowsel.b1000",
                              "favor-anns-pq.lowsel.b1024"]
    assert (m["unit"], m["better"], m["layer"], m["source"], m["moves"]) == (
        "%", "higher", "router", "program_counter", "qps")
