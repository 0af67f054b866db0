"""The favor-anns cell (``favor-anns-pq.lowsel.b1024``): its configuration
passes the harness's check and holds favor-anns' widths, its cell is found
by name, and its two readers (``pq_adc_topr_roofline``,
``brute.pq_rescored_pct``) read hand-computed values from synthetic
contexts and None where there is nothing to read."""
import contextlib
import json

import pytest

from benchcell import ROOT, tiny
from portbench import harness, profile, spans

CELL = "favor-anns-pq.lowsel.b1024"
METRICS = ROOT / "portbench" / "metrics"


def _read(name, ctx):
    return harness.load_reader(name, METRICS).read(ctx)


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_cell_is_found_and_its_configuration_checks():
    bench = _bench()
    cell, cfg, trf = harness.find_cell(bench, CELL, ROOT)
    harness.check_config(cfg)
    assert cell["chips"] == 1 and cell["config"] == cfg["name"]
    conf = {c["name"]: c for c in bench["configs"]}[cfg["name"]]
    assert conf["reduced"] == cfg["reduced"] == ["n"]
    assert (cfg["cut"]["n"]["published"], cfg["n"]) == (4_000_000, 2_000_000)
    # favor-anns' widths (repro_torch/configs/favor_anns.py), none cut
    assert (cfg["dim"], cfg["search"]["k"], cfg["search"]["ef"],
            cfg["search"]["width"], cfg["hnsw"]["M"], cfg["hnsw"]["M0"]) == (
                128, 10, 128, 8, 16, 32)
    assert cfg["quant"] == {"kind": "pq", "m": 32, "nbits": 8, "rerank": 8}
    assert cfg["search"]["use_pq"] and trf["batch"] == 1024
    assert {"vectors", "hnsw", "data_seed"} <= set(cfg["assumed"])
    names = [m["name"] for m in harness.metric_entries(bench, CELL, True)]
    assert {"pq_adc_topr_roofline", "brute.pq_rescored_pct"} <= set(names)
    e2e = {m["name"] for m in harness.metric_entries(bench, CELL, False)}
    assert e2e == {"qps", "recall_at_10", "setup_s"}


def _cfg():
    return json.loads((ROOT / "portbench" / "configs"
                       / "favor-anns-pq.json").read_text())


def test_pq_adc_topr_roofline_hand_computed():
    """Two calls over 2M rows: bytes 2e6 x (32 codes + 4 x (norm + 2 ints
    + 1 float)) + b x 32 x 256 x 4 (tables) + b x 224 (programs: W = 8 x
    (4 + 2 x 8 + 2 x 4)) + b x 80 x 8 (the R = 80 list), bytes-bound."""
    by_call = [96_000_000 + b * (32 * 256 * 4 + 224 + 80 * 8)
               for b in (1024, 1000)]
    assert by_call == [130_439_168, 129_632_000]
    bound = sum(by_call) / 3.35e12
    ctx = {"cfg": _cfg(), "trace": {
        "device_s": {"void (anonymous namespace)::pq_screen<4, 32, 256>(...)":
                     0.006, "void favor::merge_splits(...)": 0.0005,
                     "radixSortKVInPlace": 1.0},
        "pq_calls": [(1024, 5_000), (1000, 3_000)]}}
    assert _read("pq_adc_topr_roofline", ctx) == pytest.approx(
        100.0 * bound / 0.0065, rel=1e-12)


@pytest.mark.parametrize("trace", [
    None,
    {"device_s": {"pq_screen": 0.006}, "ft_calls": [(1024, 5_000)]},
    {"device_s": {"ft_screen": 0.006}, "pq_calls": [(1024, 5_000)]},
    {"device_s": {"pq_screen": 0.006}, "pq_calls": []}])
def test_pq_adc_topr_roofline_reads_nothing(trace):
    assert _read("pq_adc_topr_roofline", {"cfg": _cfg(),
                                          "trace": trace}) is None


def _screen_trace(rescored):
    screen = {"name": "screen", "duration_ms": 1.0, "children": [],
              "attrs": ({} if rescored is None else
                        {"screen_pairs": 3 * rescored,
                         "rescored_pairs": rescored})}
    search = {"name": "search", "duration_ms": 1.0, "attrs": {},
              "children": [screen]}
    brute = {"name": "brute", "duration_ms": 1.0, "attrs": {},
             "children": [search]}
    return {"trace_id": 1, "batch": 1024, "duration_ms": 1.0, "attrs": {},
            "spans": [brute]}


def _ctx(rescored, brute, calls, trace_batches=3):
    rows = [{"queries": 1024, "brute": b, "t_dispatch": float(i),
             "t_finish": float(i) + 1.0, "trace": _screen_trace(r)}
            for i, (r, b) in enumerate(zip(rescored, brute))]
    return {"batches": rows, "traffic": {"trace_batches": trace_batches},
            "trace": {"pq_calls": calls}}


def test_pq_rescored_pct_hand_computed():
    """Batches 2..4 are profiled; batch 3 sent no query to the brute route,
    so ``pq_calls`` holds batches 2 and 4: (70 + 50) re-scored of (4,000 +
    2,000) passing pairs = 2 %.  The other batches' counters are not read."""
    ctx = _ctx([900, 900, 70, 900, 50, 900], [1024, 1024, 1024, 0, 1024, 1024],
               [(1024, 4_000), (1024, 2_000)])
    assert spans.window_traces(ctx)[2]["spans"][0]["name"] == "brute"
    assert _read("brute.pq_rescored_pct", ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("case", ["no_counter", "no_trace", "no_calls",
                                  "calls_misaligned", "no_passing"])
def test_pq_rescored_pct_reads_nothing(case):
    ctx = _ctx([5, 5, 5, 5, 5], [1024] * 5, [(1024, 100)] * 3)
    if case == "no_counter":        # a program without the counter
        ctx = _ctx([None] * 5, [1024] * 5, [(1024, 100)] * 3)
    elif case == "no_trace":
        ctx["trace"] = None
    elif case == "no_calls":
        ctx["trace"] = {"ft_calls": [(1024, 100)] * 3}
    elif case == "calls_misaligned":
        ctx["trace"]["pq_calls"] = [(1024, 100)] * 2
    else:
        ctx["trace"]["pq_calls"] = [(1024, 0)] * 3
    assert _read("brute.pq_rescored_pct", ctx) is None


@contextlib.contextmanager
def _device_times(out):
    """``profile.traced`` without the card: the scan's kernels as if each
    had run."""
    yield
    out["device_s"] = {"pq_screen": 1e-3, "merge_splits": 1e-4}


def test_tiny_cell_traces_the_compressed_route(monkeypatch):
    """The cell's configuration and traffic cut to a CPU test's size (and
    lambda raised, so that every query takes the compressed scan): the run
    is correct, every window batch's ``brute``/``search`` span has the
    scan's ``luts``, ``screen`` and ``rerank`` stages, the roofline reads
    the traced calls, and the re-score share reads nothing on the CPU,
    whose plain scan has no screen to count."""
    from repro_torch.obs import profiling
    monkeypatch.setattr(profile, "traced", _device_times)
    cfg, trf = tiny(config="favor-anns-pq", traffic="lowsel.b1024")
    cfg["search"]["lam"] = 1.01
    try:
        fields, ctx, numbers = harness.run_cell(
            cfg, trf, seed=2**31 + 37, seconds=1.0, trace=True,
            device="cpu", log=lambda s: None)
    finally:
        profiling.set_kernel_annotations(False)
    assert fields["correct"], numbers
    assert ctx["trace"]["pq_calls"] and "ft_calls" not in ctx["trace"]
    traces = spans.window_traces(ctx)
    assert len(traces) == len(ctx["batches"])
    for t in traces:
        (brute,) = [s for s in t["spans"] if s["name"] == "brute"]
        (search,) = [c for c in brute["children"] if c["name"] == "search"]
        assert [c["name"] for c in search["children"]] == [
            "luts", "screen", "rerank"]
    assert _read("pq_adc_topr_roofline", ctx) > 0
    assert _read("brute.pq_rescored_pct", ctx) is None
