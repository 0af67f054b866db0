"""A configuration that names the port's compressed formats: its ``quant``
object and ``search`` options reach the program, and the check holds each
route to what its format guarantees.

The tiny cell raises lambda to 20 %, so that the paper's 5-10 % filters go
to the brute route (the ADC scan and its exact re-rank) and the 30-50 %
ones to the graph route on PQ codes: both compressed routes answer in one
run."""
import contextlib
import json
import time
import types

import pytest
import torch

from benchcell import ROOT, tiny
from portbench import data, harness, profile, program
from repro_torch.core.options import BuildSpec, SearchOptions
from repro_torch.core.selector import SelectorConfig
from repro_torch.quant import adc

PQ = {"kind": "pq", "m": 8, "nbits": 8, "rerank": 8}


def pq_cell(use_pq=True, **quant):
    cfg, trf = tiny(quant=dict(PQ, **quant))
    cfg["search"]["lam"] = 0.2
    if use_pq:
        cfg["search"].update(use_pq=True, graph_quant="pq")
        cfg["limits"]["brute_recall_gap"] = 0.1
    return cfg, trf


def run(cfg, trf, **kw):
    return harness.run_cell(cfg, trf, device="cpu", log=lambda s: None,
                            seed=2**31 + 23, seconds=0.5, trace=False, **kw)


def brute_share(ctx):
    b = ctx["batches"]
    return sum(r["brute"] for r in b) / sum(r["queries"] for r in b)


def test_pq_cell_end_to_end(monkeypatch):
    """Both compressed routes answer, and the run is correct."""
    calls, made = [], []
    scan = adc.pq_prefbf_topk
    monkeypatch.setattr(adc, "pq_prefbf_topk",
                        lambda *a, **kw: calls.append(1) or scan(*a, **kw))
    make = program.make_index
    monkeypatch.setattr(program, "make_index",
                        lambda *a: made.append(make(*a)) or made[-1])
    cfg, trf = pq_cell()
    fields, ctx, numbers = run(cfg, trf)
    assert fields["correct"], numbers
    assert made[0].quantize == "pq" and made[0].codebook.m == PQ["m"]
    assert calls and 0 < brute_share(ctx) < 1
    assert [n for n, _, _ in numbers] == ["bad_ids", "short", "dist_gap",
                                          "exact_gap", "brute_recall_gap",
                                          "recall_gap"]
    assert dict((n, v) for n, v, _ in numbers)["exact_gap"] == 0.0


@contextlib.contextmanager
def _device_times(out):
    """``profile.traced`` without the card: every kernel the f32 and the
    compressed readers count, as if each had run."""
    yield
    out["device_s"] = {name: 1e-3 for name in (
        "ft_screen", "merge_splits", "gd_kernel", "pq_screen", "pq_gather")}


@pytest.mark.parametrize("compressed", [False, True])
def test_traced_calls_are_kept_by_format(monkeypatch, compressed):
    """A traced run keeps its brute and graph calls under the keys of the
    kernels that serve them: under ``use_pq`` / ``graph_quant`` the f32
    roofline readers find no calls and read None, not a share of the f32
    kernels' work over the compressed ones' time."""
    from repro_torch.obs import profiling
    monkeypatch.setattr(profile, "traced", _device_times)
    cfg, trf = pq_cell(use_pq=compressed)
    # the traced batch is the window's second, and its calls count once a
    # third is dispatched: the harness's clock closes the window after the
    # warm-up and three batches, however slow the host
    dispatch, real, sent = program.Runner.dispatch, time.perf_counter, []

    def counted(self, *a):
        sent.append(1)
        return dispatch(self, *a)
    monkeypatch.setattr(program.Runner, "dispatch", counted)
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(
        perf_counter=lambda: real() + (1e9 if len(sent) >= 4 else 0.0)))
    try:
        fields, ctx, numbers = harness.run_cell(
            cfg, trf, device="cpu", log=lambda s: None, seed=2**31 + 29,
            seconds=60.0, trace=True)
    finally:
        profiling.set_kernel_annotations(False)
    assert fields["correct"], numbers
    tr = ctx["trace"]
    f32, pq = ("ft_calls", "gd_calls"), ("pq_calls", "pq_gd_calls")
    assert all(tr[key] for key in (pq if compressed else f32))
    assert not any(key in tr for key in (f32 if compressed else pq))
    metrics = ROOT / "portbench" / "metrics"
    for name in ("filtered_topk_roofline", "gather_distance_roofline"):
        got = harness.load_reader(name, metrics).read(ctx)
        assert (got is None) == compressed, (name, got)


def _forced_pq(monkeypatch):
    opts = program.search_options
    monkeypatch.setattr(program, "search_options",
                        lambda cfg, max_steps=0: opts(cfg, max_steps).with_(
                            use_pq=True))


def _adc_distances(monkeypatch):
    """The brute route returns its candidates' ADC distances, in their
    order, in place of the re-rank's f32 ones."""
    scan = adc.pq_prefbf_topk

    def faulty(codes, pn, pi, pf, queries, programs, centroids, pv, **kw):
        ids, _ = scan(codes, pn, pi, pf, queries, programs, centroids, pv,
                      **kw)
        m, _, dsub = centroids.shape
        lut = ((queries.view(-1, m, 1, dsub) - centroids[None]) ** 2).sum(-1)
        code = codes[ids.clamp(min=0)].long().transpose(1, 2)   # (B, m, k)
        d = lut.gather(2, code).sum(1).sqrt()
        d = torch.where(ids >= 0, d, float("inf"))
        d, order = d.sort(1)
        return ids.gather(1, order), d
    monkeypatch.setattr(adc, "pq_prefbf_topk", faulty)


def _other_rows(monkeypatch):
    """The brute route returns the passing rows ranked after its top k
    (as many as there are, up to k), at their f32 distances, ascending."""
    scan = adc.pq_prefbf_topk

    def faulty(*a, k, **kw):
        ids, d = scan(*a, k=2 * k, **kw)
        start = ((ids >= 0).sum(1) - k).clamp(min=0, max=k)
        pos = start[:, None] + torch.arange(k, device=ids.device)
        return ids.gather(1, pos), d.gather(1, pos)
    monkeypatch.setattr(adc, "pq_prefbf_topk", faulty)


@pytest.mark.parametrize("fault,use_pq,caught", [
    (_forced_pq, False, "exact_gap"),
    (_adc_distances, True, "dist_gap"),
    (_other_rows, True, "brute_recall_gap")])
def test_pq_faults_are_not_correct(monkeypatch, fault, use_pq, caught):
    """The compressed scan where the configuration states the exact one,
    ADC distances returned for the re-rank's, and passing rows other than
    the nearest: each makes ``correct`` false, by its own number.  The
    last one passes ``recall_gap``, a mean over both routes."""
    # at 3,000 rows the ADC top 8 x k always holds the exact top k, so
    # the forced scan is re-ranked from its top k alone: else its answers
    # would be exact, and there would be no fault to see
    cfg, trf = pq_cell(use_pq=use_pq, rerank=0 if not use_pq else 8)
    fault(monkeypatch)
    fields, ctx, numbers = run(cfg, trf)
    got = {n: (v, lim) for n, v, lim in numbers}
    assert 0 < brute_share(ctx) < 1
    assert got[caught][0] > got[caught][1], numbers
    assert not fields["correct"]
    if caught == "brute_recall_gap":
        assert got["recall_gap"][0] <= got["recall_gap"][1]
        assert got["bad_ids"][0] == 0 and got["short"][0] == 0


def _set(path, value):
    def edit(cfg):
        group, key = path.split(".")
        if value is None:
            del cfg[group][key]
        else:
            cfg.setdefault(group, {})[key] = value
    return edit


BAD = {
    "use_pq without brute_recall_gap": _set("limits.brute_recall_gap", None),
    "unknown search key": _set("search.use_qp", True),
    "unknown quant key": _set("quant.nbit", 8),
    "a second source of the re-rank depth": _set("search.rerank", 1),
    "unknown limit key": _set("limits.recal_gap", 0.5),
    "use_pq without quant": lambda cfg: cfg.pop("quant"),
    "graph_quant of another kind": _set("search.graph_quant", "sq"),
    "a QuantSpec value out of range": _set("quant.nbits", 9),
}


@pytest.mark.parametrize("name", list(BAD))
def test_bad_configuration_is_refused_before_setup(monkeypatch, name):
    cfg, trf = pq_cell()
    BAD[name](cfg)

    def no_setup(*a, **kw):
        raise AssertionError("set-up began")
    monkeypatch.setattr(data, "make_base", no_setup)
    with pytest.raises(ValueError):
        run(cfg, trf)


def test_find_cell_refuses_a_bad_configuration(tmp_path):
    cfg, trf = pq_cell()
    cfg["search"]["use_qp"] = cfg["search"].pop("use_pq")
    cfg["name"] = "tiny-pq"
    for sub, name, body in (("configs", "tiny-pq", cfg),
                            ("traffic", "mix", trf)):
        (tmp_path / "portbench" / sub).mkdir(parents=True)
        (tmp_path / "portbench" / sub / f"{name}.json").write_text(
            json.dumps(body))
    bench = {"configs": [{"name": "tiny-pq",
                          "file": "portbench/configs/tiny-pq.json"}],
             "workloads": [{"name": "tiny-pq.mix", "config": "tiny-pq",
                            "traffic": "mix", "chips": 1}]}
    with pytest.raises(ValueError, match="use_qp"):
        harness.find_cell(bench, "tiny-pq.mix", tmp_path)
    cfg["search"]["use_pq"] = cfg["search"].pop("use_qp")
    (tmp_path / "portbench" / "configs" / "tiny-pq.json").write_text(
        json.dumps(cfg))
    assert harness.find_cell(bench, "tiny-pq.mix", tmp_path)[1] == cfg


@pytest.mark.parametrize("config", ["sift1m-f32", "gist1m-f32"])
def test_repository_configs_get_the_parents_options(monkeypatch, config):
    """Without ``quant`` and the compressed options, the program receives
    the ``BuildSpec`` and ``SearchOptions`` it received before they
    existed."""
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{config}.json").read_text())
    harness.check_config(cfg)
    got = {}
    monkeypatch.setattr(program, "from_reference_arrays",
                        lambda **kw: got.update(kw))
    zeros = torch.zeros((2, 1))
    program.make_index(cfg, {"vectors": zeros, "ints": zeros.int(),
                             "floats": zeros},
                       {"levels": [], "node_level": None, "entry_point": -1,
                        "max_level": -1, "delta_d": 0.0}, 7, "cpu")
    s = cfg["search"]
    assert got["spec"] == BuildSpec(selector=SelectorConfig(lam=s["lam"]))
    assert got["spec"].quant is None
    fi = types.SimpleNamespace(index=types.SimpleNamespace(n=2))
    for steps in (0, 16):
        runner = program.Runner(fi, cfg, max_steps=steps)
        assert runner.opts == SearchOptions(k=s["k"], ef=s["ef"],
                                            max_steps=steps)
