"""The harness end to end on a tiny cell on the CPU: a run is correct, the
control and each planted fault are not, and the dispatch-ahead loop
returns ``FavorIndex.query``'s answers bit for bit."""
import json

import numpy as np
import pytest
import torch

from benchcell import ROOT, tiny
from portbench import data, graph, harness, program


def run(cfg, trf, **kw):
    kw.setdefault("seed", 2**31 + 11)
    kw.setdefault("seconds", 0.5)
    kw.setdefault("trace", False)
    return harness.run_cell(cfg, trf, device="cpu", log=lambda s: None, **kw)


def test_tiny_cell_end_to_end():
    cfg, trf = tiny()
    fields, ctx, numbers = run(cfg, trf)
    assert fields["correct"], numbers
    assert fields["failed"] == 0
    assert fields["attempted"] == len(ctx["batches"]) * trf["batch"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    line = harness.result_line(fields, ctx, bench,
                               "sift1m-f32.paper-graph.b10000", False, 1,
                               torch.device("cpu"), numbers)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == {"bad_ids", "short", "dist_gap",
                                   "exact_gap", "recall_gap"}
    assert line["checks"]["recall_gap"]["value"] == pytest.approx(
        1.0 - ctx["recall"])
    json.dumps(line)


@pytest.mark.parametrize("traffic,pq", [
    pytest.param("paper-graph.b10000", False, id="paper-graph.b10000"),
    pytest.param("lowsel.b1000", False, id="lowsel.b1000"),
    pytest.param("lowsel.b1000", True, id="lowsel.b1000-pq")])
def test_control_is_not_correct(traffic, pq):
    """The reference on TF32 in the program's place fails the check; on a
    configuration whose brute route is compressed (no exact route to hold
    to ``exact_gap``), by ``dist_gap`` all the same."""
    cfg, trf = tiny(traffic=traffic, n=20000, dim=128)
    if pq:
        cfg["quant"] = {"kind": "pq", "m": 32, "nbits": 8, "rerank": 8}
        cfg["search"].update(use_pq=True, graph_quant="pq")
        cfg["limits"]["brute_recall_gap"] = 0.1
    fields, _, numbers = run(cfg, trf, control=4)
    got = dict((n, v) for n, v, _ in numbers)
    assert not fields["correct"]
    assert got["dist_gap"] > cfg["limits"]["dist_gap"]
    assert ("brute_recall_gap" in got) == pq


def _stale(orig):
    last = {}

    def finish(self, pending):
        out = orig(self, pending)
        prev = last.get("out")
        last["out"] = out
        return prev if prev is not None else out
    return finish


def _half(orig):
    def finish(self, pending):
        out = dict(orig(self, pending))
        half = len(out["ids"]) // 2
        out["ids"] = out["ids"].copy()
        out["dists"] = out["dists"].copy()
        out["ids"][half:] = -1
        out["dists"][half:] = np.inf
        return out
    return finish


def _altered(orig):
    def finish(self, pending):
        out = dict(orig(self, pending))
        out["ids"] = out["ids"].copy()
        ok = out["ids"][:, 0] >= 0
        out["ids"][ok, 0] = (out["ids"][ok, 0] + 1) % self.n
        return out
    return finish


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("traffic", ["paper-graph.b10000", "lowsel.b1000"])
def test_planted_faults_are_not_correct(monkeypatch, fault, traffic):
    """A batch answered with the one before's answers, half of each batch
    left unanswered, or one answer altered where it is produced: each
    makes ``correct`` false.  (There is no exchange between chips: every
    cell runs on one card.)"""
    cfg, trf = tiny(traffic=traffic)
    monkeypatch.setattr(program.Runner, "finish",
                        fault(program.Runner.finish))
    fields, ctx, numbers = run(cfg, trf, seconds=3.0)
    assert len(ctx["batches"]) >= 2      # a stale answer needs one before
    assert not fields["correct"], numbers
    assert fields["failed"] > 0


def test_traversal_cut_short_is_not_correct():
    """The traversal cut to one wave returns passing rows at their true
    distances, so only the recall check sees it, and it makes ``correct``
    false."""
    cfg, trf = tiny()
    fields, ctx, numbers = run(cfg, trf, cut_waves=1)
    got = {n: (v, lim) for n, v, lim in numbers}
    assert got["bad_ids"][0] == 0 and got["dist_gap"][0] <= got["dist_gap"][1]
    assert got["recall_gap"][0] > got["recall_gap"][1]
    assert not fields["correct"]


def test_dispatch_ahead_equals_query():
    """The window's loop (dispatch batch i+1, then finish batch i) returns
    each batch's ``FavorIndex.query`` answers bit for bit."""
    cfg, trf = tiny()
    dev = torch.device("cpu")
    base = data.make_base(cfg, 5, dev)
    h = cfg["hnsw"]
    g = graph.build(base["vectors"], M=h["M"], M0=h["M0"], efc=h["efc"],
                    alpha=h["alpha"], gen=data.generator(5, dev, 2))
    fi = program.make_index(cfg, base, g, 5, dev)
    runner = program.Runner(fi, cfg)
    trf["pool"] = 4
    pool_q, specs, _ = harness.make_pool(cfg, trf, base, 5, dev)
    flts = [[program.to_filter(s) for s in b] for b in specs]
    outs = []
    pending = runner.dispatch(pool_q[0], flts[0])
    for i in range(1, 5):
        nxt = runner.dispatch(pool_q[i % 4], flts[i % 4]) if i < 4 else None
        outs.append(runner.finish(pending))
        pending = nxt
    for i, out in enumerate(outs):
        res = runner.query(pool_q[i], flts[i])
        assert np.array_equal(out["ids"], res.ids)
        assert np.array_equal(out["dists"], res.dists)
        assert np.array_equal(out["routed_brute"], res.routed_brute)
