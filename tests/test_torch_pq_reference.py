"""The port's compressed brute route (``SearchOptions.use_pq``: the PQ codes,
the ``pq_adc_topr`` scan and the exact re-rank) against the plain reference
of its semantics, ``portbench/pq_reference.py``, on the CPU: favor-anns'
widths (d 128, PQ m 32 x 8 bits, re-rank 8, k 10) over 4,096 seeded random
rows, the paper's attributes, and the favor-anns cell's filters with a
wider variant whose queries pass more rows than the R = 80 the scan keeps.

Through ``FavorIndex.query`` the codes, the candidate lists and the answers'
ids are identical to the reference's and the distances within 1e-6
relative; the comparison catches each of three planted faults: a subspace
dropped from the ADC sum, the re-rank depth cut to k, and TF32 operands in
the re-rank."""
import copy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import pq_reference as P  # noqa: E402
from portbench import program, reference, traffic  # noqa: E402
from repro_torch.core import (BuildSpec, FavorIndex, HnswParams,  # noqa: E402
                              QuantSpec, SearchOptions)
from repro_torch.core import filters as F  # noqa: E402
from repro_torch.kernels.pq_adc import ops as pq_ops  # noqa: E402
from repro_torch.quant import adc  # noqa: E402

N, D, K, B = 4096, 128, 10, 96
QUANT = QuantSpec(kind="pq", m=32, nbits=8, rerank=8)
R = QUANT.rerank * K
RTOL = 1e-6
TRAFFIC = Path(__file__).parents[1] / "portbench" / "traffic" / "lowsel.b1024.json"


def _specs(rng):
    """B filter specs: half the cell's mix (0.1-0.5 %: 4-20 passing rows
    here), half the same shapes with bands of 20-70 instead of 1-8 (1-7 %:
    up to ~280 rows, so the scan chooses its 80)."""
    cell = traffic.load(TRAFFIC)
    wide = copy.deepcopy(cell)
    for s in wide["mix"]:
        rng_leaf = s["filter"][2]
        rng_leaf[2] = {"uniform": [0, 50]}
        rng_leaf[3] = {"plus": {"uniform": [20, 50]}}
    a, _ = traffic.draw_batch(cell, B // 2, rng)
    b, _ = traffic.draw_batch(wide, B - B // 2, rng)
    return a + b


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(2**31 + 41)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    attrs = F.random_attributes(F.paper_schema(), N, seed=43)
    fi = FavorIndex.build(vecs, attrs, HnswParams(M=4, efc=16, seed=47),
                          BuildSpec(quant=QUANT), device="cpu")
    specs = _specs(rng)
    q = torch.as_tensor(rng.normal(size=(B, D)).astype(np.float32))
    cols = {"b0": torch.as_tensor(attrs.ints[:, 0]),
            "i0": torch.as_tensor(attrs.ints[:, 1]),
            "f0": torch.as_tensor(attrs.floats[:, 0])}
    mask = torch.stack([reference.eval_spec(s, cols) for s in specs])
    x = torch.as_tensor(vecs)
    cents = torch.as_tensor(fi.codebook.centroids)
    codes = P.encode(x, cents)
    return {"fi": fi, "q": q, "x": x, "cents": cents, "codes": codes,
            "mask": mask, "filters": [program.to_filter(s) for s in specs],
            "ref": P.search(x, codes, cents, q, mask, K, R)}


def _port(case, monkeypatch, **opts):
    """The port's answers and the scan's candidate lists for the case's
    queries, through ``FavorIndex.query`` (every query forced to the brute
    route)."""
    scans = []
    scan = pq_ops.pq_adc_topr

    def recorded(*a, **kw):
        scans.append(scan(*a, **kw))
        return scans[-1]
    monkeypatch.setattr(pq_ops, "pq_adc_topr", recorded)
    res = case["fi"].query(case["q"], case["filters"],
                           SearchOptions(k=K, use_pq=True, force="brute",
                                         **opts))
    assert res.routed_brute.all() and len(scans) == 1
    return {"cand_i": scans[0][0], "cand_d": scans[0][1],
            "ids": torch.as_tensor(res.ids),
            "dists": torch.as_tensor(res.dists)}


def _compare(case, got):
    codes = P.compare_codes(case["x"], case["cents"],
                            case["fi"]._codes[:N], case["codes"])
    ans = P.compare_answers(case["x"], case["cents"], case["codes"],
                            case["q"], case["mask"], case["ref"], got, K,
                            tie_rows=codes["tie_rows"], rtol=RTOL)
    return codes, ans


def test_the_case_exercises_the_scan(case):
    """Both halves of the mix are there: lists shorter than R (every
    passing row a candidate) and full ones (the scan chose)."""
    passing = case["mask"].sum(1)
    assert int(passing.min()) >= 1
    assert int((passing <= K).sum()) and int((passing > R).sum()) >= B // 8


def test_port_equals_the_reference(case, monkeypatch):
    codes, ans = _compare(case, _port(case, monkeypatch))
    assert codes["differ"] == 0, codes
    assert ans["cand_differ"] == 0 and ans["ans_differ"] == 0, ans
    assert P.breaches({**codes, **ans}) == 0, ans
    assert ans["ans_max_rel"] <= RTOL


def _drop_subspace(monkeypatch):
    """Subspace M - 1's table entries out of the ADC sum."""
    luts = adc.build_luts

    def faulty(centroids, queries):
        out = luts(centroids, queries).clone()
        out[:, -1, :] = 0.0
        return out
    monkeypatch.setattr(adc, "build_luts", faulty)
    return {}


def _rerank_to_k(monkeypatch):
    return {"rerank": 1}


def _tf32_rerank(monkeypatch):
    """The re-rank on TF32 operands (10 explicit mantissa bits)."""
    rerank = adc._exact_rerank

    def faulty(vectors, norms, queries, cand_i, **kw):
        v = reference.to_tf32(vectors)
        return rerank(v, (v * v).sum(1), reference.to_tf32(queries), cand_i,
                      **kw)
    monkeypatch.setattr(adc, "_exact_rerank", faulty)
    return {}


@pytest.mark.parametrize("fault,caught", [
    (_drop_subspace, "cand_adc"), (_rerank_to_k, "cand_count"),
    (_tf32_rerank, "ans_dist")])
def test_planted_faults_are_caught(case, monkeypatch, fault, caught):
    opts = fault(monkeypatch)
    codes, ans = _compare(case, _port(case, monkeypatch, **opts))
    assert ans[caught] > 0, ans
    assert P.breaches({**codes, **ans}) > 0


def test_reference_semantics_by_brute_force(case):
    """The reference's own steps, for a few queries and rows, against plain
    loops in float64: the nearest code per subspace, the tables, the ADC
    order of the scan and the re-rank's order."""
    x, cents, codes, q = case["x"], case["cents"], case["codes"], case["q"]
    xs = x[:64].double().reshape(64, 32, 4)
    d2 = ((xs[:, :, None, :] - cents.double()[None]) ** 2).sum(-1)
    assert torch.equal(codes[:64].long(), d2.argmin(2))
    luts = P.tables(q[:3], cents)
    want = ((q[:3].double().reshape(3, 32, 1, 4) - cents.double()[None]) ** 2
            ).sum(-1)
    assert torch.allclose(luts.double(), want, rtol=1e-6, atol=1e-6)
    ref = case["ref"]
    for i in range(3):
        rows = torch.nonzero(case["mask"][i]).flatten()
        a = luts[i].double()[torch.arange(32)[None, :], codes[rows].long()]
        order = rows[torch.argsort(a.sum(1), stable=True)][:R]
        got = ref["cand_i"][i][ref["cand_i"][i] >= 0]
        assert set(got.tolist()) == set(order.tolist())
        exact = (x[got].double() - q[i].double()).norm(dim=1)
        assert ref["ids"][i][0] == got[torch.argmin(exact)]
