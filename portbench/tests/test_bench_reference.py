"""The plain reference against a numpy brute force, its filter evaluation
against a row-by-row reading of the spec, and the TF32 rounding."""
import numpy as np
import torch

from benchcell import tiny
from portbench import data, reference, traffic


def _np_eval(spec, row):
    op = spec[0]
    if op == "and":
        return all(_np_eval(s, row) for s in spec[1:])
    if op == "or":
        return any(_np_eval(s, row) for s in spec[1:])
    if op == "not":
        return not _np_eval(spec[1], row)
    v = row[spec[1]]
    if op == "eq":
        return v == spec[2]
    if op == "in":
        return v in spec[2]
    return spec[2] <= v <= spec[3]


def _cell(traffic_name, n=4000, nq=40):
    cfg, trf = tiny(traffic=traffic_name, n=n)
    dev = torch.device("cpu")
    base = data.make_base(cfg, 21, dev)
    cols = {"b0": base["ints"][:, 0], "i0": base["ints"][:, 1],
            "f0": base["floats"][:, 0]}
    specs, _ = traffic.draw_batch(trf, nq, np.random.default_rng(4))
    q = data.make_queries(cfg, base["centers"], nq, 21, dev)
    return base, cols, specs, q


def test_filter_evaluation_matches_rows():
    base, cols, specs, _ = _cell("paper-graph.b10000", n=500, nq=30)
    mix = specs + [["or", ["not", ["eq", "b0", 1]], ["in", "i0", [2, 5]]]]
    rows = [{"b0": int(base["ints"][i, 0]), "i0": int(base["ints"][i, 1]),
             "f0": float(base["floats"][i, 0])} for i in range(500)]
    for spec in mix:
        got = reference.eval_spec(spec, cols).numpy()
        want = np.array([_np_eval(spec, r) for r in rows])
        assert (got == want).all(), spec


def test_topk_matches_numpy_brute_force():
    for name in ("paper-graph.b10000", "lowsel.b1000"):
        base, cols, specs, q = _cell(name)
        ids, dists, passing = reference.topk(base["vectors"], q, specs,
                                             cols, 10)
        v = base["vectors"].numpy().astype(np.float64)
        qq = q.numpy().astype(np.float64)
        for i, spec in enumerate(specs):
            mask = reference.eval_spec(spec, cols).numpy()
            d = np.sqrt(((v - qq[i]) ** 2).sum(1))
            d[~mask] = np.inf
            order = np.argsort(d, kind="stable")[:10]
            want = np.where(np.isfinite(d[order]), order, -1)
            assert passing[i] == mask.sum()
            got = ids[i].numpy()
            # ids agree wherever the distances are apart
            gap = np.diff(d[order])
            apart = np.concatenate([[True], gap > 1e-4]) & np.concatenate(
                [gap > 1e-4, [True]])
            assert (got[apart] == want[apart]).all()
            fin = np.isfinite(d[order])
            assert np.allclose(dists[i].numpy()[fin], d[order][fin],
                               rtol=1e-5, atol=1e-5)
            assert not np.isfinite(dists[i].numpy()[~fin]).any()


def test_compare_of_the_reference_itself_is_clean():
    base, cols, specs, q = _cell("lowsel.b1000")
    ref = reference.topk(base["vectors"], q, specs, cols, 10)
    out = reference.compare(base["vectors"], q, specs, cols, ref[0], ref[1],
                            torch.ones(len(specs), dtype=torch.bool), 10,
                            ref=ref)
    assert int(out["bad_ids"].sum()) == 0 and int(out["short"].sum()) == 0
    assert float(out["dist_gap"].max()) == 0.0
    assert float(out["exact_gap"].max()) == 0.0
    assert float(out["recall"].min()) == 1.0


def test_to_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12,
                      -3.0 - 2**-9, 1e-20, 0.0])
    got = reference.to_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0,
                         -3.0 - 2**-9, float(np.float32(1e-20)), 0.0])
    low = got.view(torch.int32) & 0x1FFF
    assert int(low.abs().sum()) == 0
    assert torch.equal(got[:5], want[:5])
    assert abs(float(got[5]) - 1e-20) <= 1e-23
