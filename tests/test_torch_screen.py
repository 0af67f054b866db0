"""The pieces of the redesigned brute scans that the CPU can check.

* The TF32 screen's margin (``filtered_topk.ops.screen_eps``, the one
  epsilon the CUDA kernel is given): an emulated screen -- operands cut to
  TF32 (low 13 bits masked, as the tensor cores read f32 bits, or rounded
  to nearest), products summed in f32 in shuffled orders, or in blocks of
  eight with truncation -- stays within e(q, v) = eps * |q| * |v| of the
  exact dot and of the kernel's own f32 FMA chain, over vectors with a
  wide dynamic range and heavy cancellation.
* Chaining (``_common.chain_topk``): passes of a short list, each after
  the last pair of the one before, give exactly the one-pass top-k of the
  plain versions, ties and short tails included.
* The lower bound: the plain versions with ``after`` return the entries of
  the Pallas kernels (interpret mode) that follow the bound.
* The port's one stable top-k (``_common.stable_topk``): numpy's stable
  argsort's order, ties, +inf tails and companion columns.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import filters as RF  # noqa: E402
from repro.kernels.filtered_topk import ops as r_ft  # noqa: E402
from repro.kernels.pq_adc import ops as r_pq  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402
from repro_torch.kernels import _common as C  # noqa: E402
from repro_torch.kernels.filtered_topk import ops as p_ft  # noqa: E402
from repro_torch.kernels.pq_adc import ops as p_pq  # noqa: E402
from repro_torch.parity import topk_mismatch  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the margin
# ---------------------------------------------------------------------------
def _tf32(x: np.ndarray, rounding: str) -> np.ndarray:
    """f32 -> TF32 (10 explicit mantissa bits), kept in f32."""
    bits = x.astype(np.float32).view(np.uint32)
    if rounding == "nearest":      # ties away from zero, as cvt.rna
        bits = bits + np.uint32(1 << 12)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _toward_zero_f32(x: np.ndarray) -> np.ndarray:
    """f64 -> f32 rounded toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _pairs(rng, n: int, d: int):
    """n (q, v) pairs: entries spread over six decades, and half the pairs
    with their last coordinate set so the dot nearly cancels."""
    def wide(shape):
        return (rng.standard_normal(shape)
                * 10.0 ** rng.uniform(-3, 3, size=shape)).astype(np.float32)
    q, v = wide((n, d)), wide((n, d))
    half = n // 2
    rest = np.einsum("nd,nd->n", q[:half, :-1].astype(np.float64),
                     v[:half, :-1].astype(np.float64))
    v[:half, -1] = (-rest / q[:half, -1]).astype(np.float32)
    return q, v


@pytest.mark.parametrize("rounding", ["truncate", "nearest"])
@pytest.mark.parametrize("d", [8, 20, 128, 960])
def test_screen_margin_bounds_emulated_tf32_dot(d, rounding):
    rng = np.random.default_rng(d)
    n = 256
    q, v = _pairs(rng, n, d)
    q64, v64 = q.astype(np.float64), v.astype(np.float64)
    exact = np.array([math.fsum(p) for p in q64 * v64])  # correctly rounded
    # the kernel's exact dot: one f32 FMA chain over dims 0..d-1
    chain = np.zeros(n, np.float32)
    for j in range(d):
        chain = (q64[:, j] * v64[:, j] + chain).astype(np.float32)
    e = p_ft.screen_eps(d) * np.linalg.norm(q64, axis=1) * np.linalg.norm(
        v64, axis=1)
    prods = (_tf32(q, rounding).astype(np.float64)
             * _tf32(v, rounding).astype(np.float64))   # exact
    screens = []
    for _ in range(3):                       # f32 sums in shuffled orders
        acc = np.zeros(n, np.float32)
        for j in rng.permutation(d):
            acc = acc + prods[:, j].astype(np.float32)
        screens.append(acc)
    acc = np.zeros(n, np.float32)            # eight-term steps, truncated
    for j0 in range(0, d, 8):
        acc = _toward_zero_f32(acc.astype(np.float64)
                               + prods[:, j0:j0 + 8].sum(axis=1))
    screens.append(acc)
    for a in screens:
        a = a.astype(np.float64)
        assert (np.abs(a - exact) <= e).all()
        assert (np.abs(a - chain.astype(np.float64)) <= e).all()
    # the bound is not vacuous: at d = 128 it is a few parts in a thousand
    assert p_ft.screen_eps(128) < 5e-3


# ---------------------------------------------------------------------------
# chaining and the lower bound
# ---------------------------------------------------------------------------
def _pool(F):
    return [F.Equality("b0", True), F.Inclusion("i0", [1, 5, 9]),
            F.Range("f0", 10.0, 60.0), F.TrueFilter(),
            F.And(F.Equality("i0", 3), F.Range("f0", 10, 12))]


def _case(n, d, b, seed):
    """A DB with repeated rows (tied distances), queries, programs for both
    packages, an exclusion vector, and PQ codes / LUTs with few distinct
    sums (tied ADC distances)."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs[n // 2:] = vecs[: n - n // 2]                  # ties
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    rs, ps = RF.paper_schema(), PF.paper_schema()
    attrs = RF.random_attributes(rs, n, seed=seed + 1)
    flts = [i % 5 for i in range(b)]
    rprog = {k: jnp.asarray(v) for k, v in RF.stack_programs(
        [RF.compile_filter(_pool(RF)[i], rs) for i in flts]).items()}
    pprog = compile_programs([_pool(PF)[i] for i in flts], ps, b,
                             device="cpu")
    m, ksub = 4, 4
    return dict(vecs=vecs, norms=norms, ints=attrs.ints, floats=attrs.floats,
                qs=rng.normal(size=(b, d)).astype(np.float32),
                dvec=rng.uniform(0.1, 1.0, size=b).astype(np.float32),
                codes=rng.integers(0, ksub, size=(n, m)).astype(np.uint8),
                luts=rng.integers(0, 4, size=(b, m, ksub)).astype(np.float32),
                rprog=rprog, pprog=pprog)


def _plain(c, mode, k, after=None):
    t = {key: torch.as_tensor(c[key]) for key in
         ("vecs", "norms", "ints", "floats", "qs", "dvec", "codes", "luts")}
    if mode == "pq":
        return p_pq.pq_adc_topr_plain(t["codes"], t["norms"], t["ints"],
                                      t["floats"], t["luts"], c["pprog"], r=k,
                                      chunk=32, after=after)
    return p_ft.filtered_topk_plain(t["vecs"], t["norms"], t["ints"],
                                    t["floats"], t["qs"], c["pprog"], k=k,
                                    dvec=t["dvec"],
                                    exclude=mode == "exclusion", chunk=32,
                                    after=after)


def _pallas(c, mode, k):
    j = {key: jnp.asarray(c[key]) for key in
         ("vecs", "norms", "ints", "floats", "qs", "dvec", "codes", "luts")}
    if mode == "pq":
        return r_pq.pq_adc_topr(j["codes"], j["norms"], j["ints"],
                                j["floats"], j["luts"], c["rprog"], r=k,
                                block_q=8, block_n=32, interpret=True)
    return r_ft.filtered_topk(j["vecs"], j["norms"], j["ints"], j["floats"],
                              j["qs"], c["rprog"], k=k, block_q=8,
                              block_n=32, dvec=j["dvec"],
                              exclude=mode == "exclusion", interpret=True)


@pytest.mark.parametrize("k", [5, 17, 100])
@pytest.mark.parametrize("mode", ["prefbf", "exclusion", "pq"])
def test_chained_passes_equal_one_pass(mode, k):
    """90 rows, half of them repeats: ties, and a tail shorter than k under
    the selective filters (and under every filter at k = 100)."""
    c = _case(90, 8, 10, seed=3)
    kmax = 8 if mode == "pq" else 4
    calls = []

    def scan(kk, after):
        calls.append(kk)
        return _plain(c, mode, kk, after)

    ids, dists = C.chain_topk(scan, k, kmax)
    want_i, want_d = _plain(c, mode, k)
    assert ids.shape == (10, k) and dists.shape == (10, k)
    assert torch.equal(ids, want_i) and torch.equal(dists, want_d)
    assert max(calls) <= kmax and len(calls) <= -(-k // kmax)
    if k == 100:
        assert (ids[:, 90:] == -1).all() and torch.isinf(dists[:, 90:]).all()


@pytest.mark.parametrize("mode", ["prefbf", "exclusion", "pq"])
def test_lower_bound_matches_pallas_after_it(mode):
    """Each query starts after its own j-th pair (j = q % 5; (inf, -1) past a
    short list): the plain version's next 6 pairs are the Pallas kernel's
    pairs j+1 .. j+6."""
    c = _case(90, 8, 10, seed=7)
    b, kk = 10, 6
    full_i, full_d = _plain(c, mode, 5)
    j = torch.arange(b) % 5
    after = (full_d[torch.arange(b), j].contiguous(),
             full_i[torch.arange(b), j].contiguous())
    got_i, got_d = _plain(c, mode, kk, after=after)
    rid, rd = (np.asarray(a) for a in _pallas(c, mode, 5 + kk))
    want_i = np.stack([rid[q, j[q] + 1:j[q] + 1 + kk] for q in range(b)])
    want_d = np.stack([rd[q, j[q] + 1:j[q] + 1 + kk] for q in range(b)])
    m = topk_mismatch(want_i, want_d, got_i.numpy(), got_d.numpy(), TOL, TOL)
    assert m["dist_mismatch"] == 0 and m["id_mismatch"] == 0, m


def _topk_blocks(case: str):
    """(key blocks (B, n_j) f32, k) of one ``stable_topk`` case."""
    rng = np.random.default_rng(11)
    b = 6
    if case == "ties_across":
        # every key of the second block ties one of the first
        base = rng.integers(0, 4, size=(b, 8)).astype(np.float32)
        return [np.sort(base, axis=1), base[:, ::-1].copy()], 10
    if case == "ties_within":
        return [rng.integers(0, 3, size=(b, 40)).astype(np.float32)], 12
    if case == "inf_tail":
        # fewer finite keys than k; the second block ties the first's
        # front and carries +inf behind it
        a = rng.normal(size=(b, 16)).astype(np.float32)
        a[:, 5:] = np.inf
        c = np.full((b, 8), np.inf, np.float32)
        c[:, 0] = a[:, 0]
        return [a, c], 20
    # short: fewer entries in all than k
    return [rng.normal(size=(b, 3)).astype(np.float32),
            rng.normal(size=(b, 2)).astype(np.float32)], 8


@pytest.mark.parametrize("case", ["ties_across", "ties_within", "inf_tail",
                                  "short"])
def test_stable_topk_matches_numpy_stable_argsort(case):
    """``_common.stable_topk`` against numpy's ``argsort(kind="stable")``
    over the concatenated blocks: an earlier block wins an exact tie, the
    lower column within a block, +inf keys sort last, and bool, int32 and
    int64 companion columns follow the keys (the int columns hold each
    entry's position, so the whole order is checked)."""
    blocks, k = _topk_blocks(case)
    keys = np.concatenate(blocks, axis=1)
    b, n = keys.shape
    pos = np.broadcast_to(np.arange(n), (b, n))
    cols = [pos.astype(np.int64), pos.astype(np.int32),
            np.random.default_rng(3).random((b, n)) < 0.5]
    order = np.argsort(keys, axis=1, kind="stable")[:, :k]
    want = [np.take_along_axis(a, order, axis=1) for a in [keys] + cols]
    cuts = np.cumsum([x.shape[1] for x in blocks])[:-1]

    def split(a):
        parts = [torch.as_tensor(np.ascontiguousarray(p))
                 for p in np.split(a, cuts, axis=1)]
        return parts if len(parts) > 1 else parts[0]
    got = C.stable_topk(split(keys), k, *(split(c) for c in cols))
    assert len(got) == 4
    for g, w, a in zip(got, want, [keys] + cols):
        assert g.dtype == torch.as_tensor(a).dtype
        assert g.shape == (b, min(k, n))
        np.testing.assert_array_equal(g.numpy(), w)
