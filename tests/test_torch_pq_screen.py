"""The 8-bit screen of the ``pq_adc_topr`` kernel, checked on the CPU.

The CUDA kernel (``csrc/pq_adc.cu``, "The screen") quantizes each query's
LUTs to ``screen_levels(M)`` levels above each subspace's minimum, with one
step D per query, and screens a (query, row) pair out when the integer sum
Q of its entries reaches T(tau), the first Q whose lower bound lb(Q) of the
exact key lies above the list's last key tau.  This file emulates that
arithmetic exactly as the kernel does it -- f32 with each rounding directed
down or up, built here from f64 error-free transformations -- and shows:

* every pair of the plain version's top-R passes the screen at the final
  (tightest) threshold, so none is screened out, over random tables, one
  subspace with a range 10^4 times the others', all-equal tables (D = 0),
  entries of 10^5 with ranges of 1 (the exact chain's rounding error
  then exceeds the step D many times over), negative entries, an inf / nan
  entry (that query goes unscreened), bf16 tables, M in {8, 30, 32, 64,
  240} and K in {16, 256};
* a scan that screens tile by tile with the thresholds it has so far, then
  takes the exact keys of the candidates in the kernel's order (filter,
  key, list tail, lower bound), returns the plain version's ids and keys
  bit for bit -- in one pass, in chained passes (``_common.chain_topk``)
  and after a per-query lower bound;
* the screen is not vacuous: on random tables it passes a small share of
  the pairs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402
from repro_torch.kernels import _common as C  # noqa: E402
from repro_torch.kernels.pq_adc import ops as pq  # noqa: E402

F32_INF = np.float32(np.inf)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# f32 arithmetic with directed rounding
# ---------------------------------------------------------------------------
def _two_sum(a, b):
    """a + b = s + e exactly (f64 arrays)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round(hi, lo, up: bool):
    """The exact value hi + lo (|lo| <= ulp(hi) / 2) rounded to f32 down or
    up: the nearest f32 f of hi, stepped once when hi + lo lies on the
    wrong side of it (hi - f is exact; its sum with lo has the sign of
    hi + lo - f)."""
    hi, lo = np.asarray(hi, np.float64), np.asarray(lo, np.float64)
    f = hi.astype(np.float32)
    side = (hi - f.astype(np.float64)) + lo
    if up:
        return np.where(side > 0, np.nextafter(f, F32_INF), f)
    return np.where(side < 0, np.nextafter(f, -F32_INF), f)


def add_dir(a, b, up):
    return _round(*_two_sum(np.float64(a), np.float64(b)), up)


def mul_ru(a, b):
    return _round(np.float64(a) * np.float64(b), 0.0, True)  # exact product


def div_dir(a, b, up):
    """a / b rounded to f32 down or up, for b > 0: f32 products are exact
    in f64, so f * b against a says on which side f lies."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    f = (a.astype(np.float64) / b.astype(np.float64)).astype(np.float32)
    p = f.astype(np.float64) * b.astype(np.float64)
    if up:
        return np.where(p < a, np.nextafter(f, F32_INF), f)
    return np.where(p > a, np.nextafter(f, -F32_INF), f)


# ---------------------------------------------------------------------------
# the kernel's quantizer and threshold, one query at a time
# ---------------------------------------------------------------------------
def quantize(lut: np.ndarray):
    """lut (M, K) f32 -> (codes (M, K) int, lb(Q) for Q in 0..L*M as f32,
    screened): the kernel's prologue for one query."""
    m, _ = lut.shape
    levels = pq.screen_levels(m)
    if not np.isfinite(lut).all():
        return None, None, False
    lo, hi = lut.min(axis=1), lut.max(axis=1)
    rg = np.float32(0.0)
    slo = np.float32(0.0)
    a = np.float32(0.0)
    for j in range(m):
        slo = add_dir(slo, lo[j], up=False)
        rg = max(rg, add_dir(hi[j], -lo[j], up=True))
        a = add_dir(a, max(abs(lo[j]), abs(hi[j])), up=True)
    delta = div_dir(rg, np.float32(levels), up=True) if rg > 0 else \
        np.float32(1.0)
    nu = np.float32((m - 1) * 2.0 ** -24)
    err = mul_ru(div_dir(nu, add_dir(1.0, -nu, up=False), up=True), a)
    if not (np.isfinite(slo) and np.isfinite(delta) and np.isfinite(err)):
        return None, None, False
    t = div_dir(add_dir(lut, -lo[:, None], up=False), delta, up=False)
    codes = np.minimum(np.floor(t), levels).astype(np.int64)
    q = np.arange(levels * m + 1, dtype=np.float64)
    lb = add_dir(_round(*_two_sum(np.float64(delta) * q, np.float64(slo)),
                        up=False), -err, up=False)
    return codes, lb, True


def threshold(lb, screened: bool, tau: float) -> int:
    """T(tau) = 1 + the largest Q with lb(Q) <= tau (0 when none); 32768
    for an unscreened query."""
    if not screened:
        return pq.QSUM_MAX + 1
    ok = np.nonzero(lb <= np.float32(tau))[0]
    return int(ok[-1]) + 1 if ok.size else 0


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------
def _tables(kind, b, m, ksub, rng):
    luts = rng.uniform(0.0, 4.0, size=(b, m, ksub))
    if kind == "wide_subspace":         # one range 10^4 times the others
        luts[:, m // 2] *= 1e4
    elif kind == "flat":                # every entry equal: D = 0
        luts[:] = rng.uniform(0.5, 2.0, size=(b, 1, 1))
    elif kind == "negative":
        luts -= 3.0
    elif kind == "offset":              # f32 chain error >> the step D
        luts = 1e5 + luts * 0.25
    elif kind == "nonfinite":           # query 0 gets +inf, query 1 nan
        luts[0, 1, 3] = np.inf
        luts[1, 0, 0] = np.nan
    return luts.astype(np.float32)


def _case(kind, m, ksub, lut_dtype, n=600, b=6, seed=0):
    rng = np.random.default_rng(seed + m + ksub)
    schema = PF.paper_schema()
    attrs = PF.random_attributes(schema, n, seed=seed + 1)
    norms = np.ones(n, np.float32)
    norms[-20:] = np.inf                # pad rows
    pool = [PF.TrueFilter(), PF.Equality("b0", True),
            PF.Range("f0", 10.0, 60.0), PF.Inclusion("i0", [1, 5, 9])]
    progs = compile_programs([pool[i % len(pool)] for i in range(b)], schema,
                             b, device="cpu")
    codes = rng.integers(0, ksub, size=(n, m)).astype(np.uint8)
    luts = torch.as_tensor(_tables(kind, b, m, ksub, rng)).to(lut_dtype)
    return dict(codes=torch.as_tensor(codes), norms=torch.as_tensor(norms),
                ints=torch.as_tensor(attrs.ints),
                floats=torch.as_tensor(attrs.floats), luts=luts,
                progs=progs)


def _plain(c, r, after=None):
    return pq.pq_adc_topr_plain(c["codes"], c["norms"], c["ints"],
                                c["floats"], c["luts"], c["progs"], r=r,
                                chunk=128, after=after)


def _screen_state(c):
    """Per query: (Q of every row, lb, screened), from the tables as the
    kernel reads them (bf16 widened to f32)."""
    luts = c["luts"].float().numpy()
    codes = c["codes"].numpy().astype(np.int64)
    out = []
    for lut in luts:
        qc, lb, screened = quantize(lut)
        qsum = (qc[np.arange(lut.shape[0])[None, :], codes].sum(axis=1)
                if screened else np.zeros(codes.shape[0], np.int64))
        out.append((qsum, lb, screened))
    return out


def screened_scan(c, r, after=None, tile=64, counts=None):
    """The kernel's scan, emulated: tile by tile, candidates are the live
    rows whose Q is below the query's current T; each candidate passes the
    filter, then its exact key (the plain version's f32 chain) must come
    before the list's last (key, id) and after the lower bound."""
    codes, luts = c["codes"], c["luts"]
    b, m, ksub = luts.shape
    n = codes.shape[0]
    flat = luts.reshape(b, m * ksub)
    keys = pq._adc_sum(lambda mm: flat.index_select(
        1, codes[:, mm].long() + mm * ksub), m)
    passes = PF.eval_program_batched(c["progs"], c["ints"], c["floats"])
    live = c["norms"] < C.BIG
    state = _screen_state(c)
    ids = torch.arange(n, dtype=torch.int32)
    out_i = torch.full((b, r), -1, dtype=torch.int32)
    out_d = torch.full((b, r), C.BIG, dtype=torch.float32)
    for q in range(b):
        qsum, lb, screened = state[q]
        ad = -np.inf if after is None else float(after[0][q])
        ai = -1 if after is None else int(after[1][q])
        best_d, best_i = [], []
        for s in range(0, n, tile):
            tau = best_d[-1] if len(best_d) == r else C.BIG
            t = threshold(lb, screened, tau)
            rows = [row for row in range(s, min(n, s + tile))
                    if live[row] and qsum[row] < t]
            if counts is not None:
                counts[q] += len(rows)
            for row in rows:
                k = float(keys[q, row])
                tail = (best_d[-1], best_i[-1]) if len(best_d) == r else \
                    (C.BIG, -1)
                if (passes[q, row] and k < C.BIG and (k, row) < tail
                        and (ad, ai) < (k, row)):
                    best_d.append(k)
                    best_i.append(row)
                    order = sorted(range(len(best_d)),
                                   key=lambda j: (best_d[j], best_i[j]))[:r]
                    best_d = [best_d[j] for j in order]
                    best_i = [best_i[j] for j in order]
        out_d[q, :len(best_d)] = torch.tensor(best_d, dtype=torch.float32)
        out_i[q, :len(best_i)] = ids[best_i] if best_i else out_i[q, :0]
    return C.apply_missing(out_i, out_d, None)


CASES = [("random", 32, 256, torch.float32),
         ("random", 8, 16, torch.float32),
         ("random", 30, 256, torch.float32),
         ("random", 64, 16, torch.float32),
         ("random", 240, 16, torch.float32),
         ("random", 240, 256, torch.float32),
         ("wide_subspace", 32, 256, torch.float32),
         ("flat", 32, 256, torch.float32),
         ("offset", 32, 256, torch.float32),
         ("negative", 30, 16, torch.float32),
         ("nonfinite", 32, 256, torch.float32),
         ("random", 32, 256, torch.bfloat16),
         ("negative", 8, 256, torch.bfloat16)]


@pytest.mark.parametrize("kind,m,ksub,lut_dtype", CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_screen_keeps_every_pair_of_the_top_r(kind, m, ksub, lut_dtype):
    c = _case(kind, m, ksub, lut_dtype)
    r = 20
    want_i, want_d = _plain(c, r)
    state = _screen_state(c)
    for q, (qsum, lb, screened) in enumerate(state):
        fin = torch.isfinite(want_d[q])
        tau = float(want_d[q][fin][-1]) if bool(fin.all()) else C.BIG
        t = threshold(lb, screened, tau)
        kept = want_i[q][fin].numpy()
        assert (qsum[kept] < t).all(), (kind, q, qsum[kept].max(), t)
        if kind == "nonfinite" and q < 2:
            assert not screened
        if kind == "flat":                       # D = 1: every Q is 0
            assert screened and (qsum == 0).all()


@pytest.mark.parametrize("kind,m,ksub,lut_dtype", CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_screened_scan_equals_plain(kind, m, ksub, lut_dtype):
    c = _case(kind, m, ksub, lut_dtype)
    r = 20
    counts = [0] * c["luts"].shape[0]
    got_i, got_d = screened_scan(c, r, counts=counts)
    want_i, want_d = _plain(c, r)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    if kind == "random" and m >= 30:
        # not vacuous: well under half of the live pairs are candidates
        assert max(counts) < 0.5 * (c["codes"].shape[0] - 20), counts


@pytest.mark.parametrize("kind,m,ksub", [("random", 32, 256),
                                         ("flat", 8, 16),
                                         ("negative", 30, 16)])
def test_screened_scan_chained_and_after_a_bound(kind, m, ksub):
    """Passes of 7 chained after each other's last pair, and a scan after
    each query's own j-th pair, equal the one-pass plain top-R."""
    c = _case(kind, m, ksub, torch.float32, seed=3)
    r, kmax = 30, 7
    got_i, got_d = C.chain_topk(lambda kk, aft: screened_scan(c, kk, aft),
                                r, kmax)
    want_i, want_d = _plain(c, r)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    b = want_i.shape[0]
    j = torch.arange(b) % 5
    after = (want_d[torch.arange(b), j].contiguous(),
             want_i[torch.arange(b), j].contiguous())
    got_i, got_d = screened_scan(c, 10, after)
    want_i, want_d = _plain(c, 10, after)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


def test_levels_keep_packed_sums_in_a_u16_lane():
    for m in (1, 8, 32, 128, 129, 240, 1000, pq.QSUM_MAX):
        levels = pq.screen_levels(m)
        assert 1 <= levels <= 255 and levels * m <= pq.QSUM_MAX


def test_directed_rounding_helpers():
    """The emulation's f32 rounding: down <= exact <= up, one ulp apart
    unless exact, against exact rationals."""
    from fractions import Fraction
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(200) * 10.0 ** rng.uniform(-5, 5, 200)).astype(
        np.float32)
    b = (np.abs(rng.standard_normal(200)) * 10.0 ** rng.uniform(-5, 5, 200)
         + 1e-30).astype(np.float32)
    for exact, lo, hi in (
            ([Fraction(float(x)) + Fraction(float(y)) for x, y in zip(a, b)],
             add_dir(a, b, False), add_dir(a, b, True)),
            ([Fraction(float(x)) / Fraction(float(y)) for x, y in zip(a, b)],
             div_dir(a, b, False), div_dir(a, b, True))):
        for e, d, u in zip(exact, lo, hi):
            assert Fraction(float(d)) <= e <= Fraction(float(u))
            assert u == d or np.nextafter(d, F32_INF) == u
