"""Port parity, quantization: the plain versions of ``pq_adc_topr`` and
``pq_adc_gather`` (what the wrappers run on CPU tensors) against the JAX
package's Pallas kernels in interpret mode, and ``repro_torch.quant``
(LUTs, encode/decode, SQ, codebook files, the compressed scans) against
``repro.quant`` on the same numpy inputs.

Bars: the kernels' distances rtol/atol 1e-5 with ids equal outside ties --
and, since both sum the LUT entries in subspace order, bit-identical in
fact; LUTs and encodings at 1e-5; codebook files identical both ways.  The
CUDA kernels against the same plain versions are in ``test_torch_cuda.py``
(card only)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import quant as rq  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import prefbf as r_prefbf  # noqa: E402
from repro.kernels.pq_adc import ops as r_pq  # noqa: E402
from repro.quant import adc as r_adc  # noqa: E402
from repro_torch import quant as pq  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402
from repro_torch.kernels.pq_adc import ops as p_pq  # noqa: E402
from repro_torch.parity import topk_mismatch  # noqa: E402
from repro_torch.quant import adc as p_adc  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def _pool(F):
    return [F.Equality("b0", True), F.Inclusion("i0", [1, 5, 9]),
            F.Range("f0", 10.0, 60.0), F.TrueFilter(),
            F.Not(F.Range("f0", 30.0, 80.0))]


def _programs(b, schema_kw=None, pool=None):
    rs, ps = RF.paper_schema(**(schema_kw or {})), PF.paper_schema(
        **(schema_kw or {}))
    rpool, ppool = (pool or _pool)(RF), (pool or _pool)(PF)
    rprog = {k: jnp.asarray(v) for k, v in RF.stack_programs(
        [RF.compile_filter(rpool[i % len(rpool)], rs) for i in range(b)]).items()}
    pprog = compile_programs([ppool[i % len(ppool)] for i in range(b)], ps, b,
                             device="cpu")
    return rs, rprog, pprog


def _scan_case(n, b, m, nbits, seed, schema_kw=None, pool=None, n_pad=0):
    """Random codes / LUTs / norms / attributes; the last ``n_pad`` rows
    are padding (norm +inf, ints -1, floats NaN, as prefbf.pad_db writes)."""
    rng = np.random.default_rng(seed)
    k = 1 << nbits
    codes = rng.integers(0, k, size=(n, m)).astype(np.uint8)
    luts = rng.uniform(0, 4.0, size=(b, m, k)).astype(np.float32)
    norms = rng.uniform(1.0, 2.0, size=(n,)).astype(np.float32)
    rs, rprog, pprog = _programs(b, schema_kw, pool)
    attrs = RF.random_attributes(rs, n, seed=seed + 1)
    ints, floats = attrs.ints.copy(), attrs.floats.copy()
    if n_pad:
        norms[-n_pad:] = np.inf
        ints[-n_pad:] = -1
        floats[-n_pad:] = np.nan
    return dict(codes=codes, luts=luts, norms=norms, ints=ints, floats=floats,
                rprog=rprog, pprog=pprog, rng=rng)


def _j(c, *keys):
    return [jnp.asarray(c[k]) for k in keys]


def _t(c, *keys):
    return [torch.as_tensor(c[k]) for k in keys]


# ---------------------------------------------------------------------------
# pq_adc_topr
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,b,m,nbits,r,n_pad,chunk", [
    (700, 6, 8, 6, 20, 0, 256),      # favor-anns-like M, 6-bit codes
    (900, 5, 4, 8, 40, 60, 1024),    # pad rows, one chunk
    (300, 3, 16, 4, 64, 0, 128),     # R above the rows that pass some filters
])
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16"])
def test_pq_adc_topr_plain_matches_pallas(n, b, m, nbits, r, n_pad, chunk,
                                          lut_dtype):
    c = _scan_case(n, b, m, nbits, seed=n + m, n_pad=n_pad)
    valid = np.ones((b,), bool)
    valid[1] = False
    rl = jnp.asarray(c["luts"])
    pl_ = torch.as_tensor(c["luts"])
    if lut_dtype == "bf16":
        rl, pl_ = rl.astype(jnp.bfloat16), pl_.to(torch.bfloat16)
    rid, rd = r_pq.pq_adc_topr(*_j(c, "codes", "norms", "ints", "floats"),
                               rl, c["rprog"], r=r, block_q=4, block_n=128,
                               interpret=True, valid=jnp.asarray(valid))
    pid, pd = p_pq.pq_adc_topr(*_t(c, "codes", "norms", "ints", "floats"),
                               pl_, c["pprog"], r=r, chunk=chunk,
                               valid=torch.as_tensor(valid))
    assert pid.dtype == torch.int32 and pd.dtype == torch.float32
    assert pid.shape == (b, r)
    assert (pid[1] == -1).all() and torch.isinf(pd[1]).all()
    m_ = topk_mismatch(np.asarray(rid), np.asarray(rd), pid.numpy(),
                       pd.numpy(), rtol=TOL, atol=TOL)
    assert m_["dist_mismatch"] == 0 and m_["id_mismatch"] == 0, m_
    # the subspace-order sum reproduces the one-hot products exactly
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    assert int(pid.max()) < n - n_pad              # pad rows never returned


def test_pq_adc_topr_zero_width_attributes():
    """A schema with no float column: the reference's interpret mode raises
    there (ROADMAP section 3), so the plain version is held to the
    reference's dense oracle."""
    from repro.kernels.pq_adc import ref as r_ref
    pool = (lambda F: [F.Equality("b0", True), F.Inclusion("i0", [2, 3]),
                       F.TrueFilter()])
    c = _scan_case(500, 4, 8, 6, seed=3, schema_kw=dict(n_float=0),
                   pool=pool)
    rd, ri = r_ref.pq_adc_topr_ref(*_j(c, "luts", "codes", "norms", "ints",
                                       "floats"), c["rprog"], r=30)
    pid, pd = p_pq.pq_adc_topr(*_t(c, "codes", "norms", "ints", "floats",
                                   "luts"), c["pprog"], r=30)
    rd = np.where(np.asarray(rd) >= 3.0e38, np.inf, np.asarray(rd))
    m_ = topk_mismatch(np.where(np.isinf(rd), -1, np.asarray(ri)), rd,
                       pid.numpy(), pd.numpy(), rtol=TOL, atol=TOL)
    assert m_["dist_mismatch"] == 0 and m_["id_mismatch"] == 0, m_


# ---------------------------------------------------------------------------
# pq_adc_gather
# ---------------------------------------------------------------------------
def _gather_case(n, b, m0, m, nbits, seed, schema_kw=None, pool=None):
    c = _scan_case(n, b, m, nbits, seed, schema_kw, pool)
    ids = c["rng"].integers(-1, n, size=(b, m0)).astype(np.int32)
    ids[:, 0] = -1                      # the -1 id path in every case
    c["ids"] = ids
    c["dvec"] = c["rng"].uniform(0.1, 1.0, size=(b,)).astype(np.float32)
    return c


@pytest.mark.parametrize("n,b,m0,m,nbits", [(400, 5, 12, 8, 6),
                                            (300, 9, 32, 16, 8),
                                            (200, 3, 7, 6, 5)])
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16"])
def test_pq_adc_gather_plain_matches_pallas(n, b, m0, m, nbits, lut_dtype):
    c = _gather_case(n, b, m0, m, nbits, seed=n + m0)
    rl = jnp.asarray(c["luts"])
    pl_ = torch.as_tensor(c["luts"])
    if lut_dtype == "bf16":
        rl, pl_ = rl.astype(jnp.bfloat16), pl_.to(torch.bfloat16)
    ref = np.asarray(r_pq.pq_adc_gather(jnp.asarray(c["codes"]), rl,
                                        jnp.asarray(c["ids"]), block_q=4,
                                        interpret=True))
    got = p_pq.pq_adc_gather(torch.as_tensor(c["codes"]), pl_,
                             torch.as_tensor(c["ids"]))
    assert got.dtype == torch.float32 and torch.isinf(got[:, 0]).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.numpy(), ref)        # bit for bit
    valid = torch.ones(b, dtype=torch.bool)
    valid[-1] = False
    masked = p_pq.pq_adc_gather(torch.as_tensor(c["codes"]), pl_,
                                torch.as_tensor(c["ids"]), valid=valid)
    assert torch.isinf(masked[-1]).all()
    assert torch.equal(masked[:-1], got[:-1])


@pytest.mark.parametrize("schema_kw", [None, dict(n_float=0)],
                         ids=["paper", "no_float"])
def test_pq_adc_gather_filter_mode_matches_reference(schema_kw):
    """Filter mode -- the traversal's (dbar, td) -- against the JAX
    traversal's composition around its kernel: sqrt(max(adc2, 0)), the
    gathered filter evaluation and Eq. 2 (``scoring.exclusion_compose``)."""
    from repro.core.scoring import exclusion_compose
    pool = (None if schema_kw is None else
            (lambda F: [F.Equality("b0", False), F.Inclusion("i0", [0, 4]),
                        F.TrueFilter()]))
    c = _gather_case(350, 6, 16, 8, 6, seed=11, schema_kw=schema_kw,
                     pool=pool)
    luts = jnp.asarray(c["luts"]).astype(jnp.bfloat16)
    ids = jnp.asarray(c["ids"])
    adc2 = r_pq.pq_adc_gather(jnp.asarray(c["codes"]), luts, ids, block_q=2,
                              interpret=True)
    safe = jnp.maximum(ids, 0)
    td = RF.eval_program_gathered(c["rprog"], jnp.asarray(c["ints"])[safe],
                                  jnp.asarray(c["floats"])[safe], xp=jnp)
    td = np.asarray(td & (ids >= 0))
    dbar = exclusion_compose(jnp.sqrt(jnp.maximum(adc2, 0.0)), td,
                             jnp.asarray(c["dvec"])[:, None])
    dbar = np.where(np.asarray(ids) < 0, np.inf, np.asarray(dbar))
    pd, ptd = p_pq.pq_adc_gather(
        *_t(c, "codes"), torch.as_tensor(c["luts"]).to(torch.bfloat16),
        *_t(c, "ids"), ints=torch.as_tensor(c["ints"]),
        floats=torch.as_tensor(c["floats"]), programs=c["pprog"],
        dvec=torch.as_tensor(c["dvec"]))
    assert ptd.dtype == torch.bool
    np.testing.assert_array_equal(ptd.numpy(), td)
    np.testing.assert_allclose(pd.numpy(), dbar, rtol=TOL, atol=TOL)
    assert torch.isinf(pd[:, 0]).all() and not ptd[:, 0].any()


# ---------------------------------------------------------------------------
# quant/pq.py and quant/adc.py
# ---------------------------------------------------------------------------
def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng


@pytest.fixture(scope="module")
def ref_codebook():
    """A codebook the JAX package trained (m=8 over d=14: a zero-padded
    last subspace) and its training data."""
    x, rng = _data(1500, 14, seed=4)
    return rq.train_pq(x, m=8, nbits=6, iters=10, seed=0), x, rng


def test_build_luts_matches_reference(ref_codebook):
    cb, _, rng = ref_codebook
    qs = rng.normal(size=(7, 14)).astype(np.float32)
    ref = np.asarray(r_adc.build_luts(jnp.asarray(cb.centroids),
                                      jnp.asarray(qs)))
    got = p_adc.build_luts(torch.as_tensor(cb.centroids), torch.as_tensor(qs))
    assert got.shape == (7, 8, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_encode_decode_match_reference(ref_codebook):
    cb, x, _ = ref_codebook
    pcb = pq.PQCodebook(cb.centroids, cb.dim)
    assert (pcb.m, pcb.ksub, pcb.dsub, pcb.nbits, pcb.padded_dim) == \
        (cb.m, cb.ksub, cb.dsub, cb.nbits, cb.padded_dim)
    ref = rq.encode(cb, x)
    got = pq.encode(pcb, x, chunk=512, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    # nearest-centroid ties at 1e-5 may go either way; on this data none do
    assert (got.numpy() == ref).mean() == 1.0
    np.testing.assert_array_equal(pq.decode(pcb, got).numpy(),
                                  rq.decode(cb, ref))


def test_sq_matches_reference():
    x, _ = _data(600, 12, seed=6)
    rcb, pcb = rq.train_sq(x), pq.train_sq(x)
    np.testing.assert_array_equal(pcb.lo, rcb.lo)
    np.testing.assert_array_equal(pcb.scale, rcb.scale)
    codes = pq.encode(pcb, x, device="cpu")
    np.testing.assert_array_equal(codes.numpy(), rq.encode(rcb, x))
    np.testing.assert_array_equal(pq.decode(pcb, codes).numpy(),
                                  rq.decode(rcb, codes.numpy()))


@pytest.mark.parametrize("kind", ["pq", "sq"])
def test_codebook_files_cross_packages(ref_codebook, kind, tmp_path):
    cb, x, _ = ref_codebook
    if kind == "sq":
        cb = rq.train_sq(x)
    rq.save_codebook(str(tmp_path / "ref.npz"), cb)
    got = pq.load_codebook(str(tmp_path / "ref.npz"))
    assert type(got).__name__ == type(cb).__name__ and got.dim == cb.dim
    pq.save_codebook(str(tmp_path / "port.npz"), got)
    back = rq.load_codebook(str(tmp_path / "port.npz"))
    for field in (("centroids",) if kind == "pq" else ("lo", "scale")):
        np.testing.assert_array_equal(getattr(got, field), getattr(cb, field))
        np.testing.assert_array_equal(getattr(back, field), getattr(cb, field))


def test_train_pq_on_torch():
    """The port's own k-means: a valid codebook whose ADC distances track
    the exact ones as closely as the JAX package's own bar
    (``tests/test_quant.py``), and deterministic for a seed."""
    x, rng = _data(1500, 16, seed=5)
    cb = pq.train_pq(x, m=8, nbits=6, iters=10, seed=0, device="cpu")
    assert cb.centroids.shape == (8, 64, 2) and cb.dim == 16
    again = pq.train_pq(x, m=8, nbits=6, iters=10, seed=0,
                        device="cpu")
    np.testing.assert_array_equal(cb.centroids, again.centroids)
    codes = pq.encode(cb, x, device="cpu")
    qs = torch.as_tensor(rng.normal(size=(8, 16)).astype(np.float32))
    luts = p_adc.build_luts(torch.as_tensor(cb.centroids), qs)
    ids = torch.arange(1500, dtype=torch.int32).expand(8, -1).contiguous()
    adc = p_pq.pq_adc_gather(codes, luts, ids).numpy()
    exact = np.linalg.norm(qs.numpy()[:, None, :] - x[None], axis=-1)
    err = np.abs(np.sqrt(adc) - exact)
    assert float(np.mean(err)) / float(np.mean(exact)) < 0.1
    with pytest.raises(ValueError, match="nbits"):
        pq.train_pq(x, m=8, nbits=9)


def _scan_args(ref_codebook, n_rows, chunk):
    cb, x, rng = ref_codebook
    x = x[:n_rows]
    attrs = RF.random_attributes(RF.paper_schema(), len(x), seed=8)
    padded = r_prefbf.pad_db(x, np.einsum("nd,nd->n", x, x), attrs.ints,
                             attrs.floats, chunk)
    b = 10
    qs = rng.normal(size=(b, x.shape[1])).astype(np.float32)
    _, rprog, pprog = _programs(b)
    return cb, padded, qs, rprog, pprog


def test_pq_prefbf_topk_matches_reference(ref_codebook):
    """The compressed brute route on the JAX codebook: identical ids (the
    candidate lists agree bit for bit, see the kernel test) and exact
    distances at 1e-5."""
    cb, padded, qs, rprog, pprog = _scan_args(ref_codebook, 1300, 256)
    codes = rq.encode(cb, padded[0])
    ri, rd = r_adc.pq_prefbf_topk(
        jnp.asarray(codes), *(jnp.asarray(a) for a in padded[1:]),
        jnp.asarray(qs), rprog, jnp.asarray(cb.centroids),
        jnp.asarray(padded[0]), k=10, rerank=3, chunk=256)
    pv, pn, pi, pf = (torch.as_tensor(a) for a in padded)
    pi_, pd_ = p_adc.pq_prefbf_topk(
        torch.as_tensor(codes), pn, pi, pf, torch.as_tensor(qs), pprog,
        torch.as_tensor(cb.centroids), pv, k=10, rerank=3, chunk=256)
    m_ = topk_mismatch(np.asarray(ri), np.asarray(rd), pi_.numpy(),
                       pd_.numpy(), rtol=TOL, atol=TOL)
    assert m_["dist_mismatch"] == 0 and m_["id_mismatch"] == 0, m_
    assert int(pi_.max()) < 1300


def test_sq_prefbf_topk_matches_reference(ref_codebook):
    cb, padded, qs, rprog, pprog = _scan_args(ref_codebook, 1024, 256)
    scb = rq.train_sq(padded[0][:1024])
    codes = rq.encode(scb, padded[0])
    valid = np.ones((len(qs),), bool)
    valid[2] = False
    ri, rd = r_adc.sq_prefbf_topk(
        jnp.asarray(codes), jnp.asarray(scb.lo), jnp.asarray(scb.scale),
        *(jnp.asarray(a) for a in padded[1:]), jnp.asarray(qs), rprog,
        jnp.asarray(padded[0]), k=10, rerank=2, chunk=256,
        valid=jnp.asarray(valid))
    pv, pn, pi, pf = (torch.as_tensor(a) for a in padded)
    pi_, pd_ = p_adc.sq_prefbf_topk(
        torch.as_tensor(codes), torch.as_tensor(scb.lo),
        torch.as_tensor(scb.scale), pn, pi, pf, torch.as_tensor(qs), pprog,
        pv, k=10, rerank=2, chunk=300, valid=torch.as_tensor(valid))
    m_ = topk_mismatch(np.asarray(ri), np.asarray(rd), pi_.numpy(),
                       pd_.numpy(), rtol=TOL, atol=TOL)
    assert m_["dist_mismatch"] == 0 and m_["id_mismatch"] == 0, m_
    assert (pi_[2] == -1).all()
