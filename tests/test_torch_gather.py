"""Port parity, the graph route's two gathers on the CPU: ``gather_distance``
and ``pq_adc_gather`` (what their wrappers run on CPU tensors) take int32
and int64 ids alike, and keep the JAX package's contract -- +inf at -1 ids,
the ``valid`` lane mask (+inf and no TD hit on a dead lane), D = +inf, pad
rows (NaN floats, -1 ints) -- against its ``ops`` run as its own tests run
them (Pallas interpret mode).  The CUDA kernels are held to the same plain
versions in ``test_torch_cuda.py`` (card only)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import filters as RF  # noqa: E402
from repro.kernels.gather_distance import ops as r_gd  # noqa: E402
from repro.kernels.pq_adc import ops as r_pq  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core import scoring  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402
from repro_torch.kernels import _common  # noqa: E402
from repro_torch.kernels.gather_distance import ops as p_gd  # noqa: E402
from repro_torch.kernels.pq_adc import ops as p_pq  # noqa: E402


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
    return [F.TrueFilter(), F.Equality("b0", True),
            F.Inclusion("i0", [1, 5, 9]), F.Range("f0", 20.0, 70.0),
            F.Not(F.Range("f0", 30.0, 80.0))]


def _case(n, d, b, m, seed, width=8):
    """One DB, query batch and id block for both packages: the last tenth of
    the rows are padding (NaN floats, -1 ints), about 10 % of the ids are
    -1, D = +inf on every third query, every fourth query's lane is dead."""
    rng = np.random.default_rng(seed)
    rs, ps = RF.paper_schema(), PF.paper_schema()
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    attrs = RF.random_attributes(rs, n, seed=seed + 1)
    ints, floats = attrs.ints.copy(), attrs.floats.copy()
    ints[-n // 10:] = -1
    floats[-n // 10:] = np.nan
    rpool, ppool = _pool(RF), _pool(PF)
    rprog = {k: jnp.asarray(v) for k, v in RF.stack_programs(
        [RF.compile_filter(rpool[i % len(rpool)], rs, width)
         for i in range(b)]).items()}
    pprog = compile_programs([ppool[i % len(ppool)] for i in range(b)], ps,
                             b, width, device="cpu")
    ids = rng.integers(0, n, size=(b, m)).astype(np.int64)
    ids[rng.random((b, m)) < 0.1] = -1
    ids[:, 0] = -1
    dvec = rng.uniform(0.1, 2.0, size=b).astype(np.float32)
    dvec[::3] = np.inf
    valid = np.ones(b, bool)
    valid[3::4] = False
    return dict(vecs=vecs, norms=norms, ints=ints, floats=floats,
                qs=rng.normal(size=(b, d)).astype(np.float32), rprog=rprog,
                pprog=pprog, ids=ids, dvec=dvec, valid=valid, rng=rng)


def _db(c):
    return tuple(torch.as_tensor(c[k])
                 for k in ("vecs", "norms", "ints", "floats"))


# ---------------------------------------------------------------------------
# gather_distance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,m,width", [(1, 1, 8), (3, 16, 1), (9, 32, 8),
                                       (6, 7, 2)])
def test_gather_distance_int64_ids_match_int32(b, m, width):
    c = _case(400, 16, b, m, seed=b * 7 + m, width=width)
    args = (*_db(c), torch.as_tensor(c["qs"]))
    rest = (c["pprog"], torch.as_tensor(c["dvec"]))
    ids64 = torch.as_tensor(c["ids"])
    for valid in (None, torch.as_tensor(c["valid"])):
        d64, t64 = p_gd.gather_distance(*args, ids64, *rest, valid=valid)
        d32, t32 = p_gd.gather_distance(*args, ids64.to(torch.int32), *rest,
                                        valid=valid)
        assert torch.equal(d64, d32) and torch.equal(t64, t32)
        assert torch.isinf(d64[:, 0]).all() and not t64[:, 0].any()


@pytest.mark.parametrize("b,m", [(4, 16), (8, 32)])
def test_gather_distance_contract_matches_pallas(b, m):
    """-1 ids, dead lanes, D = +inf and pad rows against the JAX package's
    ``ops.gather_distance`` (interpret mode), the port given int64 ids."""
    c = _case(300, 16, b, m, seed=b + m)
    rd, rtd = r_gd.gather_distance(
        *(jnp.asarray(c[k]) for k in ("vecs", "norms", "ints", "floats",
                                      "qs")),
        jnp.asarray(c["ids"].astype(np.int32)), c["rprog"],
        jnp.asarray(c["dvec"]), interpret=True,
        valid=jnp.asarray(c["valid"]))
    pd, ptd = p_gd.gather_distance(*_db(c), torch.as_tensor(c["qs"]),
                                   torch.as_tensor(c["ids"]), c["pprog"],
                                   torch.as_tensor(c["dvec"]),
                                   valid=torch.as_tensor(c["valid"]))
    rd, rtd = np.asarray(rd), np.asarray(rtd)
    np.testing.assert_array_equal(np.isinf(pd.numpy()), np.isinf(rd))
    np.testing.assert_allclose(pd.numpy(), rd, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ptd.numpy(), rtd)
    assert np.isinf(pd.numpy()[~c["valid"]]).all()
    assert not ptd.numpy()[~c["valid"]].any()


# ---------------------------------------------------------------------------
# pq_adc_gather
# ---------------------------------------------------------------------------
def _pq_tables(c, n, b, m, ksub, lut_dtype):
    rng = c["rng"]
    codes = rng.integers(0, ksub, size=(n, m)).astype(np.uint8)
    luts = rng.uniform(0, 4.0, size=(b, m, ksub)).astype(np.float32)
    return codes, torch.as_tensor(luts).to(lut_dtype)


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,m0,m,ksub", [(1, 1, 32, 256), (3, 16, 8, 64),
                                         (5, 32, 32, 256)])
def test_pq_adc_gather_int64_ids_match_int32(b, m0, m, ksub, lut_dtype):
    n = 300
    c = _case(n, 8, b, m0, seed=b + m0 + m)
    codes, luts = _pq_tables(c, n, b, m, ksub, lut_dtype)
    codes = torch.as_tensor(codes)
    ids64 = torch.as_tensor(c["ids"])
    kw = dict(ints=torch.as_tensor(c["ints"]),
              floats=torch.as_tensor(c["floats"]), programs=c["pprog"],
              dvec=torch.as_tensor(c["dvec"]))
    for valid in (None, torch.as_tensor(c["valid"])):
        a64 = p_pq.pq_adc_gather(codes, luts, ids64, valid=valid)
        a32 = p_pq.pq_adc_gather(codes, luts, ids64.to(torch.int32),
                                 valid=valid)
        assert torch.equal(a64, a32) and torch.isinf(a64[:, 0]).all()
        d64, t64 = p_pq.pq_adc_gather(codes, luts, ids64, valid=valid, **kw)
        d32, t32 = p_pq.pq_adc_gather(codes, luts, ids64.to(torch.int32),
                                      valid=valid, **kw)
        assert torch.equal(d64, d32) and torch.equal(t64, t32)


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16])
def test_pq_adc_gather_contract_matches_pallas(lut_dtype):
    """adc2 against the JAX package's ``ops.pq_adc_gather`` (interpret mode;
    it has no lane mask, so a dead lane is +inf on its side by hand), bit
    for bit, from int64 ids; filter mode against the JAX gathered filter
    and Eq. 2 on those sums."""
    n, b, m0, m, ksub = 300, 6, 16, 8, 64
    c = _case(n, 8, b, m0, seed=21)
    codes, luts = _pq_tables(c, n, b, m, ksub, lut_dtype)
    jl = jnp.asarray(luts.float().numpy())
    if lut_dtype == torch.bfloat16:
        jl = jl.astype(jnp.bfloat16)
    ref = np.asarray(r_pq.pq_adc_gather(jnp.asarray(codes), jl,
                                        jnp.asarray(c["ids"].astype(np.int32)),
                                        block_q=2, interpret=True))
    ref = np.where(c["valid"][:, None], ref, np.inf)
    got = p_pq.pq_adc_gather(torch.as_tensor(codes), luts,
                             torch.as_tensor(c["ids"]),
                             valid=torch.as_tensor(c["valid"]))
    np.testing.assert_array_equal(got.numpy(), ref)
    safe = jnp.asarray(np.clip(c["ids"], 0, None))
    td = np.array(RF.eval_program_gathered(
        c["rprog"], jnp.asarray(c["ints"])[safe],
        jnp.asarray(c["floats"])[safe]))
    td &= (c["ids"] >= 0) & c["valid"][:, None]
    pd, ptd = p_pq.pq_adc_gather(
        torch.as_tensor(codes), luts, torch.as_tensor(c["ids"]),
        ints=torch.as_tensor(c["ints"]), floats=torch.as_tensor(c["floats"]),
        programs=c["pprog"], dvec=torch.as_tensor(c["dvec"]),
        valid=torch.as_tensor(c["valid"]))
    np.testing.assert_array_equal(ptd.numpy(), td)
    with np.errstate(invalid="ignore"):
        want = np.sqrt(np.maximum(ref, 0.0)) + np.where(
            td, 0.0, c["dvec"][:, None]).astype(np.float32)
    want = np.where(np.isfinite(ref), want, np.inf).astype(np.float32)
    np.testing.assert_allclose(pd.numpy(), want, rtol=TOL, atol=TOL)
    assert np.isinf(pd.numpy()[~c["valid"]]).all()


# ---------------------------------------------------------------------------
# the scorers hand the traversal's ids over as they are; the helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scorer", ["exact", "pq"])
def test_scorers_pass_int64_ids_through(monkeypatch, scorer):
    """``score_block`` gives the wrapper the traversal's own (B, M) int64
    tensor: no int32 copy per wave."""
    seen = []

    def spy(*args, **kw):
        seen.append(args[5] if scorer == "exact" else args[2])
        return "out"

    ids = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    if scorer == "exact":
        monkeypatch.setattr(scoring.gd_ops, "gather_distance", spy)
        out = scoring.ExactScorer().score_block(
            {"vectors": 0, "norms": 0, "attrs_int": 0, "attrs_float": 0},
            {"q": 0, "programs": 0}, ids, 0)
    else:
        monkeypatch.setattr(scoring.pq_ops, "pq_adc_gather", spy)
        out = scoring.PqAdcScorer().score_block(
            {"codes": 0, "attrs_int": 0, "attrs_float": 0},
            {"luts": 0, "programs": 0}, ids, 0)
    assert out == "out" and seen[0] is ids


def test_id_dtype_and_lane_mask_helpers():
    assert _common.id_dtype(torch.zeros(2, dtype=torch.int64)) == torch.int64
    assert _common.id_dtype(torch.zeros(2, dtype=torch.int32)) == torch.int32
    assert _common.id_dtype(torch.zeros(2)) == torch.int32
    assert _common.id_dtype([1, 2]) == torch.int32
    cpu = torch.device("cpu")
    assert _common.lane_mask("t", None, 3, cpu) is None
    mask = torch.tensor([True, False, True])
    assert _common.lane_mask("t", mask, 3, cpu) is mask
    got = _common.lane_mask("t", np.array([1, 0, 1, 1]), 4, cpu)
    assert got.dtype == torch.bool and got.tolist() == [True, False, True,
                                                        True]
    with pytest.raises(ValueError, match="contiguous"):
        _common.lane_mask("t", torch.tensor([True, False] * 4)[::2], 4, cpu)
    with pytest.raises(ValueError, match="shape"):
        _common.lane_mask("t", mask, 4, cpu)


def test_launch_widths_follow_the_counts():
    K.reset_launch_counts()
    K.count_launch("gather_distance", (878, 32))
    K.count_launch("gather_distance", (878, 32))
    K.count_launch("gather_distance", (878, 1))
    K.count_launch("filtered_topk")
    assert K.launch_counts["gather_distance"] == 3
    assert K.launch_widths["gather_distance"] == {(878, 32): 2, (878, 1): 1}
    assert K.launch_widths["filtered_topk"] == {}
    K.reset_launch_counts()
    assert K.launch_widths["gather_distance"] == {}
    assert K.launch_counts["gather_distance"] == 0
