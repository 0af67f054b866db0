"""Port parity, kernels: the plain versions of ``filtered_topk``,
``gather_distance`` and ``embedding_bag`` (what a wrapper runs on CPU
tensors) against the JAX
package's Pallas kernels in interpret mode and its jnp paths, at the
reference's own bar (``tests/test_kernels.py``): distances rtol/atol 1e-5,
ids equal wherever the reference's neighbouring distances differ by more.
The CUDA kernels against the same plain versions are in
``test_torch_cuda.py`` (card only)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import filters as RF  # noqa: E402
from repro.core import prefbf as r_prefbf  # noqa: E402
from repro.kernels.embedding_bag import ops as r_eb  # noqa: E402
from repro.kernels.embedding_bag import ref as r_eb_ref  # noqa: E402
from repro.kernels.filtered_topk import ops as r_ft  # noqa: E402
from repro.kernels.gather_distance import ops as r_gd  # noqa: E402
from repro.kernels.gather_distance import ref as r_gd_ref  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core import prefbf as p_prefbf  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as p_eb  # noqa: E402
from repro_torch.kernels.filtered_topk import ops as p_ft  # noqa: E402
from repro_torch.kernels.gather_distance import ops as p_gd  # noqa: E402
from repro_torch.parity import topk_mismatch  # noqa: E402


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
    return [F.Equality("b0", True), F.Equality("i0", 3),
            F.Inclusion("i0", [1, 5, 9]), F.Range("f0", 10.0, 60.0),
            F.And(F.Equality("b0", False), F.Range("f0", None, 50.0)),
            F.Not(F.Range("f0", 30.0, 80.0)), F.TrueFilter(),
            F.And(F.Equality("i0", 3), F.Range("f0", 10, 12))]


def _case(n, d, b, seed, schema_kw=None, pool=None):
    """The same DB, queries and filter programs for both packages."""
    schema_kw = schema_kw or {}
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    rs, ps = RF.paper_schema(**schema_kw), PF.paper_schema(**schema_kw)
    attrs = RF.random_attributes(rs, n, seed=seed + 1)
    qs = rng.normal(size=(b, d)).astype(np.float32)
    rpool = pool(RF) if pool else _pool(RF)
    ppool = pool(PF) if pool else _pool(PF)
    rprog = {k: jnp.asarray(v) for k, v in RF.stack_programs(
        [RF.compile_filter(rpool[i % len(rpool)], rs) for i in range(b)]).items()}
    pprog = compile_programs([ppool[i % len(ppool)] for i in range(b)], ps, b,
                             device="cpu")
    return dict(vecs=vecs, norms=norms, ints=attrs.ints, floats=attrs.floats,
                qs=qs, rprog=rprog, pprog=pprog, rng=rng)


def _t(c):
    return (torch.as_tensor(c["vecs"]), torch.as_tensor(c["norms"]),
            torch.as_tensor(c["ints"]), torch.as_tensor(c["floats"]),
            torch.as_tensor(c["qs"]))


def _j(c):
    return (jnp.asarray(c["vecs"]), jnp.asarray(c["norms"]),
            jnp.asarray(c["ints"]), jnp.asarray(c["floats"]),
            jnp.asarray(c["qs"]))


def _assert_bar(ref_ids, ref_d, ids, dists):
    m = topk_mismatch(np.asarray(ref_ids), np.asarray(ref_d), ids.numpy(),
                      dists.numpy(), rtol=TOL, atol=TOL)
    assert m["dist_mismatch"] == 0, m
    assert m["id_mismatch"] == 0, m


# ---------------------------------------------------------------------------
# filtered_topk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,d,b,k,chunk", [
    (700, 16, 12, 5, 128),     # N not a multiple of the chunk
    (1024, 32, 8, 10, 256),
    (300, 8, 9, 32, 512),      # large k, one chunk
])
@pytest.mark.parametrize("exclude", [False, True])
def test_filtered_topk_plain_matches_pallas(n, d, b, k, chunk, exclude):
    c = _case(n, d, b, seed=n + d)
    dvec = c["rng"].uniform(0.1, 1.0, size=(b,)).astype(np.float32)
    valid = np.ones((b,), bool)
    valid[1] = False
    rid, rd = r_ft.filtered_topk(*_j(c)[:4], jnp.asarray(c["qs"]), c["rprog"],
                                 k=k, block_q=8, block_n=128,
                                 dvec=jnp.asarray(dvec), exclude=exclude,
                                 interpret=True, valid=jnp.asarray(valid))
    pid, pd = p_ft.filtered_topk(*_t(c), c["pprog"], k=k,
                                 dvec=torch.as_tensor(dvec), exclude=exclude,
                                 valid=torch.as_tensor(valid), chunk=chunk)
    assert pid.dtype == torch.int32 and pd.dtype == torch.float32
    assert (pid[1] == -1).all() and torch.isinf(pd[1]).all()
    _assert_bar(rid, rd, pid, pd)


@pytest.mark.parametrize("n,chunk", [(1200, 256), (512, 512)])
def test_prefbf_matches_reference(n, chunk):
    """The port's prefbf_topk (the filtered_topk wrapper, plain scan on CPU)
    against the JAX package's jnp prefbf_topk on padded arrays."""
    c = _case(n, 16, 6, seed=9)
    padded = r_prefbf.pad_db(c["vecs"], c["norms"], c["ints"], c["floats"],
                             chunk)
    rid, rd = r_prefbf.prefbf_topk(*(jnp.asarray(a) for a in padded),
                                   jnp.asarray(c["qs"]), c["rprog"], k=10,
                                   chunk=chunk)
    pp = p_prefbf.pad_db(c["vecs"], c["norms"], c["ints"], c["floats"], chunk)
    for a, b in zip(padded, pp):
        np.testing.assert_array_equal(a, b)
    pt = [torch.as_tensor(a) for a in pp]
    qs = torch.as_tensor(c["qs"])
    pid, pd = p_prefbf.prefbf_topk(*pt, qs, c["pprog"], k=10, chunk=chunk)
    _assert_bar(rid, rd, pid, pd)
    assert int(pid.max()) < n  # pad rows gated


def test_filtered_topk_exclusion_never_returns_pad_rows():
    """k above the row count: the reference kernel returns pad ids there;
    the port's contract is -1 / +inf."""
    c = _case(20, 8, 3, seed=2)
    pt = [torch.as_tensor(a) for a in
          p_prefbf.pad_db(c["vecs"], c["norms"], c["ints"], c["floats"], 32)]
    dvec = torch.full((3,), 0.5)
    ids, dists = p_ft.filtered_topk(*pt, torch.as_tensor(c["qs"]), c["pprog"],
                                    k=32, dvec=dvec, exclude=True, chunk=32)
    assert ((ids >= 0) & (ids < 20)).sum(dim=1).tolist() == [20, 20, 20]
    assert (ids[:, 20:] == -1).all() and torch.isinf(dists[:, 20:]).all()


ZERO_WIDTH = {
    "no_float": (dict(n_bool=1, n_int=1, n_float=0),
                 lambda F: [F.Equality("b0", True), F.Inclusion("i0", [2, 3]),
                            F.TrueFilter()]),
    "no_int": (dict(n_bool=0, n_int=0, n_float=1),
               lambda F: [F.Range("f0", 20.0, 70.0), F.TrueFilter()]),
}


@pytest.mark.parametrize("kind", sorted(ZERO_WIDTH))
def test_zero_width_attributes(kind):
    """m_i = 0 or m_f = 0: the reference's interpret mode raises there, so
    the plain versions are held to its jnp paths."""
    schema_kw, pool = ZERO_WIDTH[kind]
    c = _case(600, 16, 5, seed=3, schema_kw=schema_kw, pool=pool)
    padded = r_prefbf.pad_db(c["vecs"], c["norms"], c["ints"], c["floats"], 256)
    rid, rd = r_prefbf.prefbf_topk(*(jnp.asarray(a) for a in padded),
                                   jnp.asarray(c["qs"]), c["rprog"], k=10,
                                   chunk=256)
    pt = [torch.as_tensor(a) for a in padded]
    kid, kd = p_ft.filtered_topk(*pt, torch.as_tensor(c["qs"]), c["pprog"],
                                 k=10, chunk=256)
    _assert_bar(rid, rd, kid, kd)
    nbrs = c["rng"].integers(-1, 600, size=(5, 12)).astype(np.int32)
    dvec = np.full((5,), 0.3, np.float32)
    rdb, rtd = r_gd_ref.gather_distance_ref(jnp.asarray(nbrs), *_j(c)[4:],
                                            *_j(c)[:4], c["rprog"],
                                            jnp.asarray(dvec))
    pdb, ptd = p_gd.gather_distance(*_t(c)[:4], torch.as_tensor(c["qs"]),
                                    torch.as_tensor(nbrs), c["pprog"],
                                    torch.as_tensor(dvec))
    rdb = np.where(np.asarray(rdb) >= 3.0e38, np.inf, np.asarray(rdb))
    np.testing.assert_allclose(pdb.numpy(), rdb, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ptd.numpy(), np.asarray(rtd).astype(bool))


# ---------------------------------------------------------------------------
# gather_distance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,d,b,m", [(300, 16, 4, 8), (600, 32, 6, 16),
                                     (128, 8, 3, 32)])
def test_gather_distance_plain_matches_pallas(n, d, b, m):
    c = _case(n, d, b, seed=n + m)
    nbrs = c["rng"].integers(-1, n, size=(b, m)).astype(np.int32)
    nbrs[:, 0] = -1                      # the -1 id path in every case
    dvec = c["rng"].uniform(0.0, 1.0, size=(b,)).astype(np.float32)
    valid = np.ones((b,), bool)
    valid[-1] = False
    rd, rtd = r_gd.gather_distance(*_j(c)[:4], jnp.asarray(c["qs"]),
                                   jnp.asarray(nbrs), c["rprog"],
                                   jnp.asarray(dvec), interpret=True,
                                   valid=jnp.asarray(valid))
    pd, ptd = p_gd.gather_distance(*_t(c)[:4], torch.as_tensor(c["qs"]),
                                   torch.as_tensor(nbrs), c["pprog"],
                                   torch.as_tensor(dvec),
                                   valid=torch.as_tensor(valid))
    assert pd.dtype == torch.float32 and ptd.dtype == torch.bool
    assert torch.isinf(pd[:, 0]).all() and not ptd[:, 0].any()
    assert torch.isinf(pd[-1]).all() and not ptd[-1].any()
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ptd.numpy(), np.asarray(rtd))


# ---------------------------------------------------------------------------
# embedding_bag: the cases of tests/test_kernels.py's sweep
# ---------------------------------------------------------------------------
def _bag_case(v, d, b, l):
    """Table and bags drawn as ``test_embedding_bag_sweep`` draws them."""
    rng = np.random.default_rng(v + l)
    table = rng.normal(size=(v, d)).astype(np.float32)
    bags = rng.integers(0, v, size=(b, l)).astype(np.int32)
    for i in range(b):
        bags[i, rng.integers(1, l + 1):] = -1     # random -1 padding tail
    return table, bags


EB_CASES = [(100, 16, 8, 4, "sum"), (100, 16, 8, 4, "mean"),
            (1000, 32, 4, 10, "sum"), (50, 8, 16, 1, "mean"),
            (257, 64, 3, 7, "sum")]


@pytest.mark.parametrize("v,d,b,l,mode", EB_CASES)
def test_embedding_bag_plain_matches_pallas(v, d, b, l, mode):
    """Bit for bit against the Pallas kernel in interpret mode, and at the
    reference's 1e-5 against its jnp oracle (``jnp.sum`` adds in another
    order)."""
    table, bags = _bag_case(v, d, b, l)
    pal = np.asarray(r_eb.embedding_bag(jnp.asarray(table), jnp.asarray(bags),
                                        mode=mode, interpret=True))
    got = p_eb.embedding_bag(torch.as_tensor(table), torch.as_tensor(bags),
                             mode=mode).numpy()
    np.testing.assert_array_equal(got, pal)
    ref = np.asarray(r_eb_ref.embedding_bag_ref(jnp.asarray(bags),
                                                jnp.asarray(table), mode=mode))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_all_padding(mode):
    table = np.ones((10, 4), np.float32)
    bags = np.full((2, 3), -1, np.int32)
    pal = np.asarray(r_eb.embedding_bag(jnp.asarray(table), jnp.asarray(bags),
                                        mode=mode, interpret=True))
    got = p_eb.embedding_bag(torch.as_tensor(table), torch.as_tensor(bags),
                             mode=mode).numpy()
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, 0.0)


def test_embedding_bag_input_checks():
    table = torch.zeros((10, 4))
    bags = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        p_eb.embedding_bag(table, bags, mode="max")
    with pytest.raises(ValueError, match="dtype"):
        p_eb.embedding_bag(table, bags.long())
    with pytest.raises(ValueError, match="dtype"):
        p_eb.embedding_bag(table.double(), bags)
    with pytest.raises(ValueError, match="shape"):
        p_eb.embedding_bag(table, bags[0])
    with pytest.raises(ValueError, match="contiguous"):
        p_eb.embedding_bag(torch.zeros((4, 10)).t(), bags)
    with pytest.raises(ValueError, match="expected"):
        p_eb.embedding_bag(table, bags.to("meta"))
