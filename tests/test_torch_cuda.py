"""The CUDA kernels against their plain versions, on the card only (marked
``cuda``; they skip without a CUDA device).  No JAX here: this file runs on
a machine with a card and the port alone.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bar: distances rtol/atol 1e-5, ids equal outside ties, TD bits equal.  The
f32 kernels' d-long dot is one FMA chain and the plain version's a cuBLAS
or tree reduction, so the two differ only in the last bits of the squared
distance; the PQ kernels and their plain versions add the same LUT entries
in the same subspace order, and ``embedding_bag`` and its plain version the
same rows in the same bag order, so they agree bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core import prefbf  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402
from repro_torch.kernels import _common as KC  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb  # noqa: E402
from repro_torch.kernels.filtered_topk import ops as ft  # noqa: E402
from repro_torch.kernels.gather_distance import ops as gd  # noqa: E402
from repro_torch.kernels.pq_adc import ops as pq  # noqa: E402
from repro_torch.parity import tie_free, topk_mismatch  # noqa: E402

TOL = 1e-5
# the tests this process ran, in order (a failure report names them)
_ORDER: list = []


@pytest.fixture(autouse=True)
def _record_order(request):
    _ORDER.append(request.node.name)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    K.build_kernels()
    return torch.device("cuda")


def _case(dev, n, d, b, seed, pad_to=None, schema_kw=None):
    rng = np.random.default_rng(seed)
    schema = PF.paper_schema(**(schema_kw or {}))
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    attrs = PF.random_attributes(schema, n, seed=seed + 1)
    db = (vecs, norms, attrs.ints, attrs.floats)
    if pad_to:
        db = prefbf.pad_db(*db, pad_to)
    db = [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in db]
    pool = ([PF.Equality("b0", True), PF.Range("f0", 10.0, 60.0),
             PF.Not(PF.Range("f0", 30.0, 80.0)), PF.TrueFilter(),
             PF.And(PF.Equality("i0", 3), PF.Range("f0", 10, 12)),
             PF.Inclusion("i0", [1, 5, 9])] if not schema_kw else
            [PF.TrueFilter(), PF.Range("f0", 20.0, 70.0)
             if schema.float_columns else PF.Equality("b0", True)])
    progs = compile_programs([pool[i % len(pool)] for i in range(b)], schema,
                             b, device=dev)
    qs = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                         device=dev)
    return db, qs, progs, rng


@pytest.mark.cuda
@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("n,d,b,k,pad", [(5000, 128, 300, 10, 8192),
                                         (777, 20, 37, 33, None),
                                         (50, 16, 3, 48, 64),  # k = KMAX
                                         (600, 19, 9, 12, None),
                                         (2000, 301, 130, 10, None)])
def test_filtered_topk_kernel_matches_plain(dev, n, d, b, k, pad, exclude):
    db, qs, progs, rng = _case(dev, n, d, b, seed=n, pad_to=pad)
    dvec = torch.as_tensor(rng.uniform(0.1, 2.0, size=b).astype(np.float32),
                           device=dev)
    valid = torch.ones(b, dtype=torch.bool, device=dev)
    valid[0] = False
    before = K.launch_counts["filtered_topk"]
    kid, kd = ft.filtered_topk(*db, qs, progs, k=k, dvec=dvec,
                               exclude=exclude, valid=valid)
    torch.cuda.synchronize()
    assert K.launch_counts["filtered_topk"] == before + 1
    pid, pd = ft.filtered_topk_plain(*db, qs, progs, k=k, dvec=dvec,
                                     exclude=exclude, valid=valid)
    m = topk_mismatch(pid.cpu().numpy(), pd.cpu().numpy(), kid.cpu().numpy(),
                      kd.cpu().numpy(), rtol=TOL, atol=TOL)
    assert m["dist_mismatch"] == 0 and m["id_mismatch"] == 0, m
    assert int(kid.max()) < n                   # pad rows never returned
    assert (kid[0] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("schema_kw", [dict(n_float=0, n_int=0),
                                       dict(n_bool=0, n_int=0)])
def test_kernels_zero_width_attributes(dev, schema_kw):
    db, qs, progs, rng = _case(dev, 900, 32, 9, seed=4, schema_kw=schema_kw)
    kid, kd = ft.filtered_topk(*db, qs, progs, k=10)
    pid, pd = ft.filtered_topk_plain(*db, qs, progs, k=10)
    m = topk_mismatch(pid.cpu().numpy(), pd.cpu().numpy(), kid.cpu().numpy(),
                      kd.cpu().numpy(), rtol=TOL, atol=TOL)
    assert m["dist_mismatch"] == 0 and m["id_mismatch"] == 0, m
    ids = torch.as_tensor(rng.integers(-1, 900, size=(9, 12)),
                          dtype=torch.int32, device=dev)
    dvec = torch.full((9,), 0.5, device=dev)
    a, ta = gd.gather_distance(*db, qs, ids, progs, dvec)
    b, tb = gd.gather_distance_plain(*db, qs, ids, progs, dvec)
    torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    assert torch.equal(ta, tb)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b,m", [(5000, 128, 256, 32), (300, 19, 5, 7)])
def test_gather_distance_kernel_matches_plain(dev, n, d, b, m):
    db, qs, progs, rng = _case(dev, n, d, b, seed=n + 1)
    ids = torch.as_tensor(rng.integers(-1, n, size=(b, m)),
                          dtype=torch.int32, device=dev)
    dvec = torch.full((b,), 0.4, device=dev)
    before = K.launch_counts["gather_distance"]
    kd, ktd = gd.gather_distance(*db, qs, ids, progs, dvec)
    assert K.launch_counts["gather_distance"] == before + 1
    pd, ptd = gd.gather_distance_plain(*db, qs, ids, progs, dvec)
    torch.testing.assert_close(kd, pd, rtol=TOL, atol=TOL)
    assert torch.equal(ktd, ptd)
    # batch-width independence: a sub-batch gives the same bits
    kd2, _ = gd.gather_distance(*db, qs[:2].contiguous(), ids[:2].contiguous(),
                                {k: x[:2].contiguous()
                                 for k, x in progs.items()}, dvec[:2])
    assert torch.equal(kd2, kd[:2])


def _ft_both(dev, db, qs, progs, k, exclude, dvec, **kw):
    """(kernel ids, dists), (plain ids, dists) and their mismatch count."""
    got = ft.filtered_topk(*db, qs, progs, k=k, dvec=dvec, exclude=exclude,
                           **kw)
    want = ft.filtered_topk_plain(*db, qs, progs, k=k, dvec=dvec,
                                  exclude=exclude, **kw)
    m = topk_mismatch(want[0].cpu().numpy(), want[1].cpu().numpy(),
                      got[0].cpu().numpy(), got[1].cpu().numpy(), rtol=TOL,
                      atol=TOL)
    return got, want, m


@pytest.mark.cuda
@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("k", [49, 65, 100, 256, 1000])
def test_filtered_topk_large_k_matches_plain(dev, k, exclude):
    """k above the kernel's list length (48): chained passes, each after
    the last pair of the one before, equal the plain version's one pass."""
    db, qs, progs, rng = _case(dev, 6000, 128, 40, seed=k, pad_to=8192)
    dvec = torch.as_tensor(rng.uniform(0.1, 2.0, size=40).astype(np.float32),
                           device=dev)
    lib = K.library("filtered_topk")
    passes = -(-k // lib.filtered_topk_max_k())
    before = K.launch_counts["filtered_topk"]
    (kid, kd), (pid, pd), m = _ft_both(dev, db, qs, progs, k, exclude, dvec)
    assert K.launch_counts["filtered_topk"] - before <= passes
    assert kid.shape == (40, k)
    assert m["dist_mismatch"] == 0 and m["id_mismatch"] == 0, m
    assert int(kid.max()) < 6000


@pytest.mark.cuda
@pytest.mark.parametrize("exclude", [False, True])
def test_filtered_topk_bits_do_not_depend_on_batch_width(dev, exclude):
    """One query's ids and distances are the same bits in a batch of 1, 8 or
    1024: every returned distance is the per-pair f32 chain."""
    db, qs, progs, rng = _case(dev, 60000, 128, 1024, seed=11, pad_to=8192)
    dvec = torch.as_tensor(rng.uniform(0.1, 2.0, size=1024).astype(
        np.float32), device=dev)
    full = ft.filtered_topk(*db, qs, progs, k=10, dvec=dvec, exclude=exclude)
    for lo, width in ((517, 1), (300, 8)):
        sl = slice(lo, lo + width)
        part = ft.filtered_topk(*db, qs[sl].clone(),
                                {k: v[sl].clone() for k, v in progs.items()},
                                k=10, dvec=dvec[sl].clone(), exclude=exclude)
        assert torch.equal(part[0], full[0][sl])
        assert torch.equal(part[1], full[1][sl])


@pytest.mark.cuda
@pytest.mark.parametrize("exclude", [False, True])
def test_filtered_topk_low_selectivity_and_pad_tail(dev, exclude):
    """Under a < 1 % filter (the screen passes the most pairs there) and with
    a DB whose last splits hold only pad rows, the kernel equals the plain
    version and never returns a pad row."""
    rng = np.random.default_rng(12)
    n, d, b = 3000, 128, 64
    schema = PF.paper_schema()
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    attrs = PF.random_attributes(schema, n, seed=13)
    db = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
          for a in prefbf.pad_db(vecs, norms, attrs.ints, attrs.floats,
                                 32768)]
    tiny = PF.And(PF.Equality("i0", 3), PF.Range("f0", 10, 12))
    flts = [tiny if i % 2 else PF.TrueFilter() for i in range(b)]
    progs = compile_programs(flts, schema, b, device=dev)
    qs = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                         device=dev)
    dvec = torch.full((b,), 0.7, device=dev)
    counts = torch.zeros(b, dtype=torch.int32, device=dev)
    exact = torch.zeros(b, dtype=torch.int32, device=dev)
    (kid, kd), _, m = _ft_both(dev, db, qs, progs, 10, exclude, dvec)
    assert m["dist_mismatch"] == 0 and m["id_mismatch"] == 0, m
    assert int(kid.max()) < n
    ft.filtered_topk(*db, qs, progs, k=10, dvec=dvec, exclude=exclude,
                     screen_counts=counts, rescore_counts=exact)
    assert int(counts.min()) >= 10          # every list filled at least once
    assert int(counts.max()) <= n           # pad rows never pass the screen
    assert bool((exact <= counts).all())    # re-scores are screened pairs
    assert int(exact[(kd[:, -1] < 1e30)].min()) >= 10  # each returned pair


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(dev):
    db, qs, progs, _ = _case(dev, 100, 16, 4, seed=1)
    with pytest.raises(ValueError, match="dtype"):
        ft.filtered_topk(db[0].double(), *db[1:], qs, progs, k=5)
    with pytest.raises(ValueError, match="contiguous"):
        ft.filtered_topk(*db, qs.t().contiguous().t(), progs, k=5)
    with pytest.raises(ValueError, match="k=0"):
        ft.filtered_topk(*db, qs, progs, k=0)
    with pytest.raises(ValueError, match="expected cuda"):
        gd.gather_distance(*db, qs, torch.zeros((4, 3), dtype=torch.int32),
                           progs, torch.zeros(4, device=dev))


# ---------------------------------------------------------------------------
# the graph route's gathers at every width the traversal launches
# ---------------------------------------------------------------------------
def _count_ops(fn):
    """(result, number of torch operators ``fn()`` dispatched)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        out = fn()
    return out, c.n


# (schema, program width W): the paper schema at W = 8 and W = 1, no int
# columns (m_i = 0) and no float column (m_f = 0)
GATHER_SCHEMAS = {"paper_w8": (None, 8), "paper_w1": (None, 1),
                  "no_ints_w8": (dict(n_bool=0, n_int=0), 8),
                  "no_floats_w1": (dict(n_float=0), 1)}


def _gather_inputs(dev, n, b, m, seed, schema="paper_w8", d=128):
    """A DB whose last rows are padding (NaN floats, -1 ints), ids with
    about 10 % -1, D = +inf on every fifth query, a lane mask with every
    fourth query dead, and one filter program per query of width W."""
    schema_kw, width = GATHER_SCHEMAS[schema]
    rng = np.random.default_rng(seed)
    sch = PF.paper_schema(**(schema_kw or {}))
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    attrs = PF.random_attributes(sch, n, seed=seed + 1)
    ints, floats = attrs.ints.copy(), attrs.floats.copy()
    ints[-n // 10:] = -1
    floats[-n // 10:] = np.nan
    pool = [PF.TrueFilter()]
    if sch.float_columns:
        pool.append(PF.Range("f0", 20.0, 70.0))
    if any(c.kind == "bool" for c in sch.int_columns):
        pool.append(PF.Equality("b0", True))
    if any(c.kind == "int" for c in sch.int_columns):
        pool.append(PF.Inclusion("i0", [1, 5, 9]))
    if width > 1 and sch.float_columns:
        pool.append(PF.Not(PF.Range("f0", 30.0, 80.0)))   # two disjuncts
    progs = compile_programs([pool[i % len(pool)] for i in range(b)], sch,
                             b, width, device=dev)
    ids = rng.integers(0, n, size=(b, m))
    ids[rng.random((b, m)) < 0.1] = -1
    dvec = rng.uniform(0.1, 2.0, size=b).astype(np.float32)
    dvec[::5] = np.inf
    valid = np.ones(b, bool)
    valid[3::4] = False
    t = lambda a, **kw: torch.as_tensor(a, device=dev, **kw)  # noqa: E731
    return dict(db=(t(vecs), t(norms), t(ints), t(floats)), progs=progs,
                qs=t(rng.normal(size=(b, d)).astype(np.float32)),
                ids=t(ids, dtype=torch.int64), dvec=t(dvec), valid=t(valid),
                rng=rng)


@pytest.mark.cuda
@pytest.mark.parametrize("schema", sorted(GATHER_SCHEMAS))
@pytest.mark.parametrize("b,m", [(b, m) for b in (1, 3, 1024)
                                 for m in (1, 16, 32)])
def test_gather_distance_every_width_matches_plain(dev, b, m, schema):
    c = _gather_inputs(dev, 4000, b, m, seed=b * 100 + m, schema=schema)
    db, qs, progs, dvec = c["db"], c["qs"], c["progs"], c["dvec"]
    pd, ptd = gd.gather_distance_plain(*db, qs, c["ids"], progs, dvec,
                                       valid=c["valid"])
    for ids in (c["ids"], c["ids"].to(torch.int32)):
        before = K.launch_counts["gather_distance"]
        (kd, ktd), ops = _count_ops(lambda: gd.gather_distance(
            *db, qs, ids, progs, dvec, valid=c["valid"]))
        torch.cuda.synchronize()
        assert K.launch_counts["gather_distance"] == before + 1
        assert ops == 2                        # the two output allocations
        assert kd.dtype == torch.float32 and ktd.dtype == torch.bool
        assert torch.equal(torch.isinf(kd), torch.isinf(pd))
        torch.testing.assert_close(kd, pd, rtol=TOL, atol=TOL)
        assert torch.equal(ktd, ptd)
        assert torch.isinf(kd[~c["valid"]]).all()
        assert not ktd[~c["valid"]].any()
    # the traversal's call: no mask; a query's bits do not depend on its
    # block mates (one query alone, the first query of a wider batch)
    full, _ = gd.gather_distance(*db, qs, c["ids"], progs, dvec)
    one, _ = gd.gather_distance(
        *db, qs[-1:].clone(), c["ids"][-1:].clone(),
        {k: v[-1:].clone() for k, v in progs.items()}, dvec[-1:].clone())
    assert torch.equal(one, full[-1:])


@pytest.mark.cuda
@pytest.mark.parametrize("d,b,m", [(512, 9, 32),    # staged, opt-in memory
                                   (2048, 3, 40),   # rows too wide to stage
                                   (20, 5, 33),     # staged, two tiles
                                   (19, 4, 64)])    # scalar rows, two tiles
def test_gather_distance_row_widths_and_tiles(dev, d, b, m):
    c = _gather_inputs(dev, 800, b, m, seed=d + m, d=d)
    args = (*c["db"], c["qs"], c["ids"], c["progs"], c["dvec"])
    kd, ktd = gd.gather_distance(*args, valid=c["valid"])
    pd, ptd = gd.gather_distance_plain(*args, valid=c["valid"])
    assert torch.equal(torch.isinf(kd), torch.isinf(pd))
    torch.testing.assert_close(kd, pd, rtol=TOL, atol=TOL)
    assert torch.equal(ktd, ptd)


@pytest.mark.cuda
@pytest.mark.parametrize("schema", ["paper_w8", "no_ints_w8",
                                    "no_floats_w1"])
@pytest.mark.parametrize("lut_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,m0", [(b, m) for b in (1, 3, 1024)
                                  for m in (1, 16, 32)])
def test_pq_adc_gather_every_width_matches_plain(dev, b, m0, lut_dtype,
                                                 schema):
    """Bit for bit in both modes, int32 and int64 ids, at M = 32 x K = 256
    (bf16: the fixed instantiation; f32: the generic one)."""
    n = 4000
    c = _gather_inputs(dev, n, b, m0, seed=b * 10 + m0, schema=schema, d=8)
    _, _, ints, floats = c["db"]
    rng = c["rng"]
    codes = torch.as_tensor(rng.integers(0, 256, size=(n, 32)),
                            dtype=torch.uint8, device=dev)
    luts = torch.as_tensor(rng.uniform(0, 4.0, size=(b, 32, 256)),
                           dtype=torch.float32, device=dev).to(lut_dtype)
    kw = dict(ints=ints, floats=floats, programs=c["progs"], dvec=c["dvec"])
    pa = pq.pq_adc_gather_plain(codes, luts, c["ids"], valid=c["valid"])
    pd, ptd = pq.pq_adc_gather_plain(codes, luts, c["ids"], valid=c["valid"],
                                     **kw)
    for ids in (c["ids"], c["ids"].to(torch.int32)):
        before = K.launch_counts["pq_adc_gather"]
        ka, ops_a = _count_ops(lambda: pq.pq_adc_gather(
            codes, luts, ids, valid=c["valid"]))
        (kd, ktd), ops_f = _count_ops(lambda: pq.pq_adc_gather(
            codes, luts, ids, valid=c["valid"], **kw))
        torch.cuda.synchronize()
        assert K.launch_counts["pq_adc_gather"] == before + 2
        assert (ops_a, ops_f) == (1, 2)        # the output allocations
        assert torch.equal(ka, pa)
        assert torch.equal(kd, pd) and torch.equal(ktd, ptd)
        assert ktd.dtype == torch.bool
        assert torch.isinf(kd[~c["valid"]]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m,nbits", [(8, 6), (30, 8), (64, 4)])
def test_pq_adc_gather_generic_tables(dev, m, nbits):
    """M and K other than 32 x 256 (the generic instantiation), f32 and
    bf16 tables, int64 ids, both modes, bit for bit."""
    n, b, m0 = 3000, 40, 32
    c = _gather_inputs(dev, n, b, m0, seed=m, d=8)
    _, _, ints, floats = c["db"]
    codes = torch.as_tensor(c["rng"].integers(0, 1 << nbits, size=(n, m)),
                            dtype=torch.uint8, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        luts = torch.as_tensor(c["rng"].uniform(0, 4.0, size=(b, m, 1 << nbits)),
                               dtype=torch.float32, device=dev).to(dt)
        kw = dict(ints=ints, floats=floats, programs=c["progs"],
                  dvec=c["dvec"], valid=c["valid"])
        assert torch.equal(pq.pq_adc_gather(codes, luts, c["ids"]),
                           pq.pq_adc_gather_plain(codes, luts, c["ids"]))
        kd, ktd = pq.pq_adc_gather(codes, luts, c["ids"], **kw)
        pd, ptd = pq.pq_adc_gather_plain(codes, luts, c["ids"], **kw)
        assert torch.equal(kd, pd) and torch.equal(ktd, ptd)


@pytest.mark.cuda
def test_gather_launch_widths_are_counted(dev):
    c = _gather_inputs(dev, 500, 6, 16, seed=3)
    K.reset_launch_counts()
    for m in (16, 16, 1):
        ids = c["ids"][:, :m].contiguous()
        gd.gather_distance(*c["db"], c["qs"], ids, c["progs"], c["dvec"])
    assert K.launch_widths["gather_distance"] == {(6, 16): 2, (6, 1): 1}
    assert K.launch_counts["gather_distance"] == 3


# ---------------------------------------------------------------------------
# pq_adc_topr / pq_adc_gather
# ---------------------------------------------------------------------------
def _pq_case(dev, n, b, m, nbits, seed, n_pad=0, schema_kw=None,
             lut_dtype=torch.float32):
    db, _, progs, rng = _case(dev, n, 8, b, seed, schema_kw=schema_kw)
    _, norms, ints, floats = db
    if n_pad:
        norms[-n_pad:] = float("inf")
        ints[-n_pad:] = -1
        floats[-n_pad:] = float("nan")
    ksub = 1 << nbits
    codes = torch.as_tensor(rng.integers(0, ksub, size=(n, m)),
                            dtype=torch.uint8, device=dev)
    luts = torch.as_tensor(rng.uniform(0, 4.0, size=(b, m, ksub)),
                           dtype=torch.float32, device=dev).to(lut_dtype)
    return codes, norms, ints, floats, luts, progs, rng


@pytest.mark.cuda
@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,b,m,nbits,r,n_pad", [
    (5000, 37, 8, 6, 40, 100),        # CPU-test widths, pad rows
    (200_000, 64, 32, 8, 80, 0),      # favor-anns widths: 16-query tiles
    (3000, 5, 64, 8, 20, 0),          # 8-query tile of 16 KB tables
    (777, 9, 6, 5, 33, 0),            # M not a multiple of 4 (byte path)
    (40_000, 21, 30, 8, 80, 64),      # M = 30: bytes; B not a tile multiple
    (9000, 3, 240, 4, 16, 0),         # M = 240 x K = 16: 4-query table
])
def test_pq_adc_topr_kernel_matches_plain(dev, n, b, m, nbits, r, n_pad,
                                          lut_dtype):
    codes, norms, ints, floats, luts, progs, _ = _pq_case(
        dev, n, b, m, nbits, seed=n + m, n_pad=n_pad, lut_dtype=lut_dtype)
    valid = torch.ones(b, dtype=torch.bool, device=dev)
    valid[0] = False
    before = K.launch_counts["pq_adc_topr"]
    kid, kd = pq.pq_adc_topr(codes, norms, ints, floats, luts, progs, r=r,
                             valid=valid)
    torch.cuda.synchronize()
    assert K.launch_counts["pq_adc_topr"] == before + 1
    pid, pd = pq.pq_adc_topr_plain(codes, norms, ints, floats, luts, progs,
                                   r=r, valid=valid)
    m_ = topk_mismatch(pid.cpu().numpy(), pd.cpu().numpy(),
                       kid.cpu().numpy(), kd.cpu().numpy(), rtol=TOL,
                       atol=TOL)
    assert m_["dist_mismatch"] == 0 and m_["id_mismatch"] == 0, m_
    assert torch.equal(kd, pd)                     # same sum order
    assert int(kid.max()) < n - n_pad              # pad rows never returned
    assert (kid[0] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lut_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,b,m0,m,nbits", [(5000, 256, 32, 32, 8),
                                            (300, 5, 7, 6, 5)])
def test_pq_adc_gather_kernel_matches_plain(dev, n, b, m0, m, nbits,
                                            lut_dtype):
    codes, _, ints, floats, luts, progs, rng = _pq_case(
        dev, n, b, m, nbits, seed=n + m0, lut_dtype=lut_dtype)
    ids = torch.as_tensor(rng.integers(-1, n, size=(b, m0)),
                          dtype=torch.int32, device=dev)
    dvec = torch.full((b,), 0.4, device=dev)
    valid = torch.ones(b, dtype=torch.bool, device=dev)
    valid[-1] = False
    before = K.launch_counts["pq_adc_gather"]
    ka = pq.pq_adc_gather(codes, luts, ids, valid=valid)
    kd, ktd = pq.pq_adc_gather(codes, luts, ids, ints=ints, floats=floats,
                               programs=progs, dvec=dvec)
    torch.cuda.synchronize()
    assert K.launch_counts["pq_adc_gather"] == before + 2
    pa = pq.pq_adc_gather_plain(codes, luts, ids, valid=valid)
    pd, ptd = pq.pq_adc_gather_plain(codes, luts, ids, ints=ints,
                                     floats=floats, programs=progs, dvec=dvec)
    torch.testing.assert_close(ka, pa, rtol=TOL, atol=TOL)
    assert torch.equal(ka, pa) and torch.isinf(ka[-1]).all()
    torch.testing.assert_close(kd, pd, rtol=TOL, atol=TOL)
    assert torch.equal(ktd, ptd)
    # batch-width independence: a sub-batch gives the same bits
    kd2, _ = pq.pq_adc_gather(codes, luts[:2].contiguous(),
                              ids[:2].contiguous(), ints=ints, floats=floats,
                              programs={k: x[:2].contiguous()
                                        for k, x in progs.items()},
                              dvec=dvec[:2])
    assert torch.equal(kd2, kd[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("schema_kw", [dict(n_float=0, n_int=0),
                                       dict(n_bool=0, n_int=0)])
def test_pq_kernels_zero_width_attributes(dev, schema_kw):
    codes, norms, ints, floats, luts, progs, rng = _pq_case(
        dev, 900, 9, 8, 6, seed=5, schema_kw=schema_kw)
    kid, kd = pq.pq_adc_topr(codes, norms, ints, floats, luts, progs, r=20)
    pid, pd = pq.pq_adc_topr_plain(codes, norms, ints, floats, luts, progs,
                                   r=20)
    assert torch.equal(kid, pid) and torch.equal(kd, pd)
    ids = torch.as_tensor(rng.integers(-1, 900, size=(9, 12)),
                          dtype=torch.int32, device=dev)
    dvec = torch.full((9,), 0.5, device=dev)
    a, ta = pq.pq_adc_gather(codes, luts, ids, ints=ints, floats=floats,
                             programs=progs, dvec=dvec)
    b, tb = pq.pq_adc_gather_plain(codes, luts, ids, ints=ints, floats=floats,
                                   programs=progs, dvec=dvec)
    assert torch.equal(a, b) and torch.equal(ta, tb)


@pytest.mark.cuda
@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,b,m,r", [
    (20000, 6, 8, 1025),        # R above the longest list: chained passes
    (20000, 4, 32, 1600),       # favor-anns' M at R = 1600
    (20000, 19, 32, 1024),      # the longest list in one pass
    (3000, 5, 240, 80),         # M = 240 x K = 256: the no-table scan
    (3000, 3, 240, 1600),       # both
])
def test_pq_adc_topr_long_lists_and_wide_luts(dev, n, b, m, r, lut_dtype):
    codes, norms, ints, floats, luts, progs, _ = _pq_case(
        dev, n, b, m, 8, seed=n + m + r, n_pad=50, lut_dtype=lut_dtype)
    kid, kd = pq.pq_adc_topr(codes, norms, ints, floats, luts, progs, r=r)
    pid, pd = pq.pq_adc_topr_plain(codes, norms, ints, floats, luts, progs,
                                   r=r)
    assert torch.equal(kid, pid) and torch.equal(kd, pd)
    assert int(kid.max()) < n - 50


def _screen_tables(kind, b, m, ksub, rng):
    """The LUTs of tests/test_torch_pq_screen.py's cases."""
    luts = rng.uniform(0.0, 4.0, size=(b, m, ksub))
    if kind == "wide_subspace":         # one range 10^4 times the others
        luts[:, m // 2] *= 1e4
    elif kind == "flat":                # every entry equal: D = 0
        luts[:] = rng.uniform(0.5, 2.0, size=(b, 1, 1))
    elif kind == "negative":
        luts -= 3.0
    elif kind == "offset":              # f32 chain error >> the step D
        luts = 1e5 + luts * 0.25
    elif kind == "nonfinite":           # +inf and nan entries: unscreened
        luts[0, 1, 3] = np.inf
        luts[1, 0, 0] = np.nan
    return luts.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,m,ksub", [
    ("random", 32, 256), ("random", 8, 16), ("random", 30, 256),
    ("random", 64, 16), ("random", 240, 16), ("random", 240, 256),
    ("wide_subspace", 32, 256), ("flat", 32, 256), ("offset", 32, 256),
    ("negative", 30, 16), ("nonfinite", 32, 256)])
def test_pq_adc_topr_screen_tables_match_plain(dev, kind, m, ksub,
                                               lut_dtype):
    """The 8-bit screen's hard tables (the CPU emulation's cases) at 30,000
    rows and 21 queries, with pad rows, a valid mask and filters from
    ``true`` to < 1 %: the kernel returns the plain version's bits, and
    its counters lie in their possible ranges."""
    n, b, r = 30_000, 21, 40
    codes, norms, ints, floats, _, progs, rng = _pq_case(
        dev, n, b, m, 8 if ksub == 256 else 4, seed=m + ksub, n_pad=64)
    luts = torch.as_tensor(_screen_tables(kind, b, m, ksub, rng),
                           device=dev).to(lut_dtype)
    valid = torch.ones(b, dtype=torch.bool, device=dev)
    valid[3] = False
    cands = torch.zeros(b, dtype=torch.int32, device=dev)
    exact = torch.zeros(b, dtype=torch.int32, device=dev)
    kid, kd = pq.pq_adc_topr(codes, norms, ints, floats, luts, progs, r=r,
                             valid=valid, screen_counts=cands,
                             rescore_counts=exact)
    pid, pd = pq.pq_adc_topr_plain(codes, norms, ints, floats, luts, progs,
                                   r=r, valid=valid)
    assert torch.equal(kid, pid) and torch.equal(kd, pd)
    assert int(kid.max()) < n - 64
    c, x = cands.cpu().numpy(), exact.cpu().numpy()
    assert (c <= n - 64).all() and (x <= c).all() and (c >= 1).all()
    if kind == "nonfinite":                  # unscreened: every live row
        assert (c[:2] == n - 64).all()
    if kind == "random" and ksub == 256 and m <= 32:
        # the screen does screen: `true` queries (every sixth, from the
        # fourth) see a few hundred candidates per split, not every row
        assert (c[3::6] < 0.25 * n).all()


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 80, 1024, 1600])
def test_pq_adc_topr_filters_and_list_lengths(dev, r):
    """favor-anns' widths (M = 32, K = 256, f32 LUTs from build_luts) over
    50,000 rows, 37 queries (not a multiple of the 16-query tile), the six
    filters of _case from ``true`` to < 1 %, and R from 1 to 1600."""
    from repro_torch.quant.adc import build_luts
    n, b = 50_000, 37
    db, qs, progs, rng = _case(dev, n, 32, b, seed=r, pad_to=n + 100)
    _, norms, ints, floats = db
    codes = torch.as_tensor(rng.integers(0, 256, size=(norms.shape[0], 32),
                                         dtype=np.uint8), device=dev)
    cents = torch.as_tensor(rng.normal(size=(32, 256, 1)).astype(np.float32),
                            device=dev)
    luts = build_luts(cents, qs)
    kid, kd = pq.pq_adc_topr(codes, norms, ints, floats, luts, progs, r=r)
    pid, pd = pq.pq_adc_topr_plain(codes, norms, ints, floats, luts, progs,
                                   r=r)
    assert torch.equal(kid, pid) and torch.equal(kd, pd)
    assert int(kid.max()) < n


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
def test_pq_adc_topr_query_tile_boundary(dev, width):
    """R swept across the list length at which the 16-query tile stops
    fitting one block's shared memory (dynamic layout plus the kernel's
    static arrays) at favor-anns' M = 32 x K = 256: every R runs, with the
    plain version's bits, and the sweep crosses from 16 to 8 queries."""
    n, b = 6000, 17
    db, _, _, rng = _case(dev, n, 32, b, seed=width)
    _, norms, ints, floats = db
    schema = PF.paper_schema()
    pool = [PF.TrueFilter(), PF.Range("f0", 10.0, 60.0),
            PF.Inclusion("i0", [1, 5, 9]), PF.Equality("b0", True)]
    progs = compile_programs([pool[i % len(pool)] for i in range(b)], schema,
                             b, width, device=dev)
    codes = torch.as_tensor(rng.integers(0, 256, size=(n, 32), dtype=np.uint8),
                            device=dev)
    luts = torch.as_tensor(rng.uniform(0, 4.0, size=(b, 32, 256)),
                           dtype=torch.float32, device=dev)
    tiles = set()
    for r in range(190, 207):
        tiles.add(pq._query_tile(pq._lib(), b, 32, 256, r,
                                 (width, ints.shape[1], floats.shape[1])))
        kid, kd = pq.pq_adc_topr(codes, norms, ints, floats, luts, progs, r=r)
        pid, pd = pq.pq_adc_topr_plain(codes, norms, ints, floats, luts,
                                       progs, r=r)
        assert torch.equal(kid, pid) and torch.equal(kd, pd), r
    assert tiles == {(16, True), (8, True)}, tiles


@pytest.mark.cuda
def test_pq_screen_constants_match_kernel(dev):
    """The wrapper's copies of the kernel's screen constants (levels per M,
    the query tiles) agree with the library's."""
    lib = pq._lib()
    for m in [*range(1, 1025), pq.QSUM_MAX, pq.QSUM_MAX + 1]:
        assert lib.pq_adc_screen_levels(m) == pq.screen_levels(m), m
    assert max(pq._SCREEN_TILES) == lib.pq_adc_max_qt()
    for qt in pq._SCREEN_TILES:
        assert lib.pq_adc_topr_smem_bytes(32, 256, 80, qt, 1, 8, 2, 1) \
            < lib.pq_adc_smem_limit()


@pytest.mark.cuda
@pytest.mark.parametrize("mi,mf", [(2, 1), (6, 0), (0, 5), (6, 6)])
def test_pq_precheck_is_necessary_for_the_filter(dev, mi, mf):
    """The scan's pre-check (favor::build_hull / may_pass) holds to the
    filter program (favor::eval_row) over random programs and rows: a row
    that passes the program always passes the pre-check.  The programs have
    up to 8 disjuncts, some dead, NaN and inverted intervals, and up to 6
    columns of each kind (more than the pre-check reads); the rows have
    ints outside [0, 32) and NaN / infinite floats.  eval_row also equals
    the plain evaluator."""
    rng = np.random.default_rng(7 * mi + mf)
    b, n, w = 96, 4000, 8
    valid = rng.choice([1.0, 1.0, 0.0, -1.0, np.nan], size=(b, w))
    # sparse masks, some full: a few allowed values per column
    imask = np.where(rng.random((b, w, mi)) < 0.1, (1 << 32) - 1,
                     rng.integers(0, 1 << 32, size=(b, w, mi))
                     & rng.integers(0, 1 << 32, size=(b, w, mi)))
    lo = rng.uniform(-50, 100, size=(b, w, mf))
    hi = lo + rng.uniform(-10, 60, size=(b, w, mf))
    lo[rng.random(lo.shape) < 0.05] = np.nan
    hi[rng.random(hi.shape) < 0.05] = -np.inf
    # every fourth query's first disjunct admits each row whose ints lie in
    # [0, 32) and whose floats are finite, so rows pass at any column count
    valid[::4, 0] = 1.0
    imask[::4, 0] = (1 << 32) - 1
    lo[::4, 0], hi[::4, 0] = -100.0, 200.0
    ints = rng.integers(-2, 36, size=(n, mi))
    floats = rng.uniform(-60, 160, size=(n, mf))
    floats[rng.random(floats.shape) < 0.02] = np.nan
    floats[rng.random(floats.shape) < 0.02] = np.inf
    progs = {"valid": torch.as_tensor(valid, dtype=torch.float32, device=dev),
             "imask": torch.as_tensor(imask, dtype=torch.int64, device=dev),
             "flo": torch.as_tensor(lo, dtype=torch.float32, device=dev),
             "fhi": torch.as_tensor(hi, dtype=torch.float32, device=dev)}
    ti = torch.as_tensor(ints, dtype=torch.int32, device=dev)
    tf = torch.as_tensor(floats, dtype=torch.float32, device=dev)
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    status = pq._lib().pq_adc_precheck_probe(
        *(KC.ptr(progs[k]) for k in ("valid", "imask", "flo", "fhi")),
        KC.ptr(ti), KC.ptr(tf), b, n, w, mi, mf, KC.ptr(out),
        KC.stream_ptr(dev))
    K.check_status("pq_adc_precheck_probe", status)
    passes, may = (out & 1).bool(), (out & 2).bool()
    assert torch.equal(passes, PF.eval_program_batched(progs, ti, tf))
    assert not (passes & ~may).any()
    assert passes.any() and (~may).any()         # neither side is trivial
    codes, norms, ints, floats, luts, progs, _ = _pq_case(dev, 100, 4, 8, 6,
                                                          seed=1)
    with pytest.raises(ValueError, match="dtype"):
        pq.pq_adc_topr(codes.int(), norms, ints, floats, luts, progs, r=5)
    with pytest.raises(ValueError, match="r=0"):
        pq.pq_adc_topr(codes, norms, ints, floats, luts, progs, r=0)
    with pytest.raises(ValueError, match="dtype"):
        pq.pq_adc_gather(codes, luts.double(),
                         torch.zeros((4, 3), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="expected cuda"):
        pq.pq_adc_gather(codes, luts, torch.zeros((4, 3), dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l", [(100000, 64, 4096, 32), (257, 6, 33, 7),
                                     (50, 8, 16, 1)])
def test_embedding_bag_kernel_matches_plain(dev, v, d, b, l, mode):
    rng = np.random.default_rng(v + l)
    table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32),
                            device=dev)
    bags = rng.integers(0, v, size=(b, l)).astype(np.int32)
    for i in range(b):
        bags[i, rng.integers(0, l + 1):] = -1     # all-pad bags included
    bags = torch.as_tensor(bags, device=dev)
    before = K.launch_counts["embedding_bag"]
    got = eb.embedding_bag(table, bags, mode=mode)
    torch.cuda.synchronize()
    assert K.launch_counts["embedding_bag"] == before + 1
    want = eb.embedding_bag_plain(table, bags, mode=mode)
    assert torch.equal(got, want)
    assert torch.equal(got[(bags < 0).all(dim=1)],
                       torch.zeros_like(got[(bags < 0).all(dim=1)]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,sub", [(300, [0, 5, 7, 299]), (37, [36]),
                                   (9, [0, 1, 2, 3, 4, 5, 6, 7, 8])])
def test_kernels_bits_do_not_depend_on_tile_mates(dev, b, sub):
    """Bucket padding's bar on the card: a query's ids and distances are the
    same bits whichever lanes share its tile (128-query tiles in
    ``filtered_topk``, 16-query tiles -- 4 or 8 for a small batch -- in
    ``pq_adc_topr``) and whatever pad lanes ride beside it."""
    from repro_torch.core.batching import BatchSpec, pad_to_bucket
    db, qs, progs, rng = _case(dev, 5000, 128, b, seed=b, pad_to=8192)
    idx = torch.as_tensor(sub, device=dev)
    sq = qs[idx].contiguous()
    sprogs = {k: v[idx].contiguous() for k, v in progs.items()}
    pq_, pp, _, valid = pad_to_bucket(BatchSpec(4, 512), sq, sprogs)
    codes = torch.as_tensor(rng.integers(0, 256, size=(db[0].shape[0], 32),
                                         dtype=np.uint8), device=dev)
    luts = torch.as_tensor(rng.uniform(0, 4, size=(b, 32, 256)).astype(
        np.float32), device=dev)
    slut = luts[idx].contiguous()
    plut = torch.cat([slut, slut.new_zeros((len(valid) - len(sub), 32,
                                            256))])
    for full, part, padded in (
            (ft.filtered_topk(*db, qs, progs, k=10),
             ft.filtered_topk(*db, sq, sprogs, k=10),
             ft.filtered_topk(*db, pq_, pp, k=10, valid=valid)),
            (pq.pq_adc_topr(codes, *db[1:], luts, progs, r=40),
             pq.pq_adc_topr(codes, *db[1:], slut, sprogs, r=40),
             pq.pq_adc_topr(codes, *db[1:], plut, pp, r=40, valid=valid))):
        for got in (part, padded):
            assert torch.equal(got[0][:len(sub)], full[0][idx])
            assert torch.equal(got[1][:len(sub)], full[1][idx])
        assert (padded[0][len(sub):] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3, 8, 200, 1024])
def test_plain_dots_do_not_depend_on_batch_width(dev, width):
    """``rows_mm`` (the SQ scan's and the plain brute version's dots) and
    ``build_luts`` on the card: a query's bits are the same in a batch of
    any width, and ``rows_mm`` broadcasts its right operand without
    copying it per block."""
    from repro_torch.kernels._common import rows_mm
    from repro_torch.quant.adc import build_luts
    rng = np.random.default_rng(width)
    qs = torch.as_tensor(rng.normal(size=(1024, 128)).astype(np.float32),
                         device=dev)
    db = torch.as_tensor(rng.normal(size=(8192, 128)).astype(np.float32),
                         device=dev)
    cents = torch.as_tensor(rng.normal(size=(32, 256, 4)).astype(np.float32),
                            device=dev)
    lo = int(rng.integers(0, 1025 - width))
    part = qs[lo:lo + width]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    full = rows_mm(qs, db)
    torch.cuda.synchronize()
    out_bytes = full.numel() * 4
    assert torch.cuda.max_memory_allocated(dev) - base < 2 * out_bytes
    assert torch.equal(rows_mm(part, db), full[lo:lo + width])
    assert torch.equal(build_luts(cents, part),
                       build_luts(cents, qs)[lo:lo + width])


@pytest.mark.cuda
def test_bucketing_and_live_index_on_card(dev):
    """End to end on the card at a small size: bucketed == unbucketed bit
    for bit on both routes, and the live index (delta scan on
    ``filtered_topk``, tombstones, the bulk merge's waves) never returns a
    deleted id and finds every upserted row under its positional id."""
    from repro_torch.core import BatchSpec, FavorIndex, HnswParams
    from repro_torch.core import SearchOptions
    rng = np.random.default_rng(5)
    n, d = 2000, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    schema = PF.paper_schema()
    attrs = PF.random_attributes(schema, n, seed=6)
    fi = FavorIndex.build(vecs, attrs, HnswParams(M=8, efc=48, seed=3))
    assert fi.device.type == "cuda"
    pool = [PF.Equality("b0", True), PF.Range("f0", 10.0, 60.0),
            PF.And(PF.Equality("i0", 3), PF.Range("f0", 10, 12))]
    qs = rng.normal(size=(37, d)).astype(np.float32)
    flts = [pool[i % 3] for i in range(37)]
    opts = SearchOptions(k=10, ef=64)
    a = fi.query(qs, flts, opts)
    b = fi.query(qs, flts, opts.with_(batch=BatchSpec(4, 64)))
    assert a.routed_brute.any() and (~a.routed_brute).any()
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)

    new = qs[:8] + 1e-3
    ids = fi.upsert(new, attrs.ints[:8], attrs.floats[:8],
                    replace=list(range(8)))
    assert ids.tolist() == list(range(n, n + 8))
    assert fi.delete([int(ids[0]), 9, 10]) == 3
    dead = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, int(ids[0])]
    before = dict(K.launch_counts)
    for force in ("graph", "brute"):
        r = fi.query(qs, flts, opts.with_(force=force))
        assert not np.isin(r.ids, dead).any(), force
        own = fi.query(new[1:], PF.TrueFilter(), opts.with_(force=force))
        assert (own.ids[:, 0] == ids[1:]).all(), force
    assert K.launch_counts["filtered_topk"] > before["filtered_topk"] + 2
    fi.merge(wave=64)
    assert fi.index.n == n + 8 and "alive" in fi.g
    for force in ("graph", "brute"):
        r = fi.query(qs, flts, opts.with_(force=force))
        assert not np.isin(r.ids, dead).any(), force
        own = fi.query(new[1:], PF.TrueFilter(), opts.with_(force=force))
        assert (own.ids[:, 0] == ids[1:]).all(), force


def _card_index(seed=5, n=2000, d=16, quant=False):
    from repro_torch.core import BuildSpec, FavorIndex, HnswParams, QuantSpec
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    attrs = PF.random_attributes(PF.paper_schema(), n, seed=seed + 1)
    spec = (BuildSpec(quant=QuantSpec(kind="pq", m=4, nbits=8,
                                      train_iters=5)) if quant else None)
    fi = FavorIndex.build(vecs, attrs, HnswParams(M=8, efc=48, seed=3),
                          spec)
    assert fi.device.type == "cuda"
    pool = [PF.Equality("b0", True), PF.Range("f0", 10.0, 60.0),
            PF.And(PF.Equality("i0", 3), PF.Range("f0", 10, 12))]
    qs = rng.normal(size=(48, d)).astype(np.float32)
    return fi, attrs, qs, [pool[i % 3] for i in range(len(qs))]


def _same_bits(a_ids, a_d, b_ids, b_d) -> bool:
    return (np.array_equal(a_ids, b_ids)
            and np.array_equal(np.asarray(a_d, np.float32).view(np.uint32),
                               np.asarray(b_d, np.float32).view(np.uint32)))


@pytest.mark.cuda
def test_engine_matches_query_on_card(dev):
    """ServeEngine on the card (the default device) returns
    ``FavorIndex.query``'s ids, distance bits, routes and p_hat for the
    same batches, through the kernels, with obs on and off."""
    from repro_torch.core import SearchOptions
    from repro_torch.core.options import ObsSpec
    from repro_torch.serving import ServeEngine
    fi, _, qs, flts = _card_index()
    opts = SearchOptions(k=10, ef=64)
    for obs in (ObsSpec(enabled=False),
                ObsSpec(trace_sample=1.0, probe_sample=1.0,
                        shadow_sample=1.0, kernel_annotations=True)):
        eng = ServeEngine(fi, opts, max_batch=16, max_wait_ms=0.0, obs=obs)
        assert eng.stats["scorers"]["use_pallas"] is True
        for i in range(len(qs)):
            eng.submit(qs[i], flts[i])
        K.reset_launch_counts()
        out = eng.run()
        assert K.launch_counts["filtered_topk"] > 0
        assert K.launch_counts["gather_distance"] > 0
        for lo in range(0, len(qs), 16):
            res = fi.query(qs[lo:lo + 16], flts[lo:lo + 16], opts)
            for i, r in enumerate(out[lo:lo + 16]):
                assert _same_bits(r.ids, r.dists, res.ids[i], res.dists[i])
                assert r.route == ("brute" if res.routed_brute[i]
                                   else "graph")
                assert r.p_hat == float(res.p_hat[i])
        assert {r.route for r in out} == {"graph", "brute"}
    from repro_torch.obs import profiling
    profiling.set_kernel_annotations(False)


@pytest.mark.cuda
def test_deferred_finish_from_other_thread_on_card(dev):
    """Two deferred batches on the card, finished in reverse order, one
    from another thread: the synchronous results, bit for bit."""
    import threading
    from repro_torch.core import SearchOptions, router
    fi, _, qs, flts = _card_index(seed=9)
    opts = SearchOptions(k=10, ef=64)
    halves = [(qs[:24], flts[:24]), (qs[24:], flts[24:])]
    sync = [fi.query(q, f, opts) for q, f in halves]
    pend = [router.execute(fi.backend, q, f, opts, defer=True)
            for q, f in halves]
    got = [None, None]

    def finish():
        got[0] = pend[0].finish()

    t = threading.Thread(target=finish)
    got[1] = pend[1].finish()
    t.start()
    t.join()
    assert pend[0].finish() is got[0]
    for g, s in zip(got, sync):
        assert _same_bits(g.ids, g.dists, s.ids, s.dists)
        assert np.array_equal(g.routed_brute, s.routed_brute)


@pytest.mark.cuda
def test_background_merge_on_card_equals_foreground(dev):
    """A background merge (worker thread, gather_distance waves on the
    card) while steps run: no deleted or replaced id ever returned, one
    commit, and the merged engine serves what a foreground merge of the
    same script serves, bit for bit."""
    import time
    from repro_torch.core import SearchOptions
    from repro_torch.serving import ServeEngine
    opts = SearchOptions(k=10, ef=64)
    script = []
    engines = []
    for background in (True, False):
        fi, attrs, qs, flts = _card_index(seed=13)
        new = qs[:32] + 1e-3
        eng = ServeEngine(fi, opts, max_batch=16, max_wait_ms=0.0,
                          merge_background=background,
                          merge_delta_frac=0.01 if background else None)
        ids = np.concatenate([
            eng.upsert(new[:24], attrs.ints[:24], attrs.floats[:24]),
            eng.upsert(new[24:], attrs.ints[24:32], attrs.floats[24:32],
                       replace=list(range(8)))])
        assert eng.delete([int(ids[0]), 9, 10]) == 3
        dead = list(range(8)) + [9, 10, int(ids[0])]
        if background:
            t0 = time.perf_counter()
            while (eng._merge_ctl.merges == 0
                   and time.perf_counter() - t0 < 120.0):
                for i in range(16):
                    eng.submit(qs[i], flts[i])
                for r in eng.run():
                    assert not np.isin(r.ids, dead).any()
            assert eng._merge_ctl.merges == 1
            eng.close()
        else:
            eng.merge(wave=512)
        assert eng.stats["mutations"]["delta_rows"] == 0
        for i in range(len(qs)):
            eng.submit(qs[i], flts[i])
        script.append(eng.run())
        engines.append(eng)
    for a, b in zip(*script, strict=True):
        assert _same_bits(a.ids, a.dists, b.ids, b.dists)
        assert not np.isin(a.ids, dead).any()


@pytest.mark.cuda
def test_batch_signatures_read_device_tensors(dev):
    """The router's program tensors on the card give the numpy programs'
    signatures (read through ``to_host``)."""
    schema = PF.paper_schema()
    flts = list(PF.paper_filters(schema).values())
    progs = compile_programs(flts, schema, len(flts), device=dev)
    assert progs["valid"].is_cuda
    stacked = PF.stack_programs([PF.compile_filter(f, schema) for f in flts])
    assert PF.batch_signatures(progs) == PF.batch_signatures(stacked)


@pytest.mark.cuda
@pytest.mark.parametrize("use_pq", [False, True])
def test_caching_backend_on_card(dev, use_pq):
    """CachingBackend over a CUDA LocalBackend.  The cold pass equals the
    uncached backend bit for bit (the miss sub-batches go back to the card:
    ``filtered_topk``, or ``pq_adc_topr`` under ``use_pq``); the warm pass
    is all semantic hits, launches nothing and returns the cold bits; on
    the f32 route the candidate layer admits the brute filter on its
    second miss (the cold pass was the first) and its block hits return
    the uncached ids (ties aside) and distances within 1e-5.  ``use_pq``
    bypasses the candidate layer."""
    from repro_torch.cache import CachingBackend
    from repro_torch.core import CacheSpec, SearchOptions, router
    from repro_torch.parity import topk_mismatch
    fi, _, qs, flts = _card_index(seed=21, quant=use_pq)
    opts = SearchOptions(k=10, ef=64, use_pq=use_pq)
    cb = CachingBackend(fi.backend, CacheSpec())
    assert cb.device == fi.backend.device and cb.device.type == "cuda"
    ref = router.execute(fi.backend, qs, flts, opts)
    K.reset_launch_counts()
    cold = router.execute(cb, qs, flts, opts)
    scan = "pq_adc_topr" if use_pq else "filtered_topk"
    assert K.launch_counts[scan] > 0 and K.launch_counts["gather_distance"] > 0
    assert _same_bits(cold.ids, cold.dists, ref.ids, ref.dists)
    assert np.array_equal(cold.routed_brute, ref.routed_brute)
    assert cold.routed_brute.any() and not cold.routed_brute.all()
    K.reset_launch_counts()
    warm = router.execute(cb, qs, flts, opts)
    assert sum(K.launch_counts.values()) == 0
    assert _same_bits(warm.ids, warm.dists, cold.ids, cold.dists)
    tiny = PF.And(PF.Equality("i0", 3), PF.Range("f0", 10, 12))
    brute = opts.with_(force="brute")
    rng = np.random.default_rng(77)
    for round_ in range(3):      # fresh queries: only candidate blocks hit
        q = rng.normal(size=(8, qs.shape[1])).astype(np.float32)
        rc = router.execute(cb, q, tiny, brute)
        rb = router.execute(fi.backend, q, tiny, brute)
        if use_pq or round_ == 0:
            assert _same_bits(rc.ids, rc.dists, rb.ids, rb.dists)
        else:
            mm = topk_mismatch(rb.ids, rb.dists, rc.ids, rc.dists,
                               rtol=TOL, atol=TOL)
            assert mm["dist_mismatch"] == mm["id_mismatch"] == 0, mm
    st = cb.cache_stats()["candidates"]
    assert (st["hits"], st["size"]) == ((0, 0) if use_pq else (16, 1))


@pytest.mark.cuda
def test_scope_sidecar_on_card(dev):
    """The router's ``"scope"`` sidecar lies on the card: the cache reads
    it to the host, strips it before the kernels, and keys the scoped
    layers on it."""
    from repro_torch.cache import CachingBackend
    from repro_torch.cache.backend import _split_scope
    from repro_torch.core import CacheSpec, SearchOptions, router
    fi, _, qs, flts = _card_index(seed=22)
    progs = compile_programs(flts[:3], fi.schema, 3, device=dev)
    progs["scope"] = torch.tensor([1, 2, 1], dtype=torch.int32, device=dev)
    inner, scopes = _split_scope(progs)
    assert "scope" not in inner and inner["valid"] is progs["valid"]
    assert scopes.dtype == np.int64 and scopes.tolist() == [1, 2, 1]
    cb = CachingBackend(fi.backend, CacheSpec())
    opts = SearchOptions(k=10, ef=64)
    r0 = router.execute(cb, qs[:3], flts[:3], opts, scopes=[1, 2, 1])
    r1 = router.execute(cb, qs[:3], flts[:3], opts, scopes=[2, 1, 1])
    assert _same_bits(r0.ids, r0.dists, r1.ids, r1.dists)
    by_scope = cb.cache_stats()["semantic"]["by_scope"]
    assert by_scope[1]["hits"] == 1 and by_scope[1]["misses"] == 3
    assert by_scope[2]["hits"] == 0 and by_scope[2]["misses"] == 2


@pytest.mark.cuda
def test_frontend_matches_query_on_card(dev):
    """The asyncio FrontEnd over a cached engine on the card (three
    tenants, two executor slots): every response equals
    ``FavorIndex.query``'s bits for the same (query, filter) pair, cold
    and warm, and the warm pass launches no kernel."""
    import asyncio
    from repro_torch.cache import CachingBackend
    from repro_torch.core import (CacheSpec, FrontEndSpec, SearchOptions,
                                  TenantSpec)
    from repro_torch.serving import FrontEnd, ServeEngine
    fi, _, qs, flts = _card_index(seed=23, quant=True)
    opts = SearchOptions(k=10, ef=64, use_pq=True)
    tenants = ("a", "b", "c")

    async def main():
        eng = ServeEngine(CachingBackend(fi.backend, CacheSpec()), opts,
                          max_batch=16)
        fe = FrontEnd(eng, FrontEndSpec(parallel_steps=2, tenants={
            t: TenantSpec(weight=w) for t, w in zip(tenants, (1, 2, 4))}))
        out = []
        for _ in range(2):
            K.reset_launch_counts()
            out.append(await asyncio.gather(*[
                fe.submit(qs[i], flts[i], tenant=tenants[i % 3])
                for i in range(len(qs))]))
            out.append(dict(K.launch_counts))
        await fe.close()
        return out

    cold, cold_launches, warm, warm_launches = asyncio.run(
        asyncio.wait_for(main(), 300))
    assert cold_launches["pq_adc_topr"] > 0
    assert sum(warm_launches.values()) == 0
    res = fi.query(qs, flts, opts)
    for rows in (cold, warm):
        for i, r in enumerate(rows):
            assert _same_bits(r.ids, r.dists, res.ids[i], res.dists[i])
            assert r.route == ("brute" if res.routed_brute[i] else "graph")
            assert r.p_hat == float(res.p_hat[i])


def _card_sharded(mesh_shape=(1, 4), seed=31, n=2048, d=16):
    """A ShardedBackend on a mesh of the card (several shards share it),
    with a PQ codebook trained on the card, and the queries / mixed
    filters of ``_card_index``."""
    from repro_torch.core import (BuildSpec, HnswParams, QuantSpec,
                                  ShardedBackend)
    from repro_torch.core.distributed import make_mesh
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    attrs = PF.random_attributes(PF.paper_schema(), n, seed=seed + 1)
    spec = BuildSpec(hnsw=HnswParams(M=8, efc=48, seed=3),
                     quant=QuantSpec(kind="pq", m=4, nbits=8, train_iters=5))
    be = ShardedBackend.build(vecs, attrs, make_mesh(mesh_shape), spec)
    assert be.device.type == "cuda" and be.mesh.first_device.type == "cuda"
    pool = [PF.Equality("b0", True), PF.Range("f0", 10.0, 60.0),
            PF.And(PF.Equality("i0", 3), PF.Range("f0", 10, 12))]
    qs = rng.normal(size=(48, d)).astype(np.float32)
    return be, vecs, attrs, qs, [pool[i % 3] for i in range(len(qs))]


def _brute_report(cpu, card, vecs, qs, shard_rows: int) -> str:
    """Each pair whose distance the card and the CPU mesh disagree on
    (beyond ``TOL``), or whose tie-free id differs: its row, rank, ids, the
    shard that holds the card's id, both distances and the L2 recomputed in
    float64 from the same vectors; then the tests this process ran."""
    free = tie_free(cpu.dists.astype(np.float64), TOL, TOL)
    lines = ["row rank cpu_id card_id shard cpu_dist card_dist f64_dist"]
    for r, j in zip(*np.nonzero(
            ~np.isclose(card.dists, cpu.dists, rtol=TOL, atol=TOL)
            | (free & (card.ids != cpu.ids)))):
        i = int(card.ids[r, j])
        f64 = (float(np.sqrt(((vecs[i].astype(np.float64)
                               - qs[r].astype(np.float64)) ** 2).sum()))
               if i >= 0 else float("inf"))
        lines.append(f"{r} {j} {int(cpu.ids[r, j])} {i} "
                     f"{i // shard_rows if i >= 0 else -1} "
                     f"{float(cpu.dists[r, j])!r} {float(card.dists[r, j])!r} "
                     f"{f64!r}")
    lines.append("test order: " + ", ".join(_ORDER))
    return "\n".join(lines)


@pytest.mark.cuda
def test_sharded_brute_on_card_matches_cpu(dev):
    """A (1, 4) mesh on the card: the f32 and PQ brute scans launch their
    kernel once per shard and agree with the same backend on a CPU mesh
    (ids outside ties, distances within 1e-5); p_hat and routes are the
    CPU's bits; the graph route launches a gather on every shard."""
    from repro_torch.core import SearchOptions, ShardedBackend, router
    from repro_torch.core.distributed import make_mesh
    be, vecs, _, qs, flts = _card_sharded()
    cpu = ShardedBackend(make_mesh((1, 4), device="cpu"), be.sharded,
                         be.schema, sel_cfg=be.sel_cfg, codebook=be.codebook,
                         rerank=be.rerank)
    for use_pq, kname in ((False, "filtered_topk"), (True, "pq_adc_topr")):
        opts = SearchOptions(k=10, ef=64, force="brute", use_pq=use_pq)
        K.reset_launch_counts()
        rc = router.execute(be, qs, flts, opts)
        assert K.launch_counts[kname] == 4, dict(K.launch_counts)
        rh = router.execute(cpu, qs, flts, opts)
        mm = topk_mismatch(rh.ids, rh.dists, rc.ids, rc.dists,
                           rtol=TOL, atol=TOL)
        assert mm["dist_mismatch"] == mm["id_mismatch"] == 0, (
            use_pq, mm, _brute_report(rh, rc, vecs, qs, be.sharded.shard_rows))
    opts = SearchOptions(k=10, ef=64)
    K.reset_launch_counts()
    rc = router.execute(be, qs, flts, opts)
    assert K.launch_counts["gather_distance"] >= 4
    rh = router.execute(cpu, qs, flts, opts)
    assert np.array_equal(rc.p_hat.view(np.uint32), rh.p_hat.view(np.uint32))
    assert np.array_equal(rc.routed_brute, rh.routed_brute)
    assert rc.routed_brute.any() and not rc.routed_brute.all()


@pytest.mark.cuda
def test_sharded_data_axis_split_on_card(dev):
    """Meshes (2, 4) and (1, 4) on the card give the same bits on every
    route (the kernels do not depend on batch width or composition)."""
    from repro_torch.core import SearchOptions, ShardedBackend, router
    from repro_torch.core.distributed import make_mesh
    be, _, _, qs, flts = _card_sharded()
    wide = ShardedBackend(make_mesh((2, 4)), be.sharded, be.schema,
                          sel_cfg=be.sel_cfg, codebook=be.codebook,
                          rerank=be.rerank)
    for opts in (SearchOptions(k=10, ef=64),
                 SearchOptions(k=10, ef=64, use_pq=True, graph_quant="pq")):
        a = router.execute(be, qs[:47], flts[:47], opts)   # odd: a pad row
        b = router.execute(wide, qs[:47], flts[:47], opts)
        assert _same_bits(a.ids, a.dists, b.ids, b.dists)
        assert np.array_equal(a.p_hat.view(np.uint32),
                              b.p_hat.view(np.uint32))


@pytest.mark.cuda
def test_sharded_live_on_card(dev):
    """Upserts, deletes and both merge shapes on a (1, 4) card mesh: the
    upserted rows are found, no deleted or replaced id comes back on any
    route, the first merge rebuilds every shard and the second grows only
    the last one."""
    from repro_torch.core import SearchOptions, router
    be, vecs, attrs, qs, flts = _card_sharded()
    n0 = vecs.shape[0]
    rng = np.random.default_rng(9)
    new = rng.normal(size=(64, vecs.shape[1])).astype(np.float32)
    ids = be.upsert(new[:48], attrs.ints[:48], attrs.floats[:48])
    rid = be.upsert(new[48:], attrs.ints[48:64], attrs.floats[48:64],
                    replace=np.arange(16))
    assert (ids == n0 + np.arange(48)).all()
    assert be.delete(np.r_[ids[:8], 100 + np.arange(8)]) == 16
    dead = np.r_[np.arange(16), ids[:8], 100 + np.arange(8)]
    true = PF.TrueFilter()

    def check(label):
        for opts in (SearchOptions(k=10, ef=64),
                     SearchOptions(k=10, ef=64, force="brute"),
                     SearchOptions(k=10, ef=64, force="brute", use_pq=True)):
            r = router.execute(be, qs, flts, opts)
            assert not np.isin(r.ids, dead).any(), (label, opts)
        own = router.execute(be, new[8:48], true,
                             SearchOptions(k=10, ef=64, force="brute"))
        assert (own.ids[:, 0] == ids[8:]).all(), label

    check("before merge")
    before = be.shard_versions()
    out = be.merge()
    assert not out["incremental"] and out["merged_slots"] == 64
    assert all(a < b for a, b in zip(before, be.shard_versions()))
    check("after full merge")
    more = rng.normal(size=(16, vecs.shape[1])).astype(np.float32)
    ids2 = be.upsert(more, attrs.ints[:16], attrs.floats[:16])
    assert be.delete(rid[:4]) == 4
    dead = np.r_[dead, rid[:4]]
    before = be.shard_versions()
    out = be.merge()
    assert out["incremental"] and out["merged_slots"] == 16
    after = be.shard_versions()
    assert after[:3] == before[:3] and after[3] == before[3] + 1
    check("after incremental merge")
    own = router.execute(be, more, true,
                         SearchOptions(k=10, ef=64, force="brute"))
    assert (own.ids[:, 0] == ids2).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(1, 100), (37, 100), (64, 10)])
def test_retrieval_kernel_path_matches_plain(dev, b, k):
    """``retrieval_topk_filtered(use_kernel=True)`` on the card launches
    ``filtered_topk`` (k = 100: chained passes) under the constant M^2
    norms of the MIP -> L2 reduction, over items of very different lengths
    (the screen's margin takes |v| from the row): the same ids as its plain
    version on the CPU and as the dot-scoring path on the card outside
    near-ties (score gap under 1e-4), scores within 1e-4."""
    from repro_torch.models.recsys import retrieval_topk_filtered
    from repro_torch.parity import tie_free
    n, d = 60000, 64
    rng = np.random.default_rng(b + k)
    # lengths spread around the unit-normal cell's (M^2 stays near its
    # ~120: the reduction's score recovery loses ~M^2 * 2^-23)
    items = (rng.normal(size=(n, d)) *
             rng.uniform(0.25, 1.25, size=(n, 1))).astype(np.float32)
    users = rng.normal(size=(b, d)).astype(np.float32)
    schema = PF.paper_schema()
    at = PF.random_attributes(schema, n, seed=3)
    flts = [PF.Range("f0", 0.0, 60.0), PF.TrueFilter(),
            PF.And(PF.Equality("b0", True), PF.Inclusion("i0", [2, 5, 7]))]
    progs = compile_programs([flts[i % 3] for i in range(b)], schema, b,
                             device=dev)

    def args(device):
        return (torch.as_tensor(users, device=device),
                torch.as_tensor(items, device=device),
                {key: v.to(device) for key, v in progs.items()},
                torch.as_tensor(at.ints, device=device),
                torch.as_tensor(at.floats, device=device))

    before = K.launch_counts["filtered_topk"]
    ik, sk = retrieval_topk_filtered(*args(dev), k=k, use_kernel=True)
    torch.cuda.synchronize()
    assert K.launch_counts["filtered_topk"] > before
    ip, sp = retrieval_topk_filtered(*args("cpu"), k=k, use_kernel=True)
    idot, sdot = retrieval_topk_filtered(*args(dev), k=k + 1)
    ref_s = sdot.cpu().numpy()
    free = tie_free(ref_s, rtol=0.0, atol=1e-4)[:, :k]
    for ids, sc in ((ik.cpu(), sk.cpu()), (ip, sp)):
        assert (ids.numpy() == idot.cpu().numpy()[:, :k])[free].all()
        np.testing.assert_allclose(sc.numpy(), ref_s[:, :k], rtol=0,
                                   atol=1e-4)
    assert free.mean() > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b", "qwen1.5-32b",
                                  "command-r-plus-104b", "gemma2-2b"])
def test_reduced_lm_on_card_matches_cpu(dev, arch):
    """A reduced LM on the card against the same weights on the CPU, TF32
    off: ``forward_train`` logits, ``prefill`` logits and caches, a decode
    step, at 1e-4 (caches: bf16, within one bf16 ulp)."""
    from repro_torch.configs import get_spec
    from repro_torch.models import transformer as PT
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_spec(arch).reduced
    lm_cpu = PT.LanguageModel(cfg, seed=3, device="cpu")
    lm_gpu = PT.LanguageModel(cfg, seed=0, device=dev)
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    toks = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 12))
    tc, tg = torch.as_tensor(toks), torch.as_tensor(toks, device=dev)

    def close(a, b, tol=1e-4):
        np.testing.assert_allclose(b.float().cpu().numpy(),
                                   a.float().numpy(), rtol=tol, atol=tol)

    close(lm_cpu(tc)[0], lm_gpu(tg)[0])
    pc, cc = lm_cpu.prefill(tc, 16)
    pg, cg = lm_gpu.prefill(tg, 16)
    close(pc, pg)
    for key in ("k", "v"):
        a, b = cc[key].float().numpy(), cg[key].float().cpu().numpy()
        with np.errstate(divide="ignore"):
            ulp = np.exp2(np.floor(np.log2(np.abs(a))) - 7)
        assert (np.abs(a - b) <= 1e-5 + ulp).all()
    nxt = pc.argmax(-1)[:, None]
    dc, _ = lm_cpu.decode_step(nxt, cc, 12)
    dg, _ = lm_gpu.decode_step(nxt.to(dev), cg, 12)
    close(dc, dg)


def _train_case(arch):
    from repro_torch.configs import get_spec
    from repro_torch.data import synthetic
    from repro_torch.models import recsys as PR
    from repro_torch.models import transformer as PT
    cfg = get_spec(arch).reduced
    if arch == "dlrm-rm2":
        batch = synthetic.RecsysPipeline(n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                                         batch=64, n_dense=cfg.n_dense,
                                         seed=3)(0)[0]
        return PR.init_dlrm, cfg, lambda p, b: PR.dlrm_loss(
            p, cfg, b["dense"], b["ids"], b["labels"]), batch, 1e-5
    batch = synthetic.TokenPipeline(vocab=cfg.vocab, seq_len=16, batch=4,
                                    seed=1)(0)[0]
    return PT.init_lm, cfg, lambda p, b: PT.lm_loss(
        p, cfg, b["tokens"], b["labels"]), batch, 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b", "dlrm-rm2"])
def test_train_step_on_card_matches_cpu(dev, arch):
    """Gradients and three SGDM steps of a reduced model on the card
    against the same weights and batch on the CPU, f32, TF32 off: each
    gradient leaf within the CPU parity bar of its max |g| (1e-4 LM, 1e-5
    recsys), parameters within rtol = atol = 1e-5."""
    from repro_torch.models.module import init_with_axes
    from repro_torch.training import optimizer as opt
    from repro_torch.training.step import loss_and_grads, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init, cfg, loss_fn, batch, tol = _train_case(arch)
    pc, _ = init_with_axes(init, 4, cfg, device="cpu")
    pg = opt.tree_map(lambda t: t.to(dev, copy=True), pc)
    bc = {k: torch.as_tensor(v) for k, v in batch.items()}
    bg = {k: v.to(dev) for k, v in bc.items()}
    _, _, gc = loss_and_grads(loss_fn, pc, bc)
    _, _, gg = loss_and_grads(loss_fn, pg, bg)
    for a, b in zip(opt.tree_leaves(gc), opt.tree_leaves(gg)):
        assert b.device.type == "cuda"
        assert float((b.cpu() - a).abs().max()) <= tol * float(a.abs().max())
    ocfg = opt.OptConfig(lr=1e-2, kind="sgdm", warmup_steps=1, total_steps=10)
    step = make_train_step(loss_fn, ocfg)
    sc, sg = opt.init_opt_state(pc, ocfg), opt.init_opt_state(pg, ocfg)
    for _ in range(3):
        pc, sc, mc = step(pc, sc, bc)
        pg, sg, mg = step(pg, sg, bg)
        assert abs(float(mc["loss"]) - float(mg["loss"])) <= 1e-5 + 1e-5 * \
            abs(float(mc["loss"]))
    for a, b in zip(opt.tree_leaves(pc), opt.tree_leaves(pg)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert sg.mu[next(iter(sg.mu))].device.type == "cuda"


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """AdamW state saved from CUDA tensors and restored onto the card (bf16
    leaves by their bits, OptState as OptState): one more step is bit-equal
    to an uninterrupted run."""
    from repro_torch.models.module import init_with_axes
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training.step import make_train_step
    import dataclasses

    from repro_torch.models import transformer as PT
    init, cfg, _, batch, _ = _train_case("gemma2-2b")
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16", remat=True)

    def loss_fn(p, b):
        return PT.lm_loss(p, cfg, b["tokens"], b["labels"])
    bg = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    step = make_train_step(loss_fn, ocfg)

    def fresh():
        p, _ = init_with_axes(init, 5, cfg, dtype=torch.bfloat16, device=dev)
        return {"params": p, "opt": opt.init_opt_state(p, ocfg), "step": 0}

    def run(state, n):
        for _ in range(n):
            state["params"], state["opt"], _ = step(state["params"],
                                                    state["opt"], bg)
            state["step"] += 1
        return state

    straight = run(fresh(), 3)
    half = run(fresh(), 2)
    ckpt.save(str(tmp_path), 2, half)
    back, meta = ckpt.restore(str(tmp_path), shardings=ckpt.device_tree(half))
    assert meta["step"] == 2 and back["step"] == 2
    assert isinstance(back["opt"], opt.OptState)
    leaf = back["params"]["embed"]
    assert leaf.dtype == torch.bfloat16 and leaf.device.type == "cuda"
    resumed = run(back, 1)
    for tree in ("params",):
        for a, b in zip(opt.tree_leaves(straight[tree]),
                        opt.tree_leaves(resumed[tree])):
            assert torch.equal(a, b)
    for a, b in zip(opt.tree_leaves(straight["opt"].mu) +
                    opt.tree_leaves(straight["opt"].nu),
                    opt.tree_leaves(resumed["opt"].mu) +
                    opt.tree_leaves(resumed["opt"].nu)):
        assert torch.equal(a, b)
    assert int(resumed["opt"].step) == 3


@pytest.mark.cuda
def test_scoped_bump_on_card_keeps_the_other_tensors(dev):
    """A scoped attribute bump on the card re-uploads the attribute arrays
    alone and serves an in-place edit on both routes."""
    from repro_torch.core import FavorIndex, HnswParams, SearchOptions
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(1500, 16)).astype(np.float32)
    attrs = PF.random_attributes(PF.paper_schema(), 1500, seed=2)
    fi = FavorIndex.build(vecs, attrs, HnswParams(M=8, efc=32), device=dev)
    keep = {k: fi.g[k].data_ptr() for k in ("vectors", "norms", "neighbors0")}
    ai = fi.g["attrs_int"].data_ptr()
    col = fi.schema.int_index("i0")
    fi.attrs.ints[:, col] = (fi.attrs.ints[:, col] + 1) % 10
    fi.bump_version(("attributes",))
    assert {k: fi.g[k].data_ptr() for k in keep} == keep
    assert fi.g["attrs_int"].data_ptr() not in (ai, *keep.values())
    assert fi.g["attrs_int"].data_ptr() == fi._pf[2].data_ptr()
    flt = PF.Equality("i0", 3)
    passes = fi.attrs.ints[:, col] == 3
    qs = rng.normal(size=(8, 16)).astype(np.float32)
    for force in ("brute", "graph"):
        res = fi.query(qs, flt, SearchOptions(k=10, ef=48, force=force))
        got = res.ids[res.ids >= 0]
        assert got.size and passes[got].all(), force


@pytest.mark.cuda
def test_graph_block_count_on_card_equals_cpu(dev):
    """favor-anns' serve_graph block at the CPU tests' size, its data drawn
    on the host: the card's count (kernel launches charged analytically)
    equals the CPU's (plain versions charged the same), and the kernel
    launched once per counted call."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.launch import cells as LC
    from repro_torch.launch import dryrun as LD
    from repro_torch.launch.mesh import make_test_mesh
    red = dataclasses.replace(get_spec("favor-anns").reduced, batch=8)
    cell = LC.favor_cell(red, "serve_graph", "graph", make_test_mesh())
    K.reset_launch_counts()
    card, c_card, _ = LD.count_block(cell, dev, 0, data_device="cpu")
    launches = K.launch_counts["gather_distance"]
    cpu, c_cpu, _ = LD.count_block(cell, "cpu", 0)
    assert c_card.cost == c_cpu.cost and c_card.kernels == c_cpu.kernels
    assert card["count"]["parts"] == cpu["count"]["parts"]
    assert card["block"]["waves"] == cpu["block"]["waves"] > 0
    assert launches == c_card.kernels["gather_distance"]["calls"]
    assert card["block"]["peak_memory_bytes"] > 0
    assert torch.equal(c_card.out[0].cpu(), c_cpu.out[0])
