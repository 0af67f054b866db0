"""The CUDA kernels against their plain versions, on the card only (marked
``cuda``; they skip without a CUDA device).  No JAX here: this file runs on
a machine with a card and the port alone.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bar: distances rtol/atol 1e-5, ids equal outside ties, TD bits equal.  The
kernel's d-long dot is one FMA chain and the plain version's a cuBLAS or
tree reduction, so the two differ only in the last bits of the squared
distance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core import prefbf  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402
from repro_torch.kernels.filtered_topk import ops as ft  # noqa: E402
from repro_torch.kernels.gather_distance import ops as gd  # noqa: E402
from repro_torch.parity import topk_mismatch  # noqa: E402

TOL = 1e-5


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
                                         (50, 16, 3, 64, 64)])
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


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(dev):
    db, qs, progs, _ = _case(dev, 100, 16, 4, seed=1)
    with pytest.raises(ValueError, match="dtype"):
        ft.filtered_topk(db[0].double(), *db[1:], qs, progs, k=5)
    with pytest.raises(ValueError, match="contiguous"):
        ft.filtered_topk(*db, qs.t().contiguous().t(), progs, k=5)
    with pytest.raises(ValueError, match="k=1000"):
        ft.filtered_topk(*db, qs, progs, k=1000)
    with pytest.raises(ValueError, match="expected cuda"):
        gd.gather_distance(*db, qs, torch.zeros((4, 3), dtype=torch.int32),
                           progs, torch.zeros(4, device=dev))
