"""Port parity, bucketing: ``core.batching`` of the port against the JAX
package's (``tests/test_batching.py``) on the shared ``small_index``.

Bars: the BatchSpec ladder, the always-false pad programs and the
ShapeRegistry accounting equal the JAX package's; bucket-padded and
unpadded runs of the port give bit-identical ids, distances, p_hat, routes
and traversal diagnostics on every route and option set (f32, ``use_pq``,
``graph_quant="pq"`` and ``"sq"``) over a seeded sweep of batch sizes,
filter mixes and route pins; the port's padded outputs hold the JAX
package's padded outputs at ``ROADMAP.md``'s bars (p_hat and routes
identical, brute ids identical, graph rows >= 90 % identical)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import BatchSpec as RBatch  # noqa: E402
from repro.core import BuildSpec as RBuild  # noqa: E402
from repro.core import FavorIndex as RIndex  # noqa: E402
from repro.core import QuantSpec as RQuant  # noqa: E402
from repro.core import SearchOptions as ROpts  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import batching as r_batching  # noqa: E402
from repro.core import router as r_router  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import BuildSpec, QuantSpec, SearchOptions  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core import router  # noqa: E402
from repro_torch.core.batching import (BatchSpec, ShapeRegistry,  # noqa: E402
                                       false_program_rows, pad_programs,
                                       pad_to_bucket, unpad, warmup)
from repro_torch.parity import topk_mismatch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPEC = BatchSpec(min_bucket=4, max_bucket=32)
OPTS = SearchOptions(k=10, ef=64)
OPTS_B = OPTS.with_(batch=SPEC)
QUANT = {"pq": dict(kind="pq", m=8, nbits=5, train_iters=8, rerank=4),
         "sq": dict(kind="sq", rerank=4)}
ROUTES = {"f32": ({}, None), "use_pq": ({"use_pq": True}, "pq"),
          "graph_pq": ({"graph_quant": "pq"}, "pq"),
          "graph_sq": ({"graph_quant": "sq"}, "sq"),
          "sq_use_pq": ({"use_pq": True}, "sq")}


def _port_of(ref, **kw):
    idx, cb = ref.index, ref.codebook
    arrays = {}
    if cb is not None:
        arrays = ({"centroids": cb.centroids} if ref.quantize == "pq" else
                  {"lo": cb.lo, "scale": cb.scale})
        arrays["codes"] = np.asarray(ref._codes)[:idx.n]
    return from_reference_arrays(
        vectors=idx.vectors, levels=idx.levels, node_level=idx.node_level,
        entry_point=idx.entry_point, delta_d=idx.delta_d, params=idx.params,
        ints=ref.attrs.ints, floats=ref.attrs.floats, schema=ref.schema,
        norms=idx.norms, device="cpu", **arrays, **kw)


@pytest.fixture(scope="module")
def indexes(small_index, small_dataset):
    """{quant kind: (JAX index, port index)} over small_index's graph; the
    quantized ones carry the JAX codebook and codes across."""
    _, attrs, _ = small_dataset
    out = {None: (small_index, _port_of(small_index))}
    for kind, kw in QUANT.items():
        ref = RIndex(small_index.index, attrs, RBuild(quant=RQuant(**kw)))
        out[kind] = (ref, _port_of(ref, spec=BuildSpec(quant=QuantSpec(**kw))))
    return out


# ---------------------------------------------------------------------------
# BatchSpec policy, pad rows, registry
# ---------------------------------------------------------------------------
def test_batchspec_validation():
    with pytest.raises(ValueError, match="power of two"):
        BatchSpec(min_bucket=6)
    with pytest.raises(ValueError, match="power of two"):
        BatchSpec(max_bucket=100)
    with pytest.raises(ValueError, match="min_bucket"):
        BatchSpec(min_bucket=64, max_bucket=32)
    with pytest.raises(ValueError, match="pad_policy"):
        BatchSpec(pad_policy="wrap")
    with pytest.raises(TypeError, match="BatchSpec"):
        SearchOptions(batch={"min_bucket": 8})


@pytest.mark.parametrize("lo,hi", [(4, 32), (1, 1), (8, 512)])
def test_bucket_ladder_matches_reference(lo, hi):
    port, ref = BatchSpec(lo, hi), RBatch(lo, hi)
    assert port.buckets() == ref.buckets()
    assert [port.bucket_for(n) for n in range(1, 3 * hi + 2)] == \
        [ref.bucket_for(n) for n in range(1, 3 * hi + 2)]
    with pytest.raises(ValueError, match="n >= 1"):
        port.bucket_for(0)


def test_pad_rows_match_nothing_and_unpad_roundtrip(small_dataset):
    _, attrs, schema = small_dataset
    pf = PF.paper_filters(PF.paper_schema())
    flts = [pf["range_50"], PF.TrueFilter(), pf["logic"]]
    progs = router.compile_programs(flts, PF.paper_schema(), 3, device="cpu")
    queries = torch.as_tensor(np.random.default_rng(0).normal(
        size=(3, 16)).astype(np.float32))
    qp, pp, ph, valid = pad_to_bucket(SPEC, queries, progs,
                                      np.ones((3,), np.float32))
    assert qp.shape[0] == 4 and valid.tolist() == [True] * 3 + [False]
    assert ph.shape == (4,) and ph[3] == 0.0
    assert torch.equal(qp[3], torch.zeros(16))
    mask = PF.eval_program_batched(pp, torch.as_tensor(attrs.ints),
                                   torch.as_tensor(attrs.floats))
    assert not mask[3].any() and mask[1].all()  # TrueFilter row untouched
    uq, up = unpad(3, qp, ph)
    assert torch.equal(uq, queries) and (up == 1.0).all()
    for k in progs:
        assert torch.equal(pp[k][:3], progs[k])
    # exact bucket size: nothing padded, same objects pass through
    q4 = torch.cat([queries, queries[:1]])
    p4 = router.compile_programs(flts + flts[:1], PF.paper_schema(), 4,
                                 device="cpu")
    qp4, pp4, _, v4 = pad_to_bucket(SPEC, q4, p4)
    assert qp4 is q4 and pp4 is p4 and v4.all()
    pp_only, v = pad_programs(SPEC, progs)
    assert pp_only["valid"].shape[0] == 4 and not v[3]
    # the "repeat" policy pads with the last real query
    qr, _, _, _ = pad_to_bucket(BatchSpec(4, 32, "repeat"), queries, progs)
    assert torch.equal(qr[3], queries[2])


def test_false_program_rows_match_reference(small_dataset):
    _, _, schema = small_dataset
    pf = RF.paper_filters(schema)
    rprogs = {k: jnp.asarray(v) for k, v in RF.stack_programs(
        [RF.compile_filter(pf["logic"], schema)] * 2).items()}
    pprogs = router.compile_programs(
        [PF.paper_filters(PF.paper_schema())["logic"]] * 2, PF.paper_schema(),
        2, device="cpu")
    want = r_batching.false_program_rows(rprogs, 3)
    got = false_program_rows(pprogs, 3)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]).astype(
                                          got[k].numpy().dtype))


def test_shape_registry_accounting():
    reg, rreg = ShapeRegistry(), r_batching.ShapeRegistry()
    ropts = ROpts(k=10, ef=64)
    calls = [("graph", 8, 5, {}), ("graph", 8, 7, {}), ("graph", 16, 9, {}),
             ("brute", 8, 8, {}), ("graph", 8, 8, {"ef": 48}),
             ("estimate", 8, 3, None)]
    for kind, size, real, over in calls:
        new = reg.record(kind, size, real,
                         None if over is None else OPTS.with_(**over))
        rnew = rreg.record(kind, size, real,
                           None if over is None else ropts.with_(**over))
        assert new == rnew, (kind, size, over)
    assert reg.stats() == rreg.stats()
    assert reg.sizes_by_kind() == {"graph": (8, 16), "brute": (8,),
                                   "estimate": (8,)}
    reg.reset_rows()
    st = reg.stats()
    assert st["pad_rows"] == 0 and st["compiled_shapes"] == 5


# ---------------------------------------------------------------------------
# Bit-identical parity: bucket-padded vs. unpadded, every route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", [1, 3, 8, 13, 40])
def test_plain_dots_do_not_depend_on_batch_width(width):
    """The plain scans' dots (``rows_mm``) and the LUTs (``build_luts``):
    a query's bits are the same in a batch of any width."""
    from repro_torch.kernels._common import rows_mm
    from repro_torch.quant.adc import build_luts
    rng = np.random.default_rng(width)
    qs = torch.as_tensor(rng.normal(size=(40, 20)).astype(np.float32))
    db = torch.as_tensor(rng.normal(size=(300, 20)).astype(np.float32))
    cents = torch.as_tensor(rng.normal(size=(6, 32, 4)).astype(np.float32))
    lo = int(rng.integers(0, 41 - width))
    part = qs[lo:lo + width]
    assert torch.equal(rows_mm(part, db), rows_mm(qs, db)[lo:lo + width])
    np.testing.assert_allclose(rows_mm(part, db).numpy(),
                               (part @ db.T).numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(build_luts(cents, part),
                       build_luts(cents, qs)[lo:lo + width])


def _pool(F, schema):
    pf = F.paper_filters(schema)
    return [pf["equality_bool"], pf["equality_int"], pf["range_10"],
            pf["logic"], F.TrueFilter(), F.FalseFilter(),
            F.And(F.Equality("i0", 3), F.Range("f0", 11.0, 13.0))]


def _workload(n, seed, dim=16):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(n, dim)).astype(np.float32)
    pick = rng.integers(0, 7, n)
    rs, ps = RF.paper_schema(), PF.paper_schema()
    return (qs, [_pool(RF, rs)[i] for i in pick],
            [_pool(PF, ps)[i] for i in pick])


def _assert_bit_identical(ra, rb):
    np.testing.assert_array_equal(ra.ids, rb.ids)
    np.testing.assert_array_equal(ra.dists, rb.dists)
    np.testing.assert_array_equal(ra.p_hat, rb.p_hat)
    np.testing.assert_array_equal(ra.routed_brute, rb.routed_brute)
    np.testing.assert_array_equal(ra.hops, rb.hops)
    np.testing.assert_array_equal(ra.path_td, rb.path_td)


# the JAX suite's edge cases, then a seeded sweep over sizes 1..9 and pins
EDGES = [(None, 7, 57), (None, 4, 54), ("graph", 5, 55), ("brute", 3, 53),
         (None, 1, 51)]
_rng = np.random.default_rng(2024)
SWEEP = [(("graph", "brute", None)[int(_rng.integers(3))],
          int(_rng.integers(1, 10)), int(_rng.integers(2 ** 16)))
         for _ in range(6)]


@pytest.mark.parametrize("force,n,seed", EDGES + SWEEP)
def test_padded_parity_f32(indexes, force, n, seed):
    port = indexes[None][1]
    qs, _, pflt = _workload(n, seed)
    ra = router.execute(port.backend, qs, pflt, OPTS.with_(force=force))
    rb = router.execute(port.backend, qs, pflt, OPTS_B.with_(force=force))
    _assert_bit_identical(ra, rb)


@pytest.mark.parametrize("route", ["use_pq", "graph_pq", "graph_sq",
                                   "sq_use_pq"])
@pytest.mark.parametrize("n,seed", [(6, 77), (1, 78), (9, 79)])
def test_padded_parity_compressed(indexes, route, n, seed):
    over, kind = ROUTES[route]
    port = indexes[kind][1]
    force = "brute" if "use_pq" in over else "graph"
    qs, _, pflt = _workload(n, seed)
    opts = OPTS.with_(force=force, **over)
    ra = router.execute(port.backend, qs, pflt, opts)
    rb = router.execute(port.backend, qs, pflt, opts.with_(batch=SPEC))
    _assert_bit_identical(ra, rb)


def test_registry_records_execute_shapes(indexes):
    port = indexes[None][1]
    reg = ShapeRegistry()
    qs, _, pflt = _workload(7, 57)
    r = router.execute(port.backend, qs, pflt, OPTS_B, registry=reg)
    st = reg.stats()
    ng, nb = int((~r.routed_brute).sum()), int(r.routed_brute.sum())
    assert ng and nb
    assert st["sizes"] == {"estimate": (8,), "graph": (SPEC.bucket_for(ng),),
                           "brute": (SPEC.bucket_for(nb),)}
    assert st["real_rows"] == 7 + ng + nb
    assert st["pad_rows"] == (8 - 7 + SPEC.bucket_for(ng) - ng
                              + SPEC.bucket_for(nb) - nb)
    # the unpadded path records raw sizes
    reg2 = ShapeRegistry()
    router.execute(port.backend, qs, pflt, OPTS, registry=reg2)
    assert reg2.stats()["pad_rows"] == 0
    assert reg2.sizes_by_kind()["estimate"] == (7,)


def test_warmup_bounds_shapes_and_honors_force(indexes):
    port = indexes[None][1]
    with pytest.raises(ValueError, match="batch"):
        warmup(port.backend, OPTS)
    reg = ShapeRegistry()
    ladder = warmup(port.backend, OPTS_B, buckets=(4, 8), registry=reg)
    assert ladder == (4, 8)
    assert reg.stats()["compiled_shapes"] == 3 * 2
    assert reg.stats()["real_rows"] == 0
    qs, _, pflt = _workload(7, 57)
    router.execute(port.backend, qs, pflt, OPTS_B, registry=reg)
    for kind, sizes in reg.sizes_by_kind().items():
        assert set(sizes) <= {4, 8}, (kind, sizes)
    assert reg.stats()["compiled_shapes"] == 3 * 2   # nothing new
    reg_b = ShapeRegistry()
    warmup(port.backend, OPTS_B.with_(force="brute"), buckets=(4,),
           registry=reg_b)
    assert "graph" not in reg_b.sizes_by_kind()
    assert reg_b.stats()["compiled_shapes"] == 2
    assert warmup(port.backend, OPTS_B) == SPEC.buckets()


@pytest.mark.parametrize("route", ["f32", "use_pq", "graph_pq"])
def test_padded_matches_reference(indexes, route):
    over, kind = ROUTES[route]
    ref, port = indexes[kind]
    qs, rflt, pflt = _workload(9, 91)
    rb = r_router.execute(ref.backend, qs, rflt,
                          ROpts(k=10, ef=64, **over).with_(batch=RBatch(4,
                                                                         32)))
    pb = router.execute(port.backend, qs, pflt, OPTS_B.with_(**over))
    np.testing.assert_array_equal(pb.p_hat, rb.p_hat)
    np.testing.assert_array_equal(pb.routed_brute, rb.routed_brute)
    br = rb.routed_brute
    assert br.any() and (~br).any()
    m = topk_mismatch(rb.ids[br], rb.dists[br], pb.ids[br], pb.dists[br])
    assert m["dist_mismatch"] == 0 and m["id_mismatch"] == 0, m
    assert (rb.ids[~br] == pb.ids[~br]).all(axis=1).mean() >= 0.9
