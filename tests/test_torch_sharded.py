"""Port parity, sharded backend: ``repro_torch.core.distributed`` and
``ShardedBackend`` against the JAX package's (``tests/test_distributed.py``,
the sharded tests of ``tests/test_backends.py``, ``tests/test_mutation.py``
and ``tests/test_cache.py``), plus the public API of ``repro.core`` that the
port lacked (``Backend``, ``Scorer``, ``exclusion_compose``, the scorers'
``required_keys`` / ``lut_bytes``, ``estimate_selectivity[_batched]``).

The port's mesh is an array of devices driven by one process, so it runs
S = 2 and S = 4 shards in this process on ``"cpu"``; the JAX package needs
fake devices for that, which it gets in one subprocess.  Bars
(``ROADMAP.md``): host arrays equal; p_hat bit for bit and routes identical
(the sample totals here are no power of two, so the estimate's true
division and a reciprocal multiply give other bits, and the test shows
which one the JAX package takes); f32 brute ids identical with distances
at 1e-5; graph rows >= 90 % identical with recall within 0.02; PQ brute
ids agreeing on >= 90 %; the same bits at meshes (1, S) and (2, S)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import distributed as rdist  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import refimpl as rref  # noqa: E402
from repro.core import scoring as rscoring  # noqa: E402
from repro.core import selectivity as rsel  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.cache import CachingBackend  # noqa: E402
from repro_torch.core import distributed as pdist  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core import selectivity as psel  # noqa: E402
from repro_torch.core.selector import SelectorConfig  # noqa: E402
from repro_torch.quant import PQCodebook  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
N, DIM, K = 2000, 16, 10
RTOL = ATOL = 1e-5
# a selectivity sample of 300 rows in all: cnt / 300 and cnt * (1 / 300)
# round differently for some counts
MIN_SAMPLE = 300
HNSW = dict(M=8, efc=32, seed=3)
QUANT = dict(kind="pq", m=8, nbits=5, train_iters=10, rerank=4)


def _ref_spec():
    return R.BuildSpec(hnsw=R.HnswParams(**HNSW),
                       selector=R.selector.SelectorConfig(
                           min_sample=MIN_SAMPLE),
                       quant=R.QuantSpec(**QUANT))


def _port_spec():
    return P.BuildSpec(hnsw=P.HnswParams(**HNSW),
                       selector=SelectorConfig(min_sample=MIN_SAMPLE),
                       quant=P.QuantSpec(**QUANT))


def _port_programs(flts, schema):
    return P.router.compile_programs(flts, schema, len(flts),
                                     device=torch.device("cpu"))


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(N, DIM)).astype(np.float32)
    rs = RF.paper_schema()
    ra = RF.random_attributes(rs, N, seed=11)
    ps = PF.paper_schema()
    pa = PF.AttributeTable(ps, ra.ints, ra.floats)
    return vecs, ra, pa, rs, ps


@pytest.fixture(scope="module")
def pair_1x1(ds):
    """Both packages' ShardedBackend.build on a 1 x 1 mesh, one codebook."""
    vecs, ra, pa, _, _ = ds
    ref = R.ShardedBackend.build(vecs, ra, jax.make_mesh((1, 1),
                                                         ("data", "model")),
                                 _ref_spec())
    cb = PQCodebook(np.array(ref.codebook.centroids), ref.codebook.dim)
    port = P.ShardedBackend.build(vecs, pa, pdist.make_mesh((1, 1),
                                                            device="cpu"),
                                  _port_spec(), codebook=cb)
    return ref, port


# ---------------------------------------------------------------------------
# (a) build_sharded, (b) attach_quant
# ---------------------------------------------------------------------------
# per shard count: the sample bounds of tests/test_backends.py:121 and a
# headroom tail inside the last shard
BUILDS = {1: dict(),
          2: dict(min_sample=MIN_SAMPLE, n_valid=N - 37),
          4: dict(sample_rate=0.5, max_sample=128, n_valid=N - 37)}


@pytest.fixture(scope="module", params=sorted(BUILDS), ids=lambda s: f"S{s}")
def built(request, ds):
    vecs, ra, pa, _, _ = ds
    s = request.param
    kw = dict(BUILDS[s], keep_parts=True)
    ref = rdist.build_sharded(vecs, ra, s, R.HnswParams(M=4, efc=12), **kw)
    port = pdist.build_sharded(vecs, pa, s, P.HnswParams(M=4, efc=12), **kw)
    return s, ref, port


def test_build_sharded_matches_reference(built):
    s, (ref, rparts), (port, pparts) = built
    assert (port.n_shards, port.shard_rows, port.sample_rows) == \
        (ref.n_shards, ref.shard_rows, ref.sample_rows)
    assert sorted(port.arrays) == sorted(ref.arrays)
    for key, a in ref.arrays.items():
        np.testing.assert_array_equal(port.arrays[key], np.asarray(a),
                                      err_msg=key)
        assert port.arrays[key].dtype == np.asarray(a).dtype, key
    for rp, pp in zip(rparts, pparts):
        assert pp.n == rp.n and pp.entry_point == rp.entry_point
        for rl, pl in zip(rp.levels, pp.levels):
            np.testing.assert_array_equal(pl, rl)
    total = port.sample_rows * s
    if "min_sample" in BUILDS[s]:
        assert total >= MIN_SAMPLE
    if "max_sample" in BUILDS[s]:
        assert total <= BUILDS[s]["max_sample"]
    if "n_valid" in BUILDS[s]:
        # headroom rows sit in the last shard, unlinked, out of the sample
        tail = port.arrays["neighbors0"][BUILDS[s]["n_valid"]:]
        assert (tail == -1).all()
        assert pparts[-1].n == port.shard_rows - 37


def test_db_specs_match_reference():
    for quant in (None, "pq", "sq"):
        for live in (False, True):
            r = rdist.db_specs(quant=quant, live=live)
            p = pdist.db_specs(quant=quant, live=live)
            assert {k: tuple(v) for k, v in r.items()} == p
    with pytest.raises(ValueError, match="quant"):
        pdist.db_specs(quant="opq")


def test_attach_quant_matches_reference(pair_1x1):
    ref, port = pair_1x1
    base = {k: v for k, v in port.sharded.arrays.items()
            if k not in ("codes", "centroids")}
    plain = pdist.ShardedFavorArrays(base, 1, port.sharded.shard_rows,
                                     port.sharded.sample_rows)
    att = pdist.attach_quant(plain, port.codebook, device="cpu")
    assert att.quant == "pq" and plain.quant is None
    for key in ("codes", "centroids"):
        np.testing.assert_array_equal(att.arrays[key],
                                      np.asarray(ref.sharded.arrays[key]))
        assert isinstance(att.arrays[key], np.ndarray)
    assert att.specs() == pdist.db_specs(quant="pq")


# ---------------------------------------------------------------------------
# (c) against the JAX ShardedBackend on a 1 x 1 mesh
# ---------------------------------------------------------------------------
def _truth(vecs, attrs, rs, flt, qs):
    mask = RF.eval_program(RF.compile_filter(flt, rs), attrs.ints,
                           attrs.floats)
    return [rref.bruteforce_filtered(vecs, mask, q, K)[0] for q in qs]


def _recall(ids, truth):
    return float(np.mean([rref.recall_at_k(ids[i], truth[i], K)
                          for i in range(len(truth))]))


def test_sharded_matches_reference_1x1(pair_1x1, ds):
    vecs, ra, _, rs, ps = ds
    ref, port = pair_1x1
    assert isinstance(port, P.Backend)
    assert port.device == torch.device("cpu")
    rng = np.random.default_rng(40)
    qs = rng.normal(size=(16, DIM)).astype(np.float32)
    opts = dict(k=K, ef=64)
    for (name, rflt), pflt in zip(R.paper_filters(rs).items(),
                                  P.paper_filters(ps).values()):
        truth = _truth(vecs, ra, rs, rflt, qs)
        rr = R.router.execute(ref, qs, rflt, R.SearchOptions(**opts))
        pr = P.router.execute(port, qs, pflt, P.SearchOptions(**opts))
        np.testing.assert_array_equal(pr.p_hat, rr.p_hat, err_msg=name)
        np.testing.assert_array_equal(pr.routed_brute, rr.routed_brute,
                                      err_msg=name)
        rg = R.router.execute(ref, qs, rflt,
                              R.SearchOptions(force="graph", **opts))
        pg = P.router.execute(port, qs, pflt,
                              P.SearchOptions(force="graph", **opts))
        same = float((pg.ids == rg.ids).all(axis=1).mean())
        assert same >= 0.9, (name, same)
        assert _recall(pg.ids, truth) >= _recall(rg.ids, truth) - 0.02, name
        rb = R.router.execute(ref, qs, rflt,
                              R.SearchOptions(force="brute", **opts))
        pb = P.router.execute(port, qs, pflt,
                              P.SearchOptions(force="brute", **opts))
        np.testing.assert_array_equal(pb.ids, rb.ids, err_msg=name)
        np.testing.assert_allclose(pb.dists, rb.dists, rtol=RTOL, atol=ATOL)
        rq = R.router.execute(ref, qs, rflt, R.SearchOptions(
            force="brute", use_pq=True, **opts))
        pq = P.router.execute(port, qs, pflt, P.SearchOptions(
            force="brute", use_pq=True, **opts))
        assert float((pq.ids == rq.ids).mean()) >= 0.9, name
    assert port.bytes_per_vector(quantized=True) == \
        ref.bytes_per_vector(quantized=True)
    for gq in (None, "pq"):
        o = dict(graph_quant=gq)
        assert port.bytes_per_hop(P.SearchOptions(**o)) == \
            ref.bytes_per_hop(R.SearchOptions(**o))
    assert port.dim == ref.dim


def test_sharded_validate_and_pq_graph(pair_1x1, ds):
    """``use_pq`` without codes raises; the PQ graph scorer runs per shard
    and holds the reference's bar."""
    vecs, ra, pa, rs, ps = ds
    ref, port = pair_1x1
    plain = P.ShardedBackend(port.mesh, pdist.ShardedFavorArrays(
        {k: v for k, v in port.sharded.arrays.items()
         if k not in ("codes", "centroids")}, 1, port.sharded.shard_rows,
        port.sharded.sample_rows), ps)
    with pytest.raises(ValueError, match="quantize"):
        P.router.execute(plain, np.zeros((2, DIM), np.float32),
                         PF.TrueFilter(), P.SearchOptions(k=5, use_pq=True))
    with pytest.raises(ValueError, match="graph_quant"):
        plain.validate(P.SearchOptions(graph_quant="pq"))
    rng = np.random.default_rng(44)
    qs = rng.normal(size=(8, DIM)).astype(np.float32)
    rflt = R.paper_filters(rs)["range_50"]
    pflt = P.paper_filters(ps)["range_50"]
    opts = dict(k=K, ef=64, force="graph", graph_quant="pq")
    rg = R.router.execute(ref, qs, rflt, R.SearchOptions(**opts))
    pg = P.router.execute(port, qs, pflt, P.SearchOptions(**opts))
    truth = _truth(vecs, ra, rs, rflt, qs)
    assert float((pg.ids == rg.ids).all(axis=1).mean()) >= 0.9
    assert _recall(pg.ids, truth) >= _recall(rg.ids, truth) - 0.02


def test_sharded_sq_matches_reference_1x1(pair_1x1, ds):
    """The SQ codebook on the sharded path: ``attach_quant``'s codes, the
    SQ brute scan (``use_pq``) and the SQ graph scorer against the JAX
    package's, on the 1 x 1 fixture's arrays."""
    from repro import quant as rquant
    from repro_torch import quant as pquant
    vecs, ra, _, rs, ps = ds
    ref, port = pair_1x1
    rcb = rquant.train_sq(vecs)
    pcb = pquant.train_sq(vecs)
    np.testing.assert_array_equal(pcb.lo, rcb.lo)
    np.testing.assert_array_equal(pcb.scale, rcb.scale)
    drop = ("codes", "centroids")
    rsh = rdist.ShardedFavorArrays(
        {k: v for k, v in ref.sharded.arrays.items() if k not in drop}, 1,
        N, ref.sharded.sample_rows)
    psh = pdist.ShardedFavorArrays(
        {k: v for k, v in port.sharded.arrays.items() if k not in drop}, 1,
        N, port.sharded.sample_rows)
    rbe = R.ShardedBackend(jax.make_mesh((1, 1), ("data", "model")), rsh,
                           rs, codebook=rcb)
    pbe = P.ShardedBackend(port.mesh, psh, ps, codebook=pcb)
    assert pbe.quant == "sq" == rbe.quant
    np.testing.assert_array_equal(pbe.sharded.arrays["codes"],
                                  np.asarray(rbe.sharded.arrays["codes"]))
    rng = np.random.default_rng(45)
    qs = rng.normal(size=(8, DIM)).astype(np.float32)
    rflt = R.paper_filters(rs)["range_50"]
    pflt = P.paper_filters(ps)["range_50"]
    truth = _truth(vecs, ra, rs, rflt, qs)
    for o in (dict(force="brute", use_pq=True),
              dict(force="graph", graph_quant="sq")):
        rr = R.router.execute(rbe, qs, rflt, R.SearchOptions(k=K, ef=64, **o))
        pr = P.router.execute(pbe, qs, pflt, P.SearchOptions(k=K, ef=64, **o))
        assert float((pr.ids == rr.ids).all(axis=1).mean()) >= 0.9, o
        assert _recall(pr.ids, truth) >= _recall(rr.ids, truth) - 0.02, o


# ---------------------------------------------------------------------------
# (d) the JAX package at S > 1 and its live script: one subprocess with four
# fake CPU devices (tests/test_distributed.py), started with the module
# ---------------------------------------------------------------------------
MESHES = ((2, 2), (1, 4))
# the paper scenarios plus ranges of many widths: counts of many values,
# so the division's rounding shows (26 queries, 13 per data block)
RANGE_WIDTHS = tuple(range(5, 105, 5))


def _multi_filters(pkg, schema):
    return list(pkg.paper_filters(schema).values()) + [
        pkg.filters.Range("f0", 0.0, float(w)) for w in RANGE_WIDTHS]


def _reference_run(out_path: str) -> None:
    """The JAX package's side, run in the subprocess: the serve steps on
    each mesh of MESHES, and ``_live_script`` on a 1 x 1 mesh; every
    result lands in one ``.npz``."""
    assert len(jax.devices()) == 4
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(N, DIM)).astype(np.float32)
    schema = RF.paper_schema()
    attrs = RF.random_attributes(schema, N, seed=6)
    flts = _multi_filters(R, schema)
    progs = RF.stack_programs([RF.compile_filter(f, schema) for f in flts])
    progs = {k: jnp.asarray(v) for k, v in progs.items()}
    qs = rng.normal(size=(len(flts), DIM)).astype(np.float32)
    valid = jnp.ones((len(flts),), bool)
    out = {"queries": qs, "vecs": vecs, "ints": attrs.ints,
           "floats": attrs.floats}
    for nd, s in MESHES:
        sh = rdist.build_sharded(vecs, attrs, s,
                                 R.HnswParams(M=8, efc=32, seed=0),
                                 min_sample=MIN_SAMPLE)
        mesh = jax.make_mesh((nd, s), ("data", "model"))
        fns = rdist.make_serve_fns(mesh, R.SearchConfig(k=K, ef=48))
        db = rdist.device_put_sharded_db(sh.arrays, mesh, fns["db_specs"])
        p = fns["estimate"](db, progs)
        gi, gd = fns["serve_graph_phat"](db, qs, progs, p, valid)
        bi, bd = fns["serve_brute"](db, qs, progs, valid)
        tag = f"{nd}x{s}_"
        for key, v in (("p_hat", p), ("graph_ids", gi), ("graph_dists", gd),
                       ("brute_ids", bi), ("brute_dists", bd)):
            out[tag + key] = np.asarray(v)
        for key, v in sh.arrays.items():
            out[tag + "arr_" + key] = np.asarray(v)

    vecs, attrs = _live_data(RF)
    be = R.ShardedBackend.build(
        vecs, attrs, jax.make_mesh((1, 1), ("data", "model"),
                                   devices=jax.devices()[:1]),
        R.BuildSpec(hnsw=R.HnswParams(**LIVE_HNSW),
                    quant=R.QuantSpec(**QUANT)))
    out["codebook"] = np.asarray(be.codebook.centroids)
    out.update({"live_" + k: v for k, v in
                _live_script(R, be, vecs, attrs).items()})
    np.savez(out_path, **out)


@pytest.fixture(scope="module", autouse=True)
def ref_run(tmp_path_factory):
    """Starts ``_reference_run`` in a subprocess at the module's first test
    (it overlaps the in-process tests); calling the fixture's value waits
    for it and returns its arrays."""
    tmp = tmp_path_factory.mktemp("sharded")
    out, log = tmp / "ref.npz", tmp / "ref.log"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import sys; sys.path.insert(0, sys.argv[2]); "
            "import test_torch_sharded as t; t._reference_run(sys.argv[1])")
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, str(out), str(ROOT / "tests")],
            env=env, cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT)
    box = {}

    def result() -> dict:
        if "z" not in box:
            rc = proc.wait(timeout=600)
            assert rc == 0, log.read_text()
            with np.load(out) as z:
                box["z"] = {k: z[k] for k in z.files}
        return box["z"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_serve_fns_match_reference_multi_shard(ref_run, mesh_shape):
    z = ref_run()
    nd, s = mesh_shape
    tag = f"{nd}x{s}_"
    arrays = {k[len(tag) + 4:]: v for k, v in z.items()
              if k.startswith(tag + "arr_")}
    schema = PF.paper_schema()
    qs = torch.as_tensor(z["queries"])
    q = qs.shape[0]
    progs = _port_programs(_multi_filters(P, schema), schema)
    mesh = pdist.make_mesh(mesh_shape, device="cpu")
    fns = pdist.make_serve_fns(mesh, P.SearchConfig(k=K, ef=48))
    db = pdist.place_sharded_db(arrays, mesh, fns["db_specs"])
    valid = torch.ones((q,), dtype=torch.bool)

    p_hat = fns["estimate"](db, progs)
    np.testing.assert_array_equal(p_hat.numpy(), z[tag + "p_hat"])
    # the sample total is no power of two: the JAX package divides the
    # summed count by the summed size, and a reciprocal multiply differs
    mask = PF.eval_program_batched(progs, torch.as_tensor(
        arrays["sample_int"]), torch.as_tensor(arrays["sample_float"]))
    cnt = mask.sum(dim=1, dtype=torch.float32)
    tot = mask.shape[1]
    recip = cnt * torch.tensor(1.0 / tot, dtype=torch.float32)
    assert bool((recip != p_hat).any()), "sample total does not discriminate"
    np.testing.assert_array_equal(
        P.selector.route(p_hat, 0.01), z[tag + "p_hat"] < 0.01)

    bi, bd = fns["serve_brute"](db, qs, progs, valid)
    np.testing.assert_array_equal(bi.numpy(), z[tag + "brute_ids"])
    np.testing.assert_allclose(bd.numpy(), z[tag + "brute_dists"],
                               rtol=RTOL, atol=ATOL)
    gi, gd = fns["serve_graph_phat"](db, qs, progs, p_hat, valid)
    same = float((gi.numpy() == z[tag + "graph_ids"]).all(axis=1).mean())
    assert same >= 0.9, same
    # global ids are valid rows; serve_graph estimates itself
    assert bool(((gi >= -1) & (gi < N)).all())
    gi2, gd2 = fns["serve_graph"](db, qs, progs, valid)
    assert torch.equal(gi2, gi) and torch.equal(gd2, gd)
    # each shard's results are merged in shard order: the f32 brute rows
    # equal one scan over all rows
    vecs = torch.as_tensor(z["vecs"])
    ints, floats = torch.as_tensor(z["ints"]), torch.as_tensor(z["floats"])
    one_i, one_d = P.prefbf.prefbf_topk(
        vecs, (vecs * vecs).sum(dim=1), ints, floats, qs, progs, k=K,
        chunk=N)
    assert torch.equal(bi, one_i.long())


# ---------------------------------------------------------------------------
# (e) the data-axis split does not move a bit
# ---------------------------------------------------------------------------
def test_data_axis_split_same_bits(built, ds):
    s, _, (port, _) = built
    vecs, _, _, _, ps = ds
    rng = np.random.default_rng(46)
    qs = rng.normal(size=(5, DIM)).astype(np.float32)   # odd: one pad row
    backs = [P.ShardedBackend(pdist.make_mesh((nd, s), device="cpu"), port,
                              ps) for nd in (1, 2)]
    for flt in (P.paper_filters(ps)["equality_int"],
                P.paper_filters(ps)["range_50"]):
        for force in (None, "graph", "brute"):
            opts = P.SearchOptions(k=K, ef=48, force=force)
            a, b = (P.router.execute(be, qs, flt, opts) for be in backs)
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.dists.view(np.uint32),
                                          b.dists.view(np.uint32))
            np.testing.assert_array_equal(a.p_hat.view(np.uint32),
                                          b.p_hat.view(np.uint32))


def test_make_mesh_devices():
    m = pdist.make_mesh((2, 3), device="cpu")
    assert m.shape == {"data": 2, "model": 3}
    assert m.devices.shape == (2, 3) and m.first_device.type == "cpu"
    m = pdist.make_mesh((1, 2), device=[["cpu", "cpu"]])
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    with pytest.raises(ValueError, match="devices"):
        pdist.make_mesh((1, 3), device=[["cpu", "cpu"]])


def test_make_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdist.make_mesh((1, 2))


# ---------------------------------------------------------------------------
# (f) live index: empty-delta parity, upsert / delete / both merge shapes
# ---------------------------------------------------------------------------
def _assert_bit_identical(r0, r1):
    np.testing.assert_array_equal(r0.ids, r1.ids)
    np.testing.assert_array_equal(r0.dists, r1.dists)
    np.testing.assert_array_equal(r0.routed_brute, r1.routed_brute)


def test_empty_delta_bit_parity_sharded(pair_1x1, ds):
    _, port = pair_1x1
    vecs, _, _, _, ps = ds
    be = P.ShardedBackend(port.mesh, port.sharded, ps)
    rng = np.random.default_rng(31)
    qs = rng.normal(size=(6, DIM)).astype(np.float32)
    flt = PF.Equality("i0", 3)
    for force in (None, "graph", "brute"):
        opts = P.SearchOptions(k=K, ef=64, force=force)
        before = P.router.execute(be, qs, flt, opts)
        assert be.delete([10 ** 9]) == 0
        after = P.router.execute(be, qs, flt, opts)
        _assert_bit_identical(before, after)


# small: each merge rebuilds or grows a graph through both packages' bulk
# graph builds, and the JAX one compiles its search per wave shape
LIVE_N = 128
LIVE_HNSW = dict(M=8, efc=48, seed=3)


def _live_data(filters):
    rng = np.random.default_rng(21)
    vecs = rng.normal(size=(LIVE_N, DIM)).astype(np.float32)
    return vecs, filters.random_attributes(filters.paper_schema(), LIVE_N,
                                           seed=13)


def _live_script(pkg, be, vecs, attrs) -> dict:
    """tests/test_mutation.py:213's script, then a second merge into the
    headroom the first one reserved, on ``be`` of either package (``pkg``
    its ``core``); returns what each step served and the host arrays after
    each merge."""
    col = attrs.schema.int_index("i0")
    row = int(np.nonzero(attrs.ints[:, col] == 3)[0][0])

    def matching(count):
        return (np.tile(attrs.ints[row], (count, 1)),
                np.tile(attrs.floats[row], (count, 1)))

    q = np.random.default_rng(47).normal(size=(1, DIM)).astype(np.float32)
    flt = pkg.filters.Equality("i0", 3)
    rec = {}

    def serve(step, **kw):
        for force in ("graph", "brute"):
            r = pkg.router.execute(be, q, flt, pkg.SearchOptions(
                k=K, ef=64, force=force, **kw))
            rec[f"{step}_{force}" + ("_pq" if kw else "")] = r.ids

    def merged(step):
        out = be.merge(wave=256)
        rec[step] = np.array([out["merged_slots"], out["merged_live"],
                              out["n"], out["incremental"]])
        rec[step + "_shard_versions"] = np.array(be.shard_versions())
        rec[step + "_versions"] = np.array(sorted(be.versions().items()),
                                           dtype=object).astype(str)
        rec[step + "_live_stats"] = np.array(sorted(be.live_stats().items()),
                                             dtype=object).astype(str)
        for key, a in be.sharded.arrays.items():
            rec[f"{step}_arr_{key}"] = np.asarray(a)

    rec["ids"] = np.asarray(be.upsert(
        np.concatenate([q + 1e-3, q + 2e-3, q + 3e-3]), *matching(3)))
    serve("upsert")
    rec["deleted"] = np.array([be.delete([int(rec["ids"][0])])])
    serve("delete")
    merged("merge1")
    serve("merge1")
    serve("merge1", use_pq=True)
    rec["ids2"] = np.asarray(be.upsert(
        np.concatenate([q + 4e-4, q + 5e-3]), *matching(2)))
    rec["deleted2"] = np.array([be.delete([int(rec["ids"][1])])])
    merged("merge2")
    serve("merge2")
    return rec


def test_sharded_upsert_delete_merge(ref_run):
    """The live script through the port: the upserted row is found, a
    deleted id never comes back, a full merge then an incremental one (only
    the last shard's version moves); what each step serves on the brute
    route and the host arrays after each merge equal the JAX package's
    (Delta_d to 1e-6: the bulk build's distances differ from XLA's in the
    last f32 bits, tests/test_torch_live.py)."""
    z = ref_run()
    ref = {k[5:]: v for k, v in z.items() if k.startswith("live_")}
    vecs, attrs = _live_data(PF)
    be = P.ShardedBackend.build(
        vecs, attrs, pdist.make_mesh((1, 1), device="cpu"),
        P.BuildSpec(hnsw=P.HnswParams(**LIVE_HNSW),
                    quant=P.QuantSpec(**QUANT)),
        codebook=PQCodebook(z["codebook"], DIM))
    got = _live_script(P, be, vecs, attrs)
    assert sorted(got) == sorted(ref)
    for key, want in ref.items():
        if key.endswith("_arr_delta_d"):
            np.testing.assert_allclose(got[key], want, rtol=1e-6)
        elif key.endswith("_graph") or key.endswith("_graph_pq"):
            continue
        else:
            np.testing.assert_array_equal(got[key], want, err_msg=key)
    ids, ids2 = got["ids"], got["ids2"]
    for force in ("graph", "brute"):
        assert got[f"upsert_{force}"][0, 0] == ids[0], force
        for step in ("delete", "merge1"):
            assert ids[0] not in got[f"{step}_{force}"], (step, force)
            assert got[f"{step}_{force}"][0, 0] == ids[1], (step, force)
        assert got[f"merge2_{force}"][0, 0] == ids2[0], force
        assert not np.isin(got[f"merge2_{force}"], ids[:2]).any(), force
    assert got["merge1_brute_pq"][0, 0] == ids[1]
    assert got["merge1"][3] == 0 and got["merge1"][0] == 3
    assert got["merge2"][3] == 1 and got["merge2"][0] == 2
    sv1, sv2 = got["merge1_shard_versions"], got["merge2_shard_versions"]
    assert sv2[-1] == sv1[-1] + 2 and (sv2[:-1] == sv1[:-1]).all()
    assert be.live_stats()["delta_rows"] == 0


def test_pick_capacity_keeps_tail_in_last_shard(pair_1x1, ds):
    _, port = pair_1x1
    be = P.ShardedBackend(pdist.make_mesh((1, 4), device="cpu"),
                          pdist.ShardedFavorArrays(
                              port.sharded.arrays, 4, N // 4,
                              port.sharded.sample_rows, port.quant),
                          ds[4])
    for n_tot, cnt in ((2003, 3), (2400, 400), (2400, 5000)):
        cap = be._pick_capacity(n_tot, cnt)
        assert cap % 4 == 0 and cap >= n_tot
        assert cap - n_tot < cap // 4          # the tail fits one shard


# ---------------------------------------------------------------------------
# (g) the cache and the engine over the sharded backend
# ---------------------------------------------------------------------------
def test_caching_backend_wraps_sharded(pair_1x1, ds):
    _, port = pair_1x1
    _, _, _, _, ps = ds
    be = P.ShardedBackend(port.mesh, port.sharded, ps)
    cb = CachingBackend(be, P.CacheSpec())
    rng = np.random.default_rng(55)
    qs = rng.normal(size=(4, DIM)).astype(np.float32)
    opts = P.SearchOptions(k=K, ef=64)
    for flt in (P.paper_filters(ps)["equality_int"],
                PF.And(PF.Equality("i0", 2), PF.Range("f0", 5.0, 15.0))):
        r0 = P.router.execute(be, qs, flt, opts)
        cold = P.router.execute(cb, qs, flt, opts)
        warm = P.router.execute(cb, qs, flt, opts)
        np.testing.assert_array_equal(r0.ids, cold.ids)
        np.testing.assert_array_equal(r0.ids, warm.ids)
    # the candidate layer found the sharded corpus view
    view = cb._corpus()
    assert view is not None
    np.testing.assert_array_equal(view[0], port.sharded.arrays["vectors"])
    be.bump_version()
    r1 = P.router.execute(cb, qs, P.paper_filters(ps)["equality_int"], opts)
    assert cb.invalidations == 1 and r1.ids.shape == (4, K)
    assert isinstance(cb, P.Backend)


def test_serve_engine_over_sharded_backend(pair_1x1, ds):
    """The reference's acceptance bar: ServeEngine runs unmodified over
    ShardedBackend, here with the responses equal to ``router.execute``."""
    _, port = pair_1x1
    _, _, _, _, ps = ds
    eng = ServeEngine(port, P.SearchOptions(k=5, ef=48, use_pq=True),
                      max_batch=8)
    rng = np.random.default_rng(42)
    flts = list(P.paper_filters(ps).values())
    qs = rng.normal(size=(20, DIM)).astype(np.float32)
    rids = [eng.submit(qs[i], flts[i % len(flts)]) for i in range(20)]
    out = eng.run()
    assert sorted(r.rid for r in out) == sorted(rids)
    assert eng.stats["graph"] + eng.stats["brute"] == 20
    by = {r.rid: r for r in out}
    for j, rid in enumerate(rids):
        one = P.router.execute(port, qs[j:j + 1], flts[j % len(flts)],
                               P.SearchOptions(k=5, ef=48, use_pq=True))
        np.testing.assert_array_equal(by[rid].ids, one.ids[0])


# ---------------------------------------------------------------------------
# (h) the public API of repro.core the port lacked
# ---------------------------------------------------------------------------
def test_core_exports_cover_reference():
    assert set(R.__all__) <= set(P.__all__)
    for name in ("Backend", "Scorer", "exclusion_compose", "ShardedBackend"):
        assert getattr(P, name) is not None


def test_scorers_satisfy_protocol_and_match_reference():
    g = {"centroids": np.zeros((8, 32, 2), np.float32)}
    for pc, rc in ((P.ExactScorer, rscoring.ExactScorer),
                   (P.PqAdcScorer, rscoring.PqAdcScorer),
                   (P.SqScorer, rscoring.SqScorer)):
        s = pc()
        assert isinstance(s, P.Scorer)
        assert s.required_keys() == rc().required_keys()
        assert s.kind == rc.kind and s.exact == rc.exact
    for bf16 in (True, False):
        assert P.PqAdcScorer(lut_bf16=bf16).lut_bytes(g, 7) == \
            rscoring.PqAdcScorer(lut_bf16=bf16).lut_bytes(g, 7)
    assert not isinstance(object(), P.Scorer)


def test_exclusion_compose_bits_and_class_order():
    rng = np.random.default_rng(3)
    d = rng.random((6, 32)).astype(np.float32) * 4
    td = rng.random((6, 32)) < 0.4
    D = (rng.random((6, 1)) * 3).astype(np.float32)
    want = np.asarray(rscoring.exclusion_compose(jnp.asarray(d),
                                                 jnp.asarray(td),
                                                 jnp.asarray(D)))
    got = P.exclusion_compose(torch.as_tensor(d), torch.as_tensor(td),
                              torch.as_tensor(D)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # order within each class is unchanged (tests/test_scoring.py:140)
    for row in range(6):
        for cls in (True, False):
            sel = td[row] == cls
            np.testing.assert_array_equal(
                np.argsort(got[row][sel], kind="stable"),
                np.argsort(d[row][sel], kind="stable"))


def test_estimate_selectivity_matches_reference(ds):
    _, ra, _, rs, ps = ds
    samp = slice(0, 300)
    ints, floats = ra.ints[samp], ra.floats[samp]
    rprogs = [RF.compile_filter(f, rs) for f in R.paper_filters(rs).values()]
    pprogs = [PF.compile_filter(f, ps) for f in P.paper_filters(ps).values()]
    for rp, pp in zip(rprogs, pprogs):
        assert psel.estimate_selectivity(pp, ints, floats) == \
            rsel.estimate_selectivity(rp, ints, floats)
        want = np.asarray(rsel.estimate_selectivity(
            rp, jnp.asarray(ints), jnp.asarray(floats), xp=jnp))
        got = psel.estimate_selectivity(pp, torch.as_tensor(ints),
                                        torch.as_tensor(floats))
        assert got.dtype == torch.float32 and got.numpy() == want
    rst = RF.stack_programs(rprogs)
    np.testing.assert_array_equal(
        psel.estimate_selectivity_batched(rst, ints, floats),
        rsel.estimate_selectivity_batched(rst, ints, floats))
    want = np.asarray(rsel.estimate_selectivity_batched(
        {k: jnp.asarray(v) for k, v in rst.items()}, jnp.asarray(ints),
        jnp.asarray(floats), xp=jnp))
    got = psel.estimate_selectivity_batched(
        _port_programs(list(P.paper_filters(ps).values()), ps),
        torch.as_tensor(ints), torch.as_tensor(floats))
    np.testing.assert_array_equal(got.numpy(), want)


def test_backends_satisfy_protocol(pair_1x1):
    _, port = pair_1x1
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(64, 8)).astype(np.float32)
    attrs = PF.random_attributes(PF.paper_schema(), 64, seed=1)
    fi = P.FavorIndex.build(vecs, attrs, P.HnswParams(M=4, efc=16),
                            device="cpu")
    for be in (fi.backend, CachingBackend(fi.backend), port,
               CachingBackend(port)):
        assert isinstance(be, P.Backend), type(be).__name__
    assert not isinstance(object(), P.Backend)
