"""Port parity, live index: ``repro_torch.index`` and the ``FavorIndex`` /
``LocalBackend`` mutation API against the JAX package's
(``tests/test_mutation.py``).  Each test runs one mutation script through
both packages, on the same HNSW graph carried across, and compares.

Bars: ids identical on the brute routes (exact f32, and ``use_pq`` /
SQ with the JAX codebook and codes); on the f32 graph route ids identical
(the exact scorer is bit-stable on this corpus); the merged neighbour
arrays and levels identical to the JAX ``bulk_add``'s for one seed (the
port's CPU candidate search returns the JAX package's ids; its distances
differ from XLA's in the last f32 bits, so Delta_d agrees to 1e-6
relative); deleted ids never returned on any route."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import BuildSpec as RBuild  # noqa: E402
from repro.core import FavorIndex as RIndex  # noqa: E402
from repro.core import HnswParams as RParams  # noqa: E402
from repro.core import LocalBackend as RBackend  # noqa: E402
from repro.core import QuantSpec as RQuant  # noqa: E402
from repro.core import SearchOptions as ROpts  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import router as r_router  # noqa: E402
from repro.index import ComponentEpochs as RE  # noqa: E402
from repro.index import DeltaSegment as RDelta  # noqa: E402
from repro.index import compose_topk as r_compose  # noqa: E402
from repro.index import bulk as r_bulk  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import BuildSpec, FavorIndex, HnswParams  # noqa: E402
from repro_torch.core import QuantSpec, SearchOptions  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core import router  # noqa: E402
from repro_torch.core.hnsw import HnswIndex  # noqa: E402
from repro_torch.index import (ComponentEpochs, DeltaSegment,  # noqa: E402
                               bulk, compose_topk, compose_topk_dev)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 10
PARAMS = dict(M=8, efc=48, seed=3)
QUANT = {"pq": dict(kind="pq", m=8, nbits=5, train_iters=8, rerank=4),
         "sq": dict(kind="sq", rerank=4)}


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(21)
    n, d = 768, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    attrs = RF.random_attributes(RF.paper_schema(), n, seed=13)
    return vecs, attrs


@pytest.fixture(scope="module")
def built(ds):
    """One JAX build of the corpus; every test re-wraps its graph."""
    vecs, attrs = ds
    return RIndex.build(vecs, attrs, RParams(**PARAMS))


@pytest.fixture(scope="module")
def codebooks(built, ds):
    _, attrs = ds
    return {kind: RIndex(built.index, attrs, RBuild(quant=RQuant(**kw)))
            for kind, kw in QUANT.items()}


def _port(ref, **kw):
    """The port's FavorIndex over a JAX index's state (graph, attributes,
    codebook and codes)."""
    idx, cb = ref.index, ref.codebook
    arrays = {}
    if cb is not None:
        arrays = ({"centroids": cb.centroids} if ref.quantize == "pq" else
                  {"lo": cb.lo, "scale": cb.scale})
        arrays["codes"] = np.asarray(ref._codes)[:idx.n]
    spec = (BuildSpec(quant=QuantSpec(**QUANT[ref.quantize]))
            if cb is not None else None)
    return from_reference_arrays(
        vectors=idx.vectors, levels=idx.levels, node_level=idx.node_level,
        entry_point=idx.entry_point, delta_d=idx.delta_d, params=idx.params,
        ints=ref.attrs.ints, floats=ref.attrs.floats, schema=ref.schema,
        norms=idx.norms, spec=spec, device="cpu", **arrays, **kw)


def _ref(built, attrs, kind=None, codebooks=None):
    """A JAX index over the built graph and ``attrs``."""
    if kind is None:
        return RIndex(built.index, attrs)
    src = codebooks[kind]
    return RIndex(built.index, attrs, RBuild(quant=RQuant(**QUANT[kind])),
                  codebook=src.codebook,
                  codes=np.asarray(src._codes)[:built.index.n])


def _pair(built, ds, kind=None, codebooks=None):
    """Fresh (JAX, port) indexes over the built graph."""
    ref = _ref(built, ds[1], kind, codebooks)
    return ref, _port(ref)


def _flt(value=3):
    return RF.Equality("i0", value), PF.Equality("i0", value)


def _matching(attrs, count=1, value=3):
    col = RF.paper_schema().int_index("i0")
    row = int(np.nonzero(attrs.ints[:, col] == value)[0][0])
    return (np.tile(attrs.ints[row], (count, 1)),
            np.tile(attrs.floats[row], (count, 1)))


def _run(pair, qs, force, **over):
    ref, port = pair
    rflt, pflt = _flt()
    r = r_router.execute(ref.backend, qs, rflt,
                         ROpts(k=K, ef=64, force=force, **over))
    p = router.execute(port.backend, qs, pflt,
                       SearchOptions(k=K, ef=64, force=force, **over))
    return r, p


def _assert_same(r, p, what):
    np.testing.assert_array_equal(p.ids, r.ids, err_msg=what)
    np.testing.assert_allclose(p.dists, r.dists, rtol=1e-5, atol=1e-5,
                               err_msg=what)


def _both(pair, method, *args, **kw):
    out = [getattr(x, method)(*args, **kw) for x in pair]
    if isinstance(out[0], np.ndarray):
        np.testing.assert_array_equal(out[1], out[0])
    else:
        assert out[1] == out[0], (method, out)
    return out[1]


def _exact_topk(vecs, queries, rows, k):
    """Host ground-truth top-k of ``queries`` over the ``rows`` subset."""
    ids = np.full((len(queries), k), -1, np.int64)
    if len(rows) == 0:
        return ids
    sub = vecs[rows]
    d = (np.sum(queries ** 2, 1)[:, None] + np.sum(sub ** 2, 1)[None, :]
         - 2.0 * queries @ sub.T)
    kk = min(k, len(rows))
    ids[:, :kk] = np.asarray(rows)[np.argsort(d, axis=1,
                                              kind="stable")[:, :kk]]
    return ids


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def test_component_epochs_match_reference():
    e, r = ComponentEpochs(), RE()
    for comps in (("vectors",), ("vectors", "graph"), ("attributes",)):
        assert e.bump(*comps) == r.bump(*comps)
    assert e.bump_all() == r.bump_all()
    assert e.as_dict() == r.as_dict() and e.total == r.total
    with pytest.raises(ValueError, match="unknown"):
        e.bump("codes")


def test_delta_segment_growth_and_kill():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(9, 4)).astype(np.float32)
    segs = [DeltaSegment(4, 2, 1, min_capacity=4),
            RDelta(4, 2, 1, min_capacity=4)]
    for d in segs:
        assert list(d.append(v[:3], np.zeros((3, 2), np.int32),
                             np.zeros((3, 1), np.float32),
                             np.arange(100, 103))) == [0, 1, 2]
        assert d._cap == 4
        d.append(v[3:], np.zeros((6, 2), np.int32),
                 np.zeros((6, 1), np.float32), np.arange(103, 109))
        assert d.count == 9 and d._cap == 16          # pow-2 growth
        assert d.kill(101) and not d.kill(101) and not d.kill(999)
        assert d.live_count == 8 and d.has(100) and not d.has(101)
    p, r = segs
    assert p.stats() == r.stats()
    for name in ("vectors", "norms", "ints", "floats", "ids", "alive"):
        np.testing.assert_array_equal(getattr(p, name), getattr(r, name))
    # the scan: exact top-k over the live rows, dead slot 1 never returned
    qs = rng.normal(size=(3, 4)).astype(np.float32)
    rprog = {k: jnp.asarray(v_) for k, v_ in RF.stack_programs(
        [RF.compile_filter(RF.TrueFilter(), RF.Schema((
            RF.ColumnSpec("a", "int", 4), RF.ColumnSpec("b", "int", 4),
            RF.ColumnSpec("c", "float"))))] * 3).items()}
    pprog = {k: torch.as_tensor(np.asarray(v_).astype(
        np.int64 if k == "imask" else np.asarray(v_).dtype))
        for k, v_ in rprog.items()}
    ri, rd = r.scan(qs, rprog, k=5)
    pi, pd = p.scan(torch.as_tensor(qs), pprog, k=5)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=1e-5)
    assert 101 not in pi


def test_compose_topk_merge_and_ties():
    cases = [
        (np.array([[5, 7, -1]]), np.array([[1.0, 3.0, np.inf]], np.float32),
         np.array([[9, -1, -1]]), np.array([[2.0, np.inf, np.inf]],
                                           np.float32), 3),
        # ties prefer the base side
        (np.array([[5]]), np.array([[2.0]], np.float32), np.array([[9]]),
         np.array([[2.0]], np.float32), 1),
    ]
    for bi, bd, ei, ed, k in cases:
        want = r_compose(bi, bd, ei, ed, k)
        host = compose_topk(bi, bd, ei, ed, k)
        dev = compose_topk_dev(torch.as_tensor(bi), torch.as_tensor(bd),
                               torch.as_tensor(ei), torch.as_tensor(ed), k)
        for got in (host, tuple(t.numpy() for t in dev)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    assert compose_topk(*cases[1][:4], 1)[0].tolist() == [[5]]


# ---------------------------------------------------------------------------
# mutation scripts through both packages
# ---------------------------------------------------------------------------
def test_empty_delta_bit_parity(built, ds):
    pair = _pair(built, ds)
    qs = np.random.default_rng(31).normal(size=(6, 16)).astype(np.float32)
    for force in (None, "graph", "brute"):
        _, before = _run(pair, qs, force)
        assert _both(pair, "delete", [10 ** 9]) == 0
        assert pair[1].live_view() is not None
        r, after = _run(pair, qs, force)
        np.testing.assert_array_equal(after.ids, before.ids)
        np.testing.assert_array_equal(after.dists, before.dists)
        _assert_same(r, after, force)
    assert "alive" not in pair[1].g      # nothing died: static path kept


@pytest.mark.parametrize("route", ["f32", "use_pq_pq", "graph_pq",
                                   "use_pq_sq", "graph_sq"])
def test_upsert_found_delete_gone_all_routes(built, ds, codebooks, route):
    vecs, attrs = ds
    kind = None if route == "f32" else route[-2:]
    over = ({} if kind is None else
            {"use_pq": True} if route.startswith("use_pq") else
            {"graph_quant": kind})
    pair = _pair(built, ds, kind, codebooks)
    q = np.random.default_rng(41).normal(size=(1, 16)).astype(np.float32)
    ints, floats = _matching(attrs)
    nid = int(_both(pair, "upsert", q + 1e-3, ints, floats)[0])
    assert nid == vecs.shape[0]                 # positional id allocation
    for force in (None, "graph", "brute"):
        r, p = _run(pair, q, force, **over)
        assert p.ids[0, 0] == nid, force        # nearest by construction
        _assert_same(r, p, force)
    assert _both(pair, "delete", [nid]) == 1
    for force in (None, "graph", "brute"):
        r, p = _run(pair, q, force, **over)
        assert nid not in p.ids, force
        _assert_same(r, p, force)
    # replace= retires the old id and issues a fresh handle
    rid = int(_both(pair, "upsert", q + 2e-3, ints, floats)[0])
    rid2 = int(_both(pair, "upsert", q + 3e-3, ints, floats,
                     replace=[rid])[0])
    assert rid2 != rid
    r, p = _run(pair, q, "brute", **over)
    assert rid2 in p.ids and rid not in p.ids
    _assert_same(r, p, "replace")
    assert pair[1].live_stats() == pair[0].live_stats()


@pytest.mark.parametrize("route", ["f32", "graph_pq", "graph_sq"])
def test_base_delete_gone_on_graph_route(built, ds, codebooks, route):
    kind = None if route == "f32" else route[-2:]
    over = {} if kind is None else {"graph_quant": kind}
    pair = _pair(built, ds, kind, codebooks)
    q = np.random.default_rng(43).normal(size=(4, 16)).astype(np.float32)
    _, p0 = _run(pair, q, "graph", **over)
    victims = [int(x) for x in p0.ids[:, 0]] + [int(p0.ids[0, 1])]
    assert _both(pair, "delete", victims) == len(set(victims))
    for force in ("graph", "brute"):
        r, p = _run(pair, q, force, **over)
        assert not np.isin(p.ids, victims).any(), force
        if force == "brute" or kind is None:
            _assert_same(r, p, force)
        else:   # quantized graph route: recall against the JAX package's
            rec = [len(set(p.ids[i]) & set(r.ids[i])) / K
                   for i in range(len(q))]
            assert np.mean(rec) >= 0.9, rec
    # the static arrays stayed put: only the alive mask and the norms moved
    assert not bool(pair[1].g["alive"][victims[0]])
    assert torch.isinf(pair[1]._pf[1][victims]).all()
    assert torch.isfinite(pair[1].g["norms"][victims]).all()


def test_scoped_epochs_and_no_graph_reupload(built, ds):
    vecs, attrs = ds
    pair = _pair(built, ds)
    port = pair[1]
    g_vec, g_nb, g_ai = (port.g["vectors"], port.g["neighbors0"],
                         port.g["attrs_int"])
    assert _both(pair, "versions") == {"vectors": 0, "attributes": 0,
                                       "graph": 0}
    ints, floats = _matching(attrs)
    _both(pair, "upsert", np.zeros((1, 16), np.float32), ints, floats)
    assert _both(pair, "versions") == {"vectors": 1, "attributes": 0,
                                       "graph": 0}
    _both(pair, "delete", [10 ** 9])                 # found nothing
    assert _both(pair, "versions")["vectors"] == 1
    assert _both(pair, "delete", [0]) == 1
    # delete-only: the uploaded arrays stay put, the mask overlays them
    assert port.g["vectors"] is g_vec and port.g["neighbors0"] is g_nb
    assert port.g["attrs_int"] is g_ai and not bool(port.g["alive"][0])
    out = _both(pair, "merge", wave=256)
    assert out["merged_slots"] == 1
    # merge: sample untouched -> the attributes epoch does not move
    assert _both(pair, "versions") == {"vectors": 3, "attributes": 0,
                                       "graph": 1}
    assert _both(pair, "version") == 4



@pytest.mark.parametrize("kind", [None, "pq"])
def test_scoped_bump_reuploads_only_its_component(built, ds, codebooks,
                                                  kind):
    """The scoped half of the JAX package's re-upload test: a component
    bump re-uploads only that component's device tensors (the padded scan
    arrays and the graph views over them), reuses the rest, and serves an
    in-place edit on both routes with the JAX package's ids; a ``vectors``
    bump keeps the PQ codes aligned; a full bump re-uploads everything."""
    vecs, attrs = ds
    own = RF.AttributeTable(attrs.schema, attrs.ints.copy(),
                            attrs.floats.copy())
    pair = _pair(built, (vecs, own), kind, codebooks)
    ref, port = pair
    over = {} if kind is None else {"use_pq": True}
    q = np.random.default_rng(47).normal(size=(6, 16)).astype(np.float32)
    assert _both(pair, "delete", [0]) == 1

    def same_results():
        # the JAX package's bump_version never re-uploads its padded scan
        # arrays (ROADMAP.md section 3), so the brute route is held to a
        # JAX index built on the current attributes
        fresh = _ref(built, RF.AttributeTable(
            own.schema, own.ints.copy(), own.floats.copy()), kind, codebooks)
        fresh.delete([0])
        out = {}
        for force, r_side in (("graph", ref), ("brute", fresh)):
            r, p = _run((r_side, port), q, force, **over)
            _assert_same(r, p, f"{force} {over}")
            assert 0 not in p.ids
            out[force] = p.ids
        return out

    before = same_results()
    g0, pf0 = dict(port.g), port._pf
    col = own.schema.int_index("i0")
    edited = (own.ints[:, col] + 1) % 5
    for side in pair:
        side.attrs.ints[:, col] = edited
    assert _both(pair, "bump_version", ("attributes",)) == 2
    for key in ("vectors", "norms", "neighbors0", "upper", "alive"):
        assert port.g[key] is g0[key], key
    assert port._pf[0] is pf0[0] and port._pf[1] is pf0[1]
    assert port._pf[2] is not pf0[2] and port.g["attrs_int"] is not g0[
        "attrs_int"]
    np.testing.assert_array_equal(port.g["attrs_int"].numpy(),
                                  port.attrs.ints)
    assert port.g["attrs_int"].data_ptr() == port._pf[2].data_ptr()
    after = same_results()
    for force in ("graph", "brute"):   # the edit is served
        assert not np.array_equal(after[force], before[force]), force

    g1, pf1 = dict(port.g), port._pf
    _both(pair, "bump_version", ("vectors",))
    assert port.g["vectors"] is not g1["vectors"]
    assert port._pf[0] is not pf1[0] and port._pf[1] is not pf1[1]
    for key in ("attrs_int", "attrs_float", "neighbors0", "alive"):
        assert port.g[key] is g1[key], key
    assert port._pf[2] is pf1[2] and port._pf[3] is pf1[3]
    assert torch.isinf(port._pf[1][0]) and torch.isfinite(port._pn0[0])
    if kind is not None:   # the codes stay aligned with the graph arrays
        np.testing.assert_array_equal(port.g["codes"].numpy(),
                                      np.asarray(ref.g["codes"]))
    for force, ids in same_results().items():
        np.testing.assert_array_equal(ids, after[force])

    g2, pf2 = dict(port.g), port._pf
    _both(pair, "bump_version")
    for key in ("vectors", "norms", "attrs_int", "attrs_float",
                "neighbors0", "upper", "alive"):
        assert port.g[key] is not g2[key], key
    assert all(a is not b for a, b in zip(port._pf, pf2))
    assert _both(pair, "versions") == {"vectors": 3, "attributes": 2,
                                       "graph": 1}
    same_results()
    with pytest.raises(ValueError, match="unknown epoch component"):
        port.bump_version(("bogus",))

def _same_graph(p: HnswIndex, r):
    assert p.n == r.n and p.max_level == r.max_level
    assert p.entry_point == r.entry_point
    np.testing.assert_array_equal(p.node_level, r.node_level)
    assert len(p.levels) == len(r.levels)
    for lp, lr in zip(p.levels, r.levels):
        np.testing.assert_array_equal(lp, lr)
    # Delta_d is a sum over the candidate distances of every linked node:
    # the port's CPU gather adds each d-long dot in torch's order, XLA in
    # its own, so the curves differ in the last f32 bits (the rows they
    # rank, and so the neighbour arrays above, do not)
    assert p.delta_d == pytest.approx(r.delta_d, rel=1e-6)


def test_merge_folds_to_equivalent_static_index(built, ds):
    vecs, attrs = ds
    pair = _pair(built, ds)
    rng = np.random.default_rng(61)
    extra = rng.normal(size=(40, 16)).astype(np.float32)
    ints, floats = _matching(attrs, count=40)
    ids = _both(pair, "upsert", extra, ints, floats)
    col = RF.paper_schema().int_index("i0")
    dead_base = [int(np.nonzero(attrs.ints[:, col] == 3)[0][0])]
    dead_delta = [int(ids[5])]
    assert _both(pair, "delete", dead_base + dead_delta) == 2
    # the graph route's waves before the merge, and after it below, are
    # the JAX package's: a change of wave count across a merge is the
    # merged graph's, not the port's
    q0 = np.random.default_rng(62).normal(size=(8, 16)).astype(np.float32)
    r, p = _run(pair, q0, "graph")
    np.testing.assert_array_equal(p.waves, r.waves)
    np.testing.assert_array_equal(p.ids, r.ids)
    out = _both(pair, "merge", wave=256)
    assert out["merged_slots"] == 40 and out["n"] == vecs.shape[0] + 40
    st = _both(pair, "live_stats")
    assert st["delta_rows"] == 0 and st["dead_base_rows"] == 2
    # the merged graph is the JAX package's, array for array
    _same_graph(pair[1].index, pair[0].index)
    # ground truth: exact top-k over live matching rows of the merged corpus
    all_vecs = np.concatenate([vecs, extra])
    all_i0 = np.concatenate([attrs.ints[:, col], ints[:, col]])
    alive = np.ones((len(all_vecs),), bool)
    alive[dead_base + dead_delta] = False
    rows = np.nonzero((all_i0 == 3) & alive)[0]
    qs = rng.normal(size=(5, 16)).astype(np.float32)
    want = _exact_topk(all_vecs, qs, rows, K)
    r, p = _run(pair, qs, "brute")
    np.testing.assert_array_equal(p.ids, want)
    _assert_same(r, p, "brute")
    r, p = _run(pair, qs, "graph")
    _assert_same(r, p, "graph")
    np.testing.assert_array_equal(p.waves, r.waves)
    np.testing.assert_array_equal(p.hops, r.hops)
    r0, p0 = _run(pair, q0, "graph")
    np.testing.assert_array_equal(p0.waves, r0.waves)
    overlap = np.mean([len(set(p.ids[i][p.ids[i] >= 0]) & set(want[i])) / K
                       for i in range(len(qs))])
    assert overlap >= 0.9
    assert not np.isin(p.ids, dead_delta + dead_base).any()


def test_merge_reencodes_codes(built, ds, codebooks):
    _, attrs = ds
    for kind in ("pq", "sq"):
        pair = _pair(built, ds, kind, codebooks)
        rng = np.random.default_rng(62)
        ints, floats = _matching(attrs, count=24)
        _both(pair, "upsert", rng.normal(size=(24, 16)).astype(np.float32),
              ints, floats)
        _both(pair, "merge", wave=256)
        ref, port = pair
        n = ref.index.n
        np.testing.assert_array_equal(port._codes[:n].numpy(),
                                      np.asarray(ref._codes)[:n])
        assert port.g["codes"].shape[0] == n
        qs = rng.normal(size=(4, 16)).astype(np.float32)
        r, p = _run(pair, qs, "brute", use_pq=True)
        _assert_same(r, p, kind)


def test_empty_index_then_delta_only():
    rng = np.random.default_rng(67)
    d = 16
    rattrs0 = RF.random_attributes(RF.paper_schema(), 0, seed=1)
    ref = RIndex.build(np.zeros((0, d), np.float32), rattrs0,
                       RParams(**PARAMS))
    port = FavorIndex.build(np.zeros((0, d), np.float32),
                            PF.random_attributes(PF.paper_schema(), 0,
                                                 seed=1),
                            HnswParams(**PARAMS), device="cpu")
    pair = (ref, port)
    qs = rng.normal(size=(3, d)).astype(np.float32)
    for force in (None, "brute"):
        r, p = _run(pair, qs, force)
        assert (p.ids == -1).all() and np.isinf(p.dists).all()
    n = 64
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    attrs = RF.random_attributes(RF.paper_schema(), n, seed=5)
    ids = _both(pair, "upsert", vecs, attrs.ints, attrs.floats)
    assert ids.tolist() == list(range(n))
    for force in (None, "graph", "brute"):
        r, p = _run(pair, qs, force)
        _assert_same(r, p, force)
    # parity with a from-scratch static build over the same rows
    rflt, _ = _flt()
    want = r_router.execute(RBackend(RIndex.build(vecs, attrs,
                                                  RParams(**PARAMS))),
                            qs, rflt, ROpts(k=K, ef=64, force="brute"))
    np.testing.assert_array_equal(p.ids, want.ids)
    # merge the delta into the empty base: a graph built from the delta
    _both(pair, "merge", wave=256)
    _same_graph(port.index, ref.index)
    r, p = _run(pair, qs, "graph")
    _assert_same(r, p, "graph after merge")


def test_single_element_index_mutation():
    rng = np.random.default_rng(71)
    v = rng.normal(size=(1, 16)).astype(np.float32)
    attrs = RF.random_attributes(RF.paper_schema(), 1, seed=2)
    ref = RIndex.build(v, attrs, RParams(**PARAMS))
    port = _port(ref)
    q = rng.normal(size=(1, 16)).astype(np.float32)
    opts = SearchOptions(k=K, ef=64)
    r = router.execute(port.backend, q, PF.TrueFilter(), opts)
    assert r.ids[0, 0] == 0
    assert port.delete([0]) == 1
    r = router.execute(port.backend, q, PF.TrueFilter(), opts)
    assert (r.ids == -1).all()


def test_delete_everything_then_search(built, ds):
    vecs, _ = ds
    pair = _pair(built, ds)
    assert _both(pair, "delete", list(range(vecs.shape[0]))) == vecs.shape[0]
    qs = np.random.default_rng(73).normal(size=(3, 16)).astype(np.float32)
    for force in ("graph", "brute"):
        r = router.execute(pair[1].backend, qs, PF.TrueFilter(),
                           SearchOptions(k=K, ef=64, force=force))
        assert (r.ids == -1).all() and np.isinf(r.dists).all(), force


def test_bulk_add_after_finalize_matches_reference(ds):
    vecs, _ = ds
    rp = RParams(**PARAMS)
    rgrown = r_bulk.build_hnsw_bulk(vecs[:256], rp)
    pgrown = bulk.build_hnsw_bulk(vecs[:256], HnswParams(**PARAMS),
                                  device="cpu")
    _same_graph(pgrown, rgrown)
    rgrown2 = r_bulk.bulk_add(rgrown, vecs[256:384], wave=64)
    pgrown2 = bulk.bulk_add(pgrown, vecs[256:384], wave=64, device="cpu")
    _same_graph(pgrown2, rgrown2)
    # every appended row is reachable and nearest-to-itself
    attrs = PF.random_attributes(PF.paper_schema(), 384, seed=13)
    fi = FavorIndex(pgrown2, attrs, device="cpu")
    r = router.execute(fi.backend, vecs[256:264], PF.TrueFilter(),
                       SearchOptions(k=1, ef=64, pbar_min=0.0,
                                     force="graph"))
    np.testing.assert_array_equal(r.ids[:, 0], np.arange(256, 264))


def test_bulk_build_recall_matches_sequential(ds):
    vecs, _ = ds
    n = 512
    attrs = PF.random_attributes(PF.paper_schema(), n, seed=13)
    seq = FavorIndex.build(vecs[:n], attrs, HnswParams(**PARAMS),
                           device="cpu")
    blk = FavorIndex(bulk.build_hnsw_bulk(vecs[:n], HnswParams(**PARAMS),
                                          wave=128, device="cpu"),
                     attrs, device="cpu")
    qs = np.random.default_rng(79).normal(size=(32, 16)).astype(np.float32)
    want = _exact_topk(vecs[:n], qs, np.arange(n), K)
    rec = {}
    for name, fi in (("seq", seq), ("bulk", blk)):
        r = router.execute(fi.backend, qs, PF.TrueFilter(),
                           SearchOptions(k=K, ef=64, force="graph"))
        rec[name] = np.mean([len(set(r.ids[i]) & set(want[i])) / K
                             for i in range(len(qs))])
    assert rec["bulk"] >= rec["seq"] - 0.05, rec
    assert rec["bulk"] >= 0.8, rec


def test_save_warns_on_unmerged_mutations_and_merged_moves(tmp_path, built,
                                                           ds):
    _, attrs = ds
    pair = _pair(built, ds)
    ints, floats = _matching(attrs)
    _both(pair, "upsert", np.zeros((1, 16), np.float32), ints, floats)
    with pytest.warns(UserWarning, match="unmerged live mutations"):
        pair[1].save(str(tmp_path / "dirty"))
    _both(pair, "merge", wave=256)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pair[1].save(str(tmp_path / "clean"))
    # a merged index moves to the JAX package unchanged
    back = RIndex.load(str(tmp_path / "clean"))
    _same_graph(pair[1].index, back.index)
    qs = np.random.default_rng(83).normal(size=(4, 16)).astype(np.float32)
    rflt, _ = _flt()
    want = r_router.execute(back.backend, qs, rflt, ROpts(k=K, ef=64,
                                                          force="brute"))
    _, p = _run(pair, qs, "brute")
    np.testing.assert_array_equal(p.ids, want.ids)
