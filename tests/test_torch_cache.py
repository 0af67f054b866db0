"""Port parity, cache subsystem: ``repro_torch.cache`` (``LruTtlCache``, the
three layers, ``CachingBackend``) and ``CacheSpec`` against the JAX
package's (``tests/test_cache.py``), on ``small_index`` carried across with
``repro_torch.convert``.

Every ``CachingBackend`` scenario runs the same traffic, made from a numpy
seed, through both packages' caches under fake clocks and compares.  Bars,
from ``ROADMAP.md`` section 3: brute ids identical, graph ids identical on
``small_index``, p_hat and routes identical (bits), distances within
rtol/atol 1e-5 (candidate-block hits are the same numpy scan in both
packages, so bit-identical), and the ``cache_stats()`` dicts equal.  The
pure-Python modules (``lru``, ``layers``) are pinned to their originals
source for source.  The wrapper over the sharded backend is held in
``tests/test_torch_sharded.py``."""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cache import CachingBackend as RCaching  # noqa: E402
from repro.core import BatchSpec as RBatch  # noqa: E402
from repro.core import BuildSpec as RBuild  # noqa: E402
from repro.core import CacheSpec as RCacheSpec  # noqa: E402
from repro.core import FavorIndex as RIndex  # noqa: E402
from repro.core import LocalBackend as RBackend  # noqa: E402
from repro.core import QuantSpec as RQuant  # noqa: E402
from repro.core import SearchOptions as ROpts  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import router as r_router  # noqa: E402
from repro.serving import ServeEngine as RServe  # noqa: E402
from repro_torch.cache import (CachingBackend, LruTtlCache,  # noqa: E402
                               SemanticResultCache)
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import (BatchSpec, BuildSpec, CacheSpec,  # noqa: E402
                              LocalBackend, QuantSpec, SearchOptions, router)
from repro_torch.core import filters as PF  # noqa: E402
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
QUANT = dict(kind="pq", m=4, nbits=5, train_iters=5, rerank=4)
RTOL = ATOL = 1e-5

class Pkg(SimpleNamespace):
    """One package's classes by role (hashable: keys the per-package
    dicts of a test)."""
    __hash__ = object.__hash__


R = Pkg(name="jax", F=RF, router=r_router, Caching=RCaching,
        CacheSpec=RCacheSpec, Backend=RBackend, Opts=ROpts, Batch=RBatch,
        Serve=RServe)
P = Pkg(name="port", F=PF, router=router, Caching=CachingBackend,
        CacheSpec=CacheSpec, Backend=LocalBackend, Opts=SearchOptions,
        Batch=BatchSpec, Serve=ServeEngine)


class FakeClock:
    """Settable fake clock (the layers' TTL clock)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class TickClock:
    """Monotonic fake: every call advances by ``tick`` seconds."""

    def __init__(self, tick=0.001):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _port_of(ref, **kw):
    """The port's FavorIndex (CPU) over a JAX index's state."""
    idx, cb = ref.index, ref.codebook
    arrays = {}
    if cb is not None:
        arrays = {"centroids": cb.centroids,
                  "codes": np.asarray(ref._codes)[:idx.n]}
        kw.setdefault("spec", BuildSpec(quant=QuantSpec(**QUANT)))
    return from_reference_arrays(
        vectors=idx.vectors, levels=idx.levels, node_level=idx.node_level,
        entry_point=idx.entry_point, delta_d=idx.delta_d, params=idx.params,
        ints=ref.attrs.ints, floats=ref.attrs.floats, schema=ref.schema,
        norms=idx.norms, device="cpu", **arrays, **kw)


@pytest.fixture(scope="module")
def port_index(small_index):
    return _port_of(small_index)


@pytest.fixture(scope="module")
def pq_pair(small_index, small_dataset):
    _, attrs, _ = small_dataset
    ref = RIndex(small_index.index, attrs, RBuild(quant=RQuant(**QUANT)))
    return ref, _port_of(ref)


def _fresh_pair(small_index, small_dataset):
    """A JAX FavorIndex over the session graph that a test may mutate (the
    session fixture stays untouched), and the port's copy of it."""
    _, attrs, _ = small_dataset
    ref = RIndex(small_index.index, attrs)
    return ref, _port_of(ref)


def _schema(ns):
    return ns.F.paper_schema()


def _tiny(ns):
    """The reference tests' low-selectivity filter (1.3 % of rows)."""
    return ns.F.And(ns.F.Equality("i0", 2), ns.F.Range("f0", 5.0, 15.0))


def _brute(ns):
    """A 0.2 % filter: the brute route under the default lambda."""
    return ns.F.And(ns.F.Equality("i0", 3), ns.F.Range("f0", 10, 12))


def _assert_same_results(p, r, msg=""):
    np.testing.assert_array_equal(p.ids, r.ids, err_msg=msg)
    np.testing.assert_allclose(p.dists, r.dists, rtol=RTOL, atol=ATOL,
                               err_msg=msg)
    np.testing.assert_array_equal(p.routed_brute, r.routed_brute,
                                  err_msg=msg)
    assert np.array_equal(p.p_hat.view(np.uint32),
                          r.p_hat.view(np.uint32)), msg


# ---------------------------------------------------------------------------
# the pure-Python copies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rel", ["cache/lru.py", "cache/layers.py",
                                 "serving/frontend/admission.py"])
def test_pure_python_copies_match_reference(rel):
    """The host-only modules are copies: pinned source for source (their
    relative imports resolve to each package's own options)."""
    ref = (ROOT / "src" / "repro" / rel).read_text()
    port = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert port == ref


def test_lru_evicts_least_recently_used():
    c = LruTtlCache(cap=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1          # touch: "b" is now LRU
    c.put("c", 3)
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3
    assert c.evictions == 1


def test_lru_ttl_expires_entries():
    clk = FakeClock()
    c = LruTtlCache(cap=8, ttl_s=10.0, clock=clk)
    c.put("a", 1)
    clk.t = 9.0
    assert c.get("a") == 1
    clk.t = 21.0
    assert c.get("a") is None
    assert c.expirations == 1 and c.misses == 1


def test_lru_validation_and_stats():
    with pytest.raises(ValueError, match="cap"):
        LruTtlCache(cap=0)
    with pytest.raises(ValueError, match="ttl_s"):
        LruTtlCache(cap=1, ttl_s=0)
    c = LruTtlCache(cap=4)
    c.put("a", None)                # None is a legal cached value
    assert "a" in c
    st = c.stats()
    assert st["size"] == 1 and st["cap"] == 4


def test_semantic_ttl_is_per_entry():
    """A hot key receiving fresh inserts must not keep old entries alive:
    entry age, not key age, decides expiry."""
    clk = FakeClock()
    cache = SemanticResultCache(CacheSpec(ttl_s=10.0), clock=clk)
    opts = SearchOptions(k=2)
    old_q = np.zeros((4,), np.float32)
    cache.put("sig", opts, old_q, [1, 2], [0.1, 0.2], 0.5, False)
    for step in range(1, 5):                    # keep the key hot past TTL
        clk.t = 4.0 * step
        q = np.full((4,), float(step), np.float32)
        cache.put("sig", opts, q, [1, 2], [0.1, 0.2], 0.5, False)
    assert clk.t == 16.0                        # old entry is past its TTL
    assert cache.get("sig", opts, old_q) is None
    assert cache.get("sig", opts, np.full((4,), 4.0, np.float32)) is not None


def test_cache_spec_validation():
    with pytest.raises(ValueError, match="selectivity_cap"):
        CacheSpec(selectivity_cap=0)
    with pytest.raises(ValueError, match="candidate_p_max"):
        CacheSpec(candidate_p_max=1.5)
    with pytest.raises(ValueError, match="ttl_s"):
        CacheSpec(ttl_s=-1.0)
    assert CacheSpec().with_(semantic=False).semantic is False
    # the same fields and defaults as the JAX spec; hashable (the semantic
    # layer keys on the frozen SearchOptions beside it)
    assert vars(CacheSpec()) == vars(RCacheSpec())
    hash(SearchOptions(batch=BatchSpec()))


# ---------------------------------------------------------------------------
# canonical signatures as cache keys
# ---------------------------------------------------------------------------
def test_signatures_shared_across_equivalent_filters():
    schema = PF.paper_schema()
    a = PF.And(PF.Equality("i0", 3), PF.Range("f0", 10, 20))
    commuted = PF.And(PF.Range("f0", 10, 20), PF.Equality("i0", 3))
    double_neg = PF.Not(PF.Not(a))
    dup_disjunct = PF.Or(a, a)
    sig = PF.filter_signature(a, schema)
    assert PF.filter_signature(commuted, schema) == sig
    assert PF.filter_signature(double_neg, schema) == sig
    assert PF.filter_signature(dup_disjunct, schema) == sig
    assert PF.filter_signature(PF.Equality("i0", 3), schema) != sig
    # batch signatures match the scalar path, read off the router's
    # program tensors, and equal the JAX package's keys
    progs = router.compile_programs([a, commuted], schema, 2, device="cpu")
    assert PF.batch_signatures(progs) == [sig, sig]
    rschema = RF.paper_schema()
    ra = RF.And(RF.Equality("i0", 3), RF.Range("f0", 10, 20))
    assert RF.filter_signature(ra, rschema) == sig


def test_batch_signatures_of_tensors_equal_numpy():
    """``batch_signatures`` reads tensors through ``to_host``: a tensor
    program dict gives the numpy dict's signatures."""
    schema = PF.paper_schema()
    flts = list(PF.paper_filters(schema).values()) + [_tiny(P)]
    stacked = PF.stack_programs([PF.compile_filter(f, schema) for f in flts])
    tensors = router.compile_programs(flts, schema, len(flts), device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in tensors.values())
    assert PF.batch_signatures(tensors) == PF.batch_signatures(stacked)


# ---------------------------------------------------------------------------
# CachingBackend over LocalBackend, both packages
# ---------------------------------------------------------------------------
CASES = {"f32": {}, "f32_bucketed": {"batch": dict(min_bucket=4,
                                                   max_bucket=16)},
         "use_pq": {"use_pq": True}}


def _opts(ns, **kw):
    batch = kw.pop("batch", None)
    return ns.Opts(k=10, ef=64, batch=None if batch is None
                   else ns.Batch(**batch), **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_caching_backend_parity_cold_and_warm(case, small_index, port_index,
                                              pq_pair, small_dataset):
    vecs, _, _ = small_dataset
    quant = CASES[case].get("use_pq", False)
    idx = dict(zip((R, P), pq_pair if quant else (small_index, port_index)))
    qs = np.random.default_rng(50).normal(
        size=(6, vecs.shape[1])).astype(np.float32)
    out, stats = {}, {}
    for ns in (R, P):
        base = ns.Backend(idx[ns])
        cb = ns.Caching(base, ns.CacheSpec(), clock=FakeClock())
        opts = _opts(ns, **CASES[case])
        flts = dict(ns.F.paper_filters(_schema(ns)))
        flts["brute"] = _brute(ns)
        rows = []
        for name, flt in flts.items():
            r0 = ns.router.execute(base, qs, flt, opts)
            cold = ns.router.execute(cb, qs, flt, opts)
            warm = ns.router.execute(cb, qs, flt, opts)
            for res in (cold, warm):
                _assert_same_results(res, r0, f"{ns.name} {name}")
            rows.append((name, r0, warm))
        assert rows[-1][1].routed_brute.all()
        out[ns.name], stats[ns.name] = rows, cb.cache_stats()
    for (name, pr0, pwarm), (_, rr0, rwarm) in zip(out["port"], out["jax"]):
        _assert_same_results(pr0, rr0, f"port vs jax {name}")
        _assert_same_results(pwarm, rwarm, f"port vs jax {name} warm")
    assert stats["port"] == stats["jax"]
    st = stats["port"]
    assert st["semantic"]["hits"] > 0          # warm pass was served cached
    assert st["selectivity"]["size"] > 0
    if quant:   # the compressed scan bypasses the candidate layer
        assert st["candidates"]["size"] == 0
        assert st["candidates"]["bypasses"] > 0


def test_selectivity_cache_skips_inner_estimate(port_index, small_index):
    p_out = {}
    for ns, idx in ((R, small_index), (P, port_index)):
        cb = ns.Caching(ns.Backend(idx), ns.CacheSpec())
        flt = ns.F.paper_filters(_schema(ns))["equality_bool"]
        kw = {} if ns is R else {"device": "cpu"}
        progs = ns.router.compile_programs([flt] * 4, _schema(ns), 4, **kw)
        calls = []
        inner_estimate = cb.inner.estimate
        cb.inner.estimate = (lambda p, inner_estimate=inner_estimate:
                             calls.append(1) or inner_estimate(p))
        try:
            p0 = cb.estimate(progs)
            p1 = cb.estimate(progs)
        finally:
            cb.inner.estimate = inner_estimate
        # 4 identical programs -> one inner call row cold, zero warm
        assert len(calls) == 1
        np.testing.assert_array_equal(p0, p1)
        assert isinstance(p0, np.ndarray)
        st = cb.cache_stats()["selectivity"]
        assert st["hits"] == 4 and st["misses"] == 4
        p_out[ns.name] = (p0, cb.cache_stats())
    assert np.array_equal(p_out["port"][0].view(np.uint32),
                          p_out["jax"][0].view(np.uint32))
    assert p_out["port"][1] == p_out["jax"][1]


def test_candidate_cache_admits_on_second_reference(port_index, small_index,
                                                    small_dataset):
    vecs, attrs, _ = small_dataset
    sel = float(PF.eval_program(PF.compile_filter(_tiny(P),
                                                  PF.paper_schema()),
                                attrs.ints, attrs.floats).float().mean())
    assert sel < 0.02
    got = {}
    for ns, idx in ((R, small_index), (P, port_index)):
        base = ns.Backend(idx)
        cb = ns.Caching(base, ns.CacheSpec(), clock=FakeClock())
        opts = ns.Opts(k=10, ef=64, force="brute")
        rng = np.random.default_rng(51)
        rounds = []
        for round_ in range(3):
            # fresh query vectors each round: only the candidate layer hits
            qs = rng.normal(size=(4, vecs.shape[1])).astype(np.float32)
            rc = ns.router.execute(cb, qs, _tiny(ns), opts)
            rb = ns.router.execute(base, qs, _tiny(ns), opts)
            np.testing.assert_array_equal(rc.ids, rb.ids,
                                          err_msg=f"round {round_}")
            np.testing.assert_allclose(rc.dists, rb.dists, rtol=RTOL,
                                       atol=ATOL)
            rounds.append(rc)
        st = cb.cache_stats()["candidates"]
        assert st["size"] == 1          # admitted after the second miss
        assert st["hits"] >= 1          # third round scanned the block
        got[ns.name] = (rounds, cb.cache_stats())
    for p, r in zip(got["port"][0], got["jax"][0]):
        _assert_same_results(p, r)
    # the third round is the same host block scan in both packages
    assert np.array_equal(got["port"][0][2].dists, got["jax"][0][2].dists)
    assert got["port"][1] == got["jax"][1]


def test_candidate_cache_respects_p_max_gate(port_index, small_index,
                                             small_dataset):
    vecs, _, _ = small_dataset
    stats = {}
    for ns, idx in ((R, small_index), (P, port_index)):
        cb = ns.Caching(ns.Backend(idx),
                        ns.CacheSpec(candidate_p_max=0.001, semantic=False))
        opts = ns.Opts(k=10, ef=64, force="brute")
        rng = np.random.default_rng(52)
        for _ in range(3):
            qs = rng.normal(size=(2, vecs.shape[1])).astype(np.float32)
            ns.router.execute(cb, qs, _tiny(ns), opts)
        st = cb.cache_stats()["candidates"]
        assert st["size"] == 0 and st["bypasses"] >= 1
        stats[ns.name] = cb.cache_stats()
    assert stats["port"] == stats["jax"]


def test_epoch_bump_invalidates_all_layers(small_index, small_dataset):
    vecs, _, _ = small_dataset
    pair = dict(zip((R, P), _fresh_pair(small_index, small_dataset)))
    qs = np.random.default_rng(53).normal(
        size=(4, vecs.shape[1])).astype(np.float32)
    got = {}
    for ns, idx in pair.items():
        cb = ns.Caching(ns.Backend(idx), ns.CacheSpec(), clock=FakeClock())
        flt = ns.F.paper_filters(_schema(ns))["logic"]
        opts = ns.Opts(k=10, ef=64)
        r0 = ns.router.execute(cb, qs, flt, opts)
        ns.router.execute(cb, qs, flt, opts)      # warm the layers
        assert cb.cache_stats()["semantic"]["size"] > 0
        idx.bump_version()
        r1 = ns.router.execute(cb, qs, flt, opts)
        assert cb.invalidations == 1
        assert cb.version() == idx.version()
        # stale entries were dropped, recomputed results are identical
        np.testing.assert_array_equal(r0.ids, r1.ids)
        got[ns.name] = (r1, cb.cache_stats())
    _assert_same_results(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1]


def test_semantic_threshold_serves_near_duplicates(port_index, small_index,
                                                   small_dataset):
    vecs, _, _ = small_dataset
    q = np.random.default_rng(54).normal(
        size=(1, vecs.shape[1])).astype(np.float32)
    jitter = q + (0.1 / np.sqrt(vecs.shape[1])).astype(np.float32)
    got = {}
    for ns, idx in ((R, small_index), (P, port_index)):
        cb = ns.Caching(ns.Backend(idx),
                        ns.CacheSpec(semantic_threshold=0.5,
                                     candidates=False))
        flt = ns.F.paper_filters(_schema(ns))["equality_bool"]
        opts = ns.Opts(k=5, ef=48)
        r0 = ns.router.execute(cb, q, flt, opts)
        r1 = ns.router.execute(cb, jitter, flt, opts)   # within threshold
        np.testing.assert_array_equal(r0.ids, r1.ids)   # served cached
        assert cb.cache_stats()["semantic"]["hits"] == 1
        ns.router.execute(cb, q + 10.0, flt, opts)      # outside: miss
        assert cb.cache_stats()["semantic"]["misses"] >= 2
        got[ns.name] = (r1, cb.cache_stats())
    _assert_same_results(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1]


def test_disabled_layers_bypass(port_index, small_index, small_dataset):
    vecs, _, _ = small_dataset
    qs = np.zeros((2, vecs.shape[1]), np.float32)
    got = {}
    for ns, idx in ((R, small_index), (P, port_index)):
        spec = ns.CacheSpec(selectivity=False, candidates=False,
                            semantic=False)
        cb = ns.Caching(ns.Backend(idx), spec)
        flt = ns.F.paper_filters(_schema(ns))["equality_int"]
        opts = ns.Opts(k=5, ef=48)
        kw = {} if ns is R else {"device": "cpu"}
        progs = ns.router.compile_programs([flt] * 2, _schema(ns), 2, **kw)
        assert cb.lookup_result(qs, progs, opts) is None
        r = ns.router.execute(cb, qs, flt, opts)
        assert r.ids.shape == (2, 5)
        st = cb.cache_stats()
        assert st["selectivity"]["hits"] == st["semantic"]["hits"] == 0
        assert st["selectivity"]["bypasses"] > 0
        got[ns.name] = (r, st)
    _assert_same_results(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1]


def test_engine_surfaces_cache_stats_and_bounds_latencies(
        port_index, small_index, small_dataset):
    vecs, _, _ = small_dataset
    qs = np.random.default_rng(56).normal(
        size=(8, vecs.shape[1])).astype(np.float32)
    got = {}
    for ns, idx in ((R, small_index), (P, port_index)):
        cb = ns.Caching(ns.Backend(idx), ns.CacheSpec(), clock=FakeClock())
        eng = ns.Serve(cb, ns.Opts(k=5, ef=48), max_batch=8,
                       max_wait_ms=1e6, latency_window=8,
                       time_fn=TickClock())
        flt = ns.F.paper_filters(_schema(ns))["equality_bool"]
        out = []
        for _ in range(3):                  # 24 requests, window of 8
            for i in range(8):
                eng.submit(qs[i], flt)
            out.extend(eng.run())
        assert len(eng.latencies) == 8      # rolling window
        st = eng.stats
        assert st["graph"] + st["brute"] == 24
        assert st["cache"]["semantic"]["hits"] >= 8   # repeat rounds hit
        got[ns.name] = (out, st, list(eng.latencies))
        eng.reset_stats()
        assert eng.stats["batches"] == 0 and len(eng.latencies) == 0
        # cache contents survive an engine stats reset
        assert eng.stats["cache"]["semantic"]["size"] > 0
        assert eng.stats["cache"]["semantic"]["hits"] == 0
        with pytest.raises(ValueError, match="latency_window"):
            ns.Serve(cb, ns.Opts(), latency_window=0)
    for p, r in zip(got["port"][0], got["jax"][0], strict=True):
        np.testing.assert_array_equal(p.ids, r.ids)
        np.testing.assert_allclose(p.dists, r.dists, rtol=RTOL, atol=ATOL)
        assert (p.route, p.latency_s) == (r.route, r.latency_s)
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]


# ---------------------------------------------------------------------------
# the port's device boundary, the live index, warm-up, errors
# ---------------------------------------------------------------------------
def test_caching_backend_delegates_device_and_identity(port_index):
    base = LocalBackend(port_index)
    cb = CachingBackend(base, CacheSpec())
    # the router reads backend.device; warm-up reads backend.dim
    assert cb.device == base.device == torch.device("cpu")
    assert cb.dim == base.dim and cb.schema is base.schema
    assert cb.versions() == base.versions() and cb.scope_aware
    assert cb.scope_id("a") == 1 and cb.scope_id("") == 0
    assert cb.scope_id("a") == 1 and cb.scope_id("b") == 2
    with pytest.raises(AttributeError):
        cb._no_such_private


def test_scope_sidecar_tensor_split(port_index, small_dataset):
    """The router's ``"scope"`` sidecar is a tensor on the backend's
    device: it is read to the host, stripped before the inner calls, and
    keys the scoped layers."""
    vecs, _, _ = small_dataset
    cb = CachingBackend(LocalBackend(port_index), CacheSpec())
    seen = []
    inner_estimate = cb.inner.estimate

    def spy(programs, valid=None):
        seen.append(sorted(programs))
        return inner_estimate(programs, valid=valid)

    cb.inner.estimate = spy
    flt = PF.paper_filters(PF.paper_schema())["equality_bool"]
    qs = np.random.default_rng(57).normal(
        size=(3, vecs.shape[1])).astype(np.float32)
    opts = SearchOptions(k=5, ef=48)
    r0 = router.execute(cb, qs, flt, opts, scopes=np.array([1, 2, 1]))
    r1 = router.execute(cb, qs, flt, opts, scopes=np.array([1, 2, 1]))
    r2 = router.execute(cb, qs, flt, opts, scopes=np.array([2, 1, 2]))
    assert seen and all("scope" not in keys for keys in seen)
    for r in (r1, r2):
        np.testing.assert_array_equal(r.ids, r0.ids)
    by_scope = cb.cache_stats()["semantic"]["by_scope"]
    # the second batch hit in its own scopes; the third swapped them: miss
    assert by_scope == {1: {"hits": 2, "misses": 3, "hit_rate": 0.4},
                        2: {"hits": 1, "misses": 3, "hit_rate": 0.25}}


def test_candidate_blocks_compose_live_state(small_index, small_dataset):
    """Warm candidate blocks under a live index: upserts and deletes bump
    only the vectors epoch, so the selectivity and candidate layers stay
    warm and the block hit composes tombstones and delta rows; results
    equal the JAX package's and the uncached scan's."""
    vecs, attrs, _ = small_dataset
    pair = dict(zip((R, P), _fresh_pair(small_index, small_dataset)))
    rng = np.random.default_rng(58)
    rounds = [rng.normal(size=(4, vecs.shape[1])).astype(np.float32)
              for _ in range(4)]
    new_v = rng.normal(size=(40, vecs.shape[1])).astype(np.float32)
    schema = PF.paper_schema()
    sel = np.nonzero(PF.eval_program(PF.compile_filter(_tiny(P), schema),
                                     attrs.ints, attrs.floats).numpy())[0]
    new_i = np.zeros((40, attrs.ints.shape[1]), np.int32)
    new_i[:, schema.int_index("i0")] = 2       # every new row matches
    new_f = np.full((40, attrs.floats.shape[1]), 10.0, np.float32)
    got = {}
    for ns, idx in pair.items():
        base = ns.Backend(idx)
        cb = ns.Caching(base, ns.CacheSpec(), clock=FakeClock())
        opts = ns.Opts(k=10, ef=64, force="brute")
        for qs in rounds[:2]:                  # miss, miss (admit)
            ns.router.execute(cb, qs, _tiny(ns), opts)
        before = cb.cache_stats()
        assert before["candidates"]["size"] == 1
        # the new rows match the filter, and some matching base rows die
        ids = idx.upsert(new_v, new_i, new_f)
        assert idx.delete(np.concatenate([sel[:5], ids[:3]])) == 8
        res = []
        for qs in rounds[2:]:
            rc = ns.router.execute(cb, qs, _tiny(ns), opts)
            rb = ns.router.execute(base, qs, _tiny(ns), opts)
            _assert_same_results(rc, rb, ns.name)
            dead = np.concatenate([sel[:5], ids[:3]])
            assert not np.isin(rc.ids, dead).any()
            assert np.isin(rc.ids, ids[3:]).any()
            res.append(rc)
        st = cb.cache_stats()
        assert st["invalidations"] == 1
        assert st["candidates"]["size"] == 1 and st["candidates"]["hits"] == 8
        assert st["candidates"]["composed"] == 8
        assert st["selectivity"]["size"] == before["selectivity"]["size"]
        got[ns.name] = (res, st)
    for p, r in zip(got["port"][0], got["jax"][0]):
        _assert_same_results(p, r)
        assert np.array_equal(p.dists, r.dists)    # the same host scan
    assert got["port"][1] == got["jax"][1]


def test_warmup_through_caching_backend(port_index, small_index):
    """``ServeEngine.warmup`` drives the cache's entry points with all-pad
    batches: its host results are read like the inner backend's tensors,
    and the shape ledger equals the JAX package's."""
    reg = {}
    for ns, idx in ((R, small_index), (P, port_index)):
        cb = ns.Caching(ns.Backend(idx), ns.CacheSpec())
        eng = ns.Serve(cb, _opts(ns, batch=dict(min_bucket=4,
                                                max_bucket=16)))
        assert eng.warmup(buckets=(4,)) == (4,)
        reg[ns.name] = eng.stats["batching"]
        st = cb.cache_stats()
        # pad rows never touch the layers
        assert st["selectivity"]["misses"] == st["candidates"]["misses"] == 0
    assert reg["port"] == reg["jax"]


def test_inner_errors_propagate(port_index, small_dataset):
    """No cache path swallows an exception from the inner backend."""
    vecs, _, _ = small_dataset
    qs = np.zeros((2, vecs.shape[1]), np.float32)
    for method, opts, spec in (
            ("search_brute", SearchOptions(force="brute"), CacheSpec()),
            ("search_brute", SearchOptions(force="brute"),
             CacheSpec(candidates=False)),       # the bypass
            ("search_graph", SearchOptions(force="graph"), CacheSpec()),
            ("estimate", SearchOptions(), CacheSpec())):
        cb = CachingBackend(LocalBackend(port_index), spec)

        def boom(*a, **kw):
            raise RuntimeError("inner failed")

        setattr(cb.inner, method, boom)
        with pytest.raises(RuntimeError, match="inner failed"):
            router.execute(cb, qs, _tiny(P), opts)
