"""Port parity, async multi-tenant front-end: ``repro_torch.serving``'s
``FrontEnd`` (admission, weighted fair dequeue, coalescing, tenant-scoped
caches, shutdown) with ``TenantSpec`` / ``FrontEndSpec``, against the JAX
package's (``tests/test_frontend.py``), on ``small_index`` carried across
with ``repro_torch.convert``.

Each front-end scenario runs the same requests, made from a numpy seed,
through both packages' stacks and compares: ids identical, distances
within rtol/atol 1e-5, routes and p_hat identical, and the ``stats`` dicts
equal where both run under the same fake clocks.  Every async scenario runs
through ``asyncio.run`` inside ``asyncio.wait_for``, so a hang fails its
test instead of holding the run."""
import asyncio
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cache import CachingBackend as RCaching  # noqa: E402
from repro.core import BatchSpec as RBatch  # noqa: E402
from repro.core import CacheSpec as RCacheSpec  # noqa: E402
from repro.core import FrontEndSpec as RFrontEndSpec  # noqa: E402
from repro.core import LocalBackend as RBackend  # noqa: E402
from repro.core import SearchOptions as ROpts  # noqa: E402
from repro.core import TenantSpec as RTenantSpec  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import router as r_router  # noqa: E402
from repro.serving import FrontEnd as RFrontEnd  # noqa: E402
from repro.serving import Overloaded as ROverloaded  # noqa: E402
from repro.serving import ServeEngine as RServe  # noqa: E402
from repro.serving.frontend import \
    WeightedFairScheduler as RScheduler  # noqa: E402
from repro.serving.frontend.admission import \
    TenantState as RTenantState  # noqa: E402
from repro_torch.cache import CachingBackend  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import (BatchSpec, CacheSpec, FrontEndSpec,  # noqa: E402
                              LocalBackend, SearchOptions, TenantSpec, router)
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.serving import (FrontEnd, Overloaded,  # noqa: E402
                                 ServeEngine)
from repro_torch.serving.engine import _bucket  # noqa: E402
from repro_torch.serving.frontend import (TokenBucket,  # noqa: E402
                                          WeightedFairScheduler)
from repro_torch.serving.frontend.admission import TenantState  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = ATOL = 1e-5
TIMEOUT_S = 60.0
LADDER = dict(min_bucket=4, max_bucket=16)


class Pkg(SimpleNamespace):
    """One package's classes by role (hashable: keys the per-package
    dicts of a test)."""
    __hash__ = object.__hash__


R = Pkg(name="jax", F=RF, router=r_router, Caching=RCaching,
        CacheSpec=RCacheSpec, Backend=RBackend, Serve=RServe,
        FrontEnd=RFrontEnd, FrontEndSpec=RFrontEndSpec,
        TenantSpec=RTenantSpec, Overloaded=ROverloaded,
        OPTS=ROpts(k=5, ef=48, batch=RBatch(**LADDER)))
P = Pkg(name="port", F=PF, router=router, Caching=CachingBackend,
        CacheSpec=CacheSpec, Backend=LocalBackend, Serve=ServeEngine,
        FrontEnd=FrontEnd, FrontEndSpec=FrontEndSpec, TenantSpec=TenantSpec,
        Overloaded=Overloaded,
        OPTS=SearchOptions(k=5, ef=48, batch=BatchSpec(**LADDER)))


class TickClock:
    """Monotonic fake: every call advances by ``tick`` seconds."""

    def __init__(self, tick=0.001):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _run(coro, timeout=TIMEOUT_S):
    """``asyncio.run`` with a deadline: a hang fails the test."""
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _port_of(ref):
    idx = ref.index
    return from_reference_arrays(
        vectors=idx.vectors, levels=idx.levels, node_level=idx.node_level,
        entry_point=idx.entry_point, delta_d=idx.delta_d, params=idx.params,
        ints=ref.attrs.ints, floats=ref.attrs.floats, schema=ref.schema,
        norms=idx.norms, device="cpu")


@pytest.fixture(scope="module")
def stacks(small_index):
    """Each package's index: the JAX one and the port's copy of it."""
    return {R: small_index, P: _port_of(small_index)}


def _queries(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _flt(ns):
    return ns.F.paper_filters(ns.F.paper_schema())["equality_bool"]


def _same_response(p, r, msg=""):
    np.testing.assert_array_equal(p.ids, r.ids, err_msg=msg)
    np.testing.assert_allclose(p.dists, r.dists, rtol=RTOL, atol=ATOL,
                               err_msg=msg)
    assert p.route == r.route, msg
    assert np.float32(p.p_hat).view(np.uint32) == \
        np.float32(r.p_hat).view(np.uint32), msg


def _both(stacks, scenario):
    """Run ``scenario(ns, index)`` (a coroutine function) for each package;
    returns {package name: its result}."""
    return {ns.name: _run(scenario(ns, idx)) for ns, idx in stacks.items()}


# ---------------------------------------------------------------------------
# Spec validation
# ---------------------------------------------------------------------------
def test_tenant_spec_validation():
    TenantSpec(weight=2.0, rate_qps=100.0, burst=4, queue_cap=8,
               deadline_ms=50.0)
    with pytest.raises(ValueError, match="weight"):
        TenantSpec(weight=0.0)
    with pytest.raises(ValueError, match="rate_qps"):
        TenantSpec(rate_qps=-1.0)
    with pytest.raises(ValueError, match="burst"):
        TenantSpec(burst=0)
    with pytest.raises(ValueError, match="queue_cap"):
        TenantSpec(queue_cap=0)
    with pytest.raises(ValueError, match="deadline_ms"):
        TenantSpec(deadline_ms=0.0)
    assert vars(TenantSpec()) == vars(RTenantSpec())


def test_frontend_spec_validation_and_tenant_lookup():
    spec = FrontEndSpec(coalesce_ms=5.0,
                        tenants={"b": TenantSpec(weight=2.0),
                                 "a": TenantSpec(weight=3.0)})
    # dict canonicalizes to a sorted tuple (frozen, deterministic)
    assert spec.tenants[0][0] == "a"
    assert spec.tenant("b").weight == 2.0
    assert spec.tenant("nope") == spec.default_tenant
    hash(spec)
    with pytest.raises(ValueError, match="coalesce_ms"):
        FrontEndSpec(coalesce_ms=-1.0)
    with pytest.raises(ValueError, match="coalesce_target"):
        FrontEndSpec(coalesce_target=0)
    with pytest.raises(ValueError, match="parallel_steps"):
        FrontEndSpec(parallel_steps=0)
    with pytest.raises(TypeError, match="tenants"):
        FrontEndSpec(tenants={"a": 1.0})
    with pytest.raises(TypeError, match="default_tenant"):
        FrontEndSpec(default_tenant="gold")
    scalar = {k: v for k, v in vars(FrontEndSpec()).items()
              if k != "default_tenant"}
    assert scalar == {k: v for k, v in vars(RFrontEndSpec()).items()
                      if k != "default_tenant"}


# ---------------------------------------------------------------------------
# Admission primitives (no engine, fake clocks)
# ---------------------------------------------------------------------------
def test_token_bucket_rate_and_burst():
    t = [0.0]
    b = TokenBucket(10.0, 2, clock=lambda: t[0])
    assert b.try_take() and b.try_take()       # burst of 2
    assert not b.try_take()                    # empty
    assert b.retry_after_s() == pytest.approx(0.1)
    t[0] += 0.1                                # one token refilled
    assert b.try_take() and not b.try_take()
    t[0] += 10.0                               # refill clamps at burst
    assert b.tokens <= 2.0
    assert b.try_take() and b.try_take() and not b.try_take()
    with pytest.raises(ValueError, match="rate_qps"):
        TokenBucket(0.0, 2)


def test_weighted_fair_dequeue_shares_and_no_starvation():
    orders = {}
    for name, Sched, State, Spec in (
            ("port", WeightedFairScheduler, TenantState, TenantSpec),
            ("jax", RScheduler, RTenantState, RTenantSpec)):
        sched = Sched()
        heavy = State("heavy", Spec(weight=3.0), 1, None)
        light = State("light", Spec(weight=1.0), 2, None)
        for st in (heavy, light):
            for i in range(40):
                sched.on_enqueue(st)
                st.queue.append(i)
        order = []
        for _ in range(40):
            st = sched.pick([heavy, light])
            st.queue.popleft()
            sched.on_dequeue(st)
            order.append(st.name)
        # ~3:1 split over the first 40 slots; the light tenant is never
        # starved out of a window
        assert 25 <= order.count("heavy") <= 35
        assert order.count("light") >= 5
        assert "light" in order[:8]
        orders[name] = order
    assert orders["port"] == orders["jax"]


# ---------------------------------------------------------------------------
# Engine satellites: unified ladder, deadline-aware run(), drain()
# ---------------------------------------------------------------------------
def test_bucket_unified_with_batchspec_ladder():
    for n in (1, 7, 8, 9, 100, 512, 513, 2000):
        assert _bucket(n) == BatchSpec().bucket_for(n)
    spec = BatchSpec(min_bucket=4, max_bucket=8)
    assert _bucket(3, spec) == 4 and _bucket(9, spec) == 16


def test_engine_pad_spec_follows_opts(stacks):
    eng = ServeEngine(LocalBackend(stacks[P]), P.OPTS)
    assert eng.pad_spec is P.OPTS.batch
    eng2 = ServeEngine(LocalBackend(stacks[P]), SearchOptions(k=5, ef=48))
    assert eng2.pad_spec == BatchSpec()       # default ladder


def test_run_waits_out_straggler_deadline(stacks):
    eng = ServeEngine(LocalBackend(stacks[P]), P.OPTS, max_batch=8,
                      max_wait_ms=120.0)
    q = _queries(1, 16, seed=3)[0]
    eng.submit(q, _flt(P))
    eng.drain()                               # absorb first-call costs
    eng.submit(q, _flt(P))
    t0 = time.perf_counter()
    out = eng.run()
    waited = time.perf_counter() - t0
    assert len(out) == 1 and not eng.queue
    assert waited >= 0.1                      # honored the window


def test_drain_forces_immediately(stacks):
    eng = ServeEngine(LocalBackend(stacks[P]), P.OPTS, max_batch=8,
                      max_wait_ms=1e6)
    eng.submit(_queries(1, 16, seed=4)[0], _flt(P))
    out = eng.drain()                         # would hang under run()
    assert len(out) == 1 and not eng.queue


# ---------------------------------------------------------------------------
# Front-end: coalescing parity + pad reduction
# ---------------------------------------------------------------------------
def test_coalescing_bit_identical_to_one_shot_batch(stacks):
    qs = _queries(8, 16, seed=11)

    async def main(ns, idx):
        backend = ns.Backend(idx)
        flts = list(ns.F.paper_filters(ns.F.paper_schema()).values())[:4]
        reqs = [(qs[i], flts[i % len(flts)]) for i in range(8)]
        ref = ns.router.execute(backend, qs, [f for _, f in reqs], ns.OPTS)
        eng = ns.Serve(backend, ns.OPTS, max_batch=16)
        fe = ns.FrontEnd(eng, ns.FrontEndSpec(coalesce_ms=500.0,
                                              coalesce_target=8))
        outs = await asyncio.gather(*[fe.submit(q, f) for q, f in reqs])
        st = fe.stats
        await fe.close()
        return ref, outs, st

    got = _both(stacks, main)
    for name, (ref, outs, st) in got.items():
        # one coalesced dispatch, bit-identical to the one-shot batch
        assert st["coalesce"]["dispatches"] == 1, name
        assert st["coalesce"]["mean_batch"] == 8.0
        for i, r in enumerate(outs):
            assert np.array_equal(r.ids, ref.ids[i])
            assert np.array_equal(r.dists, ref.dists[i])
            assert r.route == ("brute" if ref.routed_brute[i] else "graph")
    for p, r in zip(got["port"][1], got["jax"][1], strict=True):
        _same_response(p, r)


def test_coalescing_cuts_pad_overhead(stacks):
    """At one-at-a-time arrival an uncoalesced front-end pads every
    single-row dispatch to the smallest bucket; a coalesced one fills it."""
    qs = _queries(4, 16, seed=12)

    def drive(spec_kw):
        async def main(ns, idx):
            eng = ns.Serve(ns.Backend(idx), ns.OPTS, max_batch=16)
            eng.warmup(buckets=(4,))
            spec = ns.FrontEndSpec(**spec_kw)
            fe = ns.FrontEnd(eng, spec)
            if spec.coalesce_ms:
                await asyncio.gather(*[fe.submit(q, _flt(ns)) for q in qs])
            else:
                for q in qs:                 # arrivals one dispatch apart
                    await fe.submit(q, _flt(ns))
            pad = fe.stats["engine"]["batching"]["pad_overhead"]
            await fe.close()
            return pad
        return _both(stacks, main)

    pad_un = drive(dict(coalesce_ms=0.0))
    pad_co = drive(dict(coalesce_ms=500.0, coalesce_target=4))
    assert pad_un["port"] == pad_un["jax"] >= 0.7   # 1 real row per 4
    assert pad_co["port"] == pad_co["jax"] < pad_un["port"]


# ---------------------------------------------------------------------------
# Admission control: shed at the door, never the backend
# ---------------------------------------------------------------------------
def test_shed_requests_never_reach_backend(stacks):
    qs = _queries(4, 16, seed=13)

    async def main(ns, idx):
        eng = ns.Serve(ns.Backend(idx), ns.OPTS, max_batch=16)
        spec = ns.FrontEndSpec(coalesce_ms=1e4, coalesce_target=64,
                               tenants={"t": ns.TenantSpec(queue_cap=1)})
        fe = ns.FrontEnd(eng, spec)
        t1 = asyncio.create_task(fe.submit(qs[0], _flt(ns), tenant="t"))
        await asyncio.sleep(0.02)             # t1 is queued (held window)
        shed = []
        for i in (1, 2):
            with pytest.raises(ns.Overloaded) as e:
                await fe.submit(qs[i], _flt(ns), tenant="t")
            shed.append(e.value.reason)
        await fe.close(drain=True)            # serves only the queued one
        return await t1, shed, fe.stats

    got = _both(stacks, main)
    for name, (r1, shed, st) in got.items():
        assert shed == ["queue_full", "queue_full"], name
        t = st["tenants"]["t"]
        assert t["served"] == 1 and t["shed"]["queue_full"] == 2
        assert t["shed_total"] == 2
        # the backend saw exactly the served request, nothing shed
        assert st["engine"]["graph"] + st["engine"]["brute"] == 1
        assert r1.ids.shape == (5,)
    _same_response(got["port"][0], got["jax"][0])


def test_rate_limit_shed_with_retry_after(stacks):
    q = _queries(1, 16, seed=14)[0]

    async def main(ns, idx):
        eng = ns.Serve(ns.Backend(idx), ns.OPTS, max_batch=16)
        spec = ns.FrontEndSpec(
            tenants={"t": ns.TenantSpec(rate_qps=0.001, burst=1)})
        fe = ns.FrontEnd(eng, spec)
        r = await fe.submit(q, _flt(ns), tenant="t")
        with pytest.raises(ns.Overloaded) as e:
            await fe.submit(q, _flt(ns), tenant="t")
        await fe.close()
        return r, e.value

    got = _both(stacks, main)
    for r, err in got.values():
        assert err.reason == "rate_limit" and err.tenant == "t"
        assert err.retry_after_ms is not None and err.retry_after_ms > 0
        assert r.ids.shape == (5,)
    _same_response(got["port"][0], got["jax"][0])


def test_admission_off_is_unbounded_fifo(stacks):
    qs = _queries(4, 16, seed=15)

    async def main(ns, idx):
        eng = ns.Serve(ns.Backend(idx), ns.OPTS, max_batch=16)
        spec = ns.FrontEndSpec(admission=False, fair=False, coalesce_ms=200.0,
                               coalesce_target=4,
                               tenants={"t": ns.TenantSpec(queue_cap=1,
                                                           rate_qps=0.001)})
        fe = ns.FrontEnd(eng, spec)
        outs = await asyncio.gather(*[fe.submit(q, _flt(ns), tenant="t")
                                      for q in qs])
        st = fe.stats
        await fe.close()
        return outs, st

    got = _both(stacks, main)
    for outs, st in got.values():
        assert len(outs) == 4
        assert st["tenants"]["t"]["shed_total"] == 0
    for p, r in zip(got["port"][0], got["jax"][0], strict=True):
        _same_response(p, r)


def test_deadline_shed(stacks):
    q = _queries(1, 16, seed=16)[0]

    async def main(ns, idx):
        eng = ns.Serve(ns.Backend(idx), ns.OPTS, max_batch=16)
        fe = ns.FrontEnd(eng, ns.FrontEndSpec(coalesce_ms=1e4,
                                              coalesce_target=64))
        task = asyncio.create_task(fe.submit(q, _flt(ns), deadline_ms=5.0))
        await asyncio.sleep(0.05)             # deadline lapses while held
        with pytest.raises(ns.Overloaded) as e:
            await task
        st = fe.stats
        await fe.close()
        return e.value, st

    for err, st in _both(stacks, main).values():
        assert err.reason == "deadline"
        assert st["tenants"]["default"]["shed"]["deadline"] == 1
        assert st["engine"]["graph"] + st["engine"]["brute"] == 0


# ---------------------------------------------------------------------------
# Tenant-scoped caches: isolation
# ---------------------------------------------------------------------------
def test_semantic_cache_isolated_per_tenant(stacks):
    q = _queries(1, 16, seed=17)[0]

    async def main(ns, idx):
        cb = ns.Caching(ns.Backend(idx), ns.CacheSpec())
        eng = ns.Serve(cb, ns.OPTS, max_batch=16)
        fe = ns.FrontEnd(eng, ns.FrontEndSpec())
        ra1 = await fe.submit(q, _flt(ns), tenant="A")
        ra2 = await fe.submit(q, _flt(ns), tenant="A")   # A hits
        rb1 = await fe.submit(q, _flt(ns), tenant="B")   # B must not
        st = fe.stats
        await fe.close()
        return (ra1, ra2, rb1), st

    got = _both(stacks, main)
    for (ra1, ra2, rb1), st in got.values():
        a, b = st["tenants"]["A"], st["tenants"]["B"]
        assert a["semantic"]["hits"] == 1 and a["semantic"]["misses"] == 1
        assert b["semantic"]["hits"] == 0 and b["semantic"]["misses"] == 1
        assert a["scope"] != b["scope"] != 0
        # isolation never changes results
        assert np.array_equal(ra1.ids, ra2.ids)
        assert np.array_equal(ra1.ids, rb1.ids)
    for p, r in zip(got["port"][0], got["jax"][0]):
        _same_response(p, r)
    assert (got["port"][1]["engine"]["cache"]
            == got["jax"][1]["engine"]["cache"])


def test_candidate_cache_isolated_per_tenant(stacks):
    qs = _queries(3, 16, seed=18)

    async def main(ns, idx):
        # a filter the selector sends brute; p_max=1.0 admits it regardless
        flt = ns.F.And(ns.F.Equality("i0", 3), ns.F.Range("f0", 10.0, 12.0))
        cb = ns.Caching(ns.Backend(idx),
                        ns.CacheSpec(candidate_p_max=1.0, semantic=False))
        eng = ns.Serve(cb, ns.OPTS.with_(force="brute"), max_batch=16)
        fe = ns.FrontEnd(eng, ns.FrontEndSpec())
        outs = []
        for i in range(3):                    # miss, miss(admit), hit for A
            outs.append(await fe.submit(qs[i], flt, tenant="A"))
        outs.append(await fe.submit(qs[0], flt, tenant="B"))  # B: miss
        st = fe.stats
        await fe.close()
        return outs, st

    got = _both(stacks, main)
    for outs, st in got.values():
        a, b = st["tenants"]["A"], st["tenants"]["B"]
        assert a["candidates"]["hits"] == 1 and a["candidates"]["misses"] == 2
        assert b["candidates"]["hits"] == 0 and b["candidates"]["misses"] == 1
    for p, r in zip(got["port"][0], got["jax"][0], strict=True):
        _same_response(p, r)
    # the hit is the same host block scan in both packages
    assert np.array_equal(got["port"][0][2].dists, got["jax"][0][2].dists)
    assert (got["port"][1]["engine"]["cache"]
            == got["jax"][1]["engine"]["cache"])


def test_unscoped_engine_traffic_stays_scope_zero(stacks):
    """Direct ServeEngine.submit (no front-end) records under scope 0 --
    the tenant scopes never leak into unscoped traffic."""
    q = _queries(1, 16, seed=19)[0]
    for ns, idx in stacks.items():
        cb = ns.Caching(ns.Backend(idx), ns.CacheSpec())
        eng = ns.Serve(cb, ns.OPTS, max_batch=16)
        eng.submit(q, _flt(ns))
        eng.drain()
        eng.submit(q, _flt(ns))
        out = eng.drain()
        assert len(out) == 1
        sem = cb.cache_stats()["semantic"]["by_scope"]
        assert set(sem) == {0} and sem[0]["hits"] == 1


# ---------------------------------------------------------------------------
# Shutdown semantics
# ---------------------------------------------------------------------------
def test_close_cancels_in_flight_futures(stacks):
    qs = _queries(3, 16, seed=20)

    async def main(ns, idx):
        eng = ns.Serve(ns.Backend(idx), ns.OPTS, max_batch=16)
        fe = ns.FrontEnd(eng, ns.FrontEndSpec(coalesce_ms=1e4,
                                              coalesce_target=64))
        tasks = [asyncio.create_task(fe.submit(q, _flt(ns))) for q in qs]
        await asyncio.sleep(0.02)             # all three queued, held
        await fe.close(drain=False)
        cancelled = 0
        for t in tasks:
            try:
                await t
            except asyncio.CancelledError:
                cancelled += 1
        # a closed front-end rejects new work with a structured response
        with pytest.raises(ns.Overloaded, match="closed"):
            await fe.submit(qs[0], _flt(ns))
        return cancelled, fe.stats

    for cancelled, st in _both(stacks, main).values():
        assert cancelled == 3
        assert st["engine"]["graph"] + st["engine"]["brute"] == 0
        assert st["tenants"]["default"]["shed"]["closed"] == 1


def test_close_drain_serves_queued(stacks):
    qs = _queries(3, 16, seed=21)

    async def main(ns, idx):
        eng = ns.Serve(ns.Backend(idx), ns.OPTS, max_batch=16)
        fe = ns.FrontEnd(eng, ns.FrontEndSpec(coalesce_ms=1e4,
                                              coalesce_target=64))
        tasks = [asyncio.create_task(fe.submit(q, _flt(ns))) for q in qs]
        await asyncio.sleep(0.02)
        await fe.close(drain=True)
        return await asyncio.gather(*tasks)

    got = _both(stacks, main)
    assert all(len(outs) == 3 and all(r.ids.shape == (5,) for r in outs)
               for outs in got.values())
    for p, r in zip(got["port"], got["jax"], strict=True):
        _same_response(p, r)


# ---------------------------------------------------------------------------
# Multiple logical front-ends over one backend
# ---------------------------------------------------------------------------
def test_two_frontends_share_one_backend(stacks):
    q = _queries(1, 16, seed=22)[0]

    async def main(ns, idx):
        cb = ns.Caching(ns.Backend(idx), ns.CacheSpec())
        fe1 = ns.FrontEnd(ns.Serve(cb, ns.OPTS, max_batch=16),
                          ns.FrontEndSpec())
        fe2 = ns.FrontEnd(ns.Serve(cb, ns.OPTS, max_batch=16),
                          ns.FrontEndSpec())
        await fe1.submit(q, _flt(ns), tenant="shared")
        r2 = await fe2.submit(q, _flt(ns), tenant="shared")
        st1, st2 = fe1.stats, fe2.stats
        await fe1.close()
        await fe2.close()
        return r2, st1, st2

    got = _both(stacks, main)
    for r2, st1, st2 in got.values():
        # the tenant interns to ONE scope on the shared backend, so the
        # second front-end's identical request is a semantic hit
        assert st1["tenants"]["shared"]["scope"] == \
            st2["tenants"]["shared"]["scope"]
        assert st2["tenants"]["shared"]["semantic"]["hits"] == 1
        assert r2.ids.shape == (5,)
    _same_response(got["port"][0], got["jax"][0])


# ---------------------------------------------------------------------------
# A multi-tenant burst through the whole stack, under fake clocks
# ---------------------------------------------------------------------------
def _burst(ns, n_per_tenant, seed):
    """Requests of three tenants over the six paper scenarios and a < 1 %
    filter (both routes): (query, filter, tenant) triples, interleaved."""
    flts = list(ns.F.paper_filters(ns.F.paper_schema()).values())
    flts.append(ns.F.And(ns.F.Equality("i0", 3), ns.F.Range("f0", 10, 12)))
    qs = _queries(3 * n_per_tenant, 16, seed=seed)
    tenants = ("bronze", "silver", "gold")
    return [(qs[i], flts[i % len(flts)], tenants[i % 3])
            for i in range(len(qs))]


def _burst_spec(ns, **kw):
    return ns.FrontEndSpec(tenants={
        "bronze": ns.TenantSpec(weight=1.0, rate_qps=5.0, burst=6),
        "silver": ns.TenantSpec(weight=2.0),
        "gold": ns.TenantSpec(weight=4.0)}, **kw)


async def _send(fe, reqs):
    """Submit every request at once; each outcome is a Response or the
    reason it was shed."""
    outs = await asyncio.gather(*[fe.submit(q, f, tenant=t)
                                  for q, f, t in reqs],
                                return_exceptions=True)
    return [o.reason if isinstance(o, Exception) else o for o in outs]


def test_burst_stats_match_reference_under_fake_clocks(stacks):
    """Three tenants (weights 1 / 2 / 4, one rate-limited) through
    ``CachingBackend`` + ``ServeEngine`` + ``FrontEnd``, cold then warm:
    every response and shed equals the JAX stack's, and so do
    ``FrontEnd.stats`` (tenant ledgers, fake-clock percentiles, the
    engine's stats with its cache layers)."""

    async def main(ns, idx):
        cb = ns.Caching(ns.Backend(idx), ns.CacheSpec(),
                        clock=TickClock(0.0))
        eng = ns.Serve(cb, ns.OPTS, max_batch=8, time_fn=TickClock())
        fe = ns.FrontEnd(eng, _burst_spec(ns), clock=TickClock())
        reqs = _burst(ns, 12, seed=23)
        cold = await _send(fe, reqs)
        warm = await _send(fe, reqs)
        st = fe.stats
        await fe.close()
        return cold, warm, st

    got = _both(stacks, main)
    (pc, pw, pst), (rc, rw, rst) = got["port"], got["jax"]
    for p, r in zip(pc + pw, rc + rw, strict=True):
        if isinstance(r, str):
            assert p == r                      # the same shed reason
        else:
            _same_response(p, r)
    assert pst == rst
    t = pst["tenants"]
    assert t["bronze"]["shed"]["rate_limit"] > 0
    assert t["gold"]["shed_total"] == t["silver"]["shed_total"] == 0
    assert pst["engine"]["cache"]["semantic"]["hits"] > 0
    served = sum(v["served"] for v in t.values())
    assert pst["engine"]["graph"] + pst["engine"]["brute"] == served
    assert pst["engine"]["brute"] > 0 and pst["engine"]["graph"] > 0


def test_parallel_steps_give_the_same_results(stacks):
    """Two executor slots (pipelined engine steps) return what one slot
    returns, request for request, through the cache."""
    idx = stacks[P]

    async def main(slots):
        cb = CachingBackend(LocalBackend(idx), CacheSpec())
        eng = ServeEngine(cb, P.OPTS, max_batch=8)
        fe = FrontEnd(eng, FrontEndSpec(parallel_steps=slots))
        reqs = [(q, f, t) for q, f, t in _burst(P, 12, seed=24)]
        cold = await _send(fe, reqs)
        warm = await _send(fe, reqs)
        st = fe.stats
        await fe.close()
        return cold + warm, st

    one, st1 = _run(main(1))
    two, st2 = _run(main(2))
    assert st2["coalesce"]["slots"] == 2
    assert st1["coalesce"]["dispatches"] == st2["coalesce"]["dispatches"]
    for a, b in zip(one, two, strict=True):
        assert np.array_equal(a.ids, b.ids)
        assert np.array_equal(a.dists.view(np.uint32), b.dists.view(np.uint32))
        assert (a.route, a.p_hat) == (b.route, b.p_hat)


def test_frontend_registry_view_and_reset_cascade(stacks):
    """The front-end joins the engine's registry as the ``frontend`` view;
    ``reset_stats`` zeroes its ledgers and the cache counters, and keeps
    tenants, scopes and cache entries."""
    q = _queries(1, 16, seed=25)[0]

    async def main():
        cb = CachingBackend(LocalBackend(stacks[P]), CacheSpec())
        eng = ServeEngine(cb, P.OPTS, max_batch=16)
        fe = FrontEnd(eng, FrontEndSpec())
        await fe.submit(q, _flt(P), tenant="A")
        await fe.submit(q, _flt(P), tenant="A")
        view = eng.obs.registry.view("frontend")
        text = eng.obs.prometheus_text()
        fe.reset_stats()
        after = fe.stats
        await fe.close()
        return view, text, after

    view, text, after = _run(main())
    assert view["tenants"]["A"]["served"] == 2
    assert view["coalesce"]["dispatches"] == 2
    assert "frontend" in text
    a = after["tenants"]["A"]
    assert a["served"] == a["submitted"] == 0 and a["scope"] == 1
    assert after["coalesce"]["dispatches"] == 0
    cache = after["engine"]["cache"]
    assert cache["semantic"]["hits"] == 0 and cache["semantic"]["size"] == 1
