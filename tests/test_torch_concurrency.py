"""Port parity, concurrent serving: deferred execution, the background
merge and the launch counters across threads (``tests/test_concurrency.py``
for the JAX package).

Bars: a deferred step returns the synchronous result bit for bit (ids and
distance bits), ``finish()`` is idempotent from any thread; every response
served while search, upsert, delete and a background merge interleave is
bit-identical to a single-threaded replay of one epoch-consistent state
(and the replay's ids equal the JAX package's); ``bulk_add`` calls
``on_wave`` once per device wave, as often as the JAX package's.  The
background merge is shown to overlap serving with events -- the worker is
parked inside its pacing hook while steps complete -- not with a wall-clock
bar.  Everything runs in one process with real threads."""
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FavorIndex as RIndex  # noqa: E402
from repro.core import HnswParams as RParams  # noqa: E402
from repro.core import SearchOptions as ROpts  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import router as r_router  # noqa: E402
from repro.index import bulk as r_bulk  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import LocalBackend, SearchOptions, router  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.index import bulk  # noqa: E402
from repro_torch.serving import MergeController, ServeEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPTS = SearchOptions(k=8, ef=64)
ROPTS = ROpts(k=8, ef=64)
PARAMS = dict(M=8, efc=48, seed=3)


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(33)
    n, d = 768, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    schema = RF.paper_schema()
    attrs = RF.random_attributes(schema, n, seed=17)
    return vecs, attrs, schema


@pytest.fixture(scope="module")
def built(ds):
    """One JAX build of the corpus; every test re-wraps its graph."""
    vecs, attrs, _ = ds
    return RIndex.build(vecs, attrs, RParams(**PARAMS))


def _port(built):
    idx = built.index
    return from_reference_arrays(
        vectors=idx.vectors, levels=idx.levels, node_level=idx.node_level,
        entry_point=idx.entry_point, delta_d=idx.delta_d, params=idx.params,
        ints=built.attrs.ints, floats=built.attrs.floats,
        schema=built.schema, norms=idx.norms, device="cpu")


def _fresh(built, **engine_kw):
    return ServeEngine(LocalBackend(_port(built)), OPTS, **engine_kw)


def _queries(ds, n=6, seed=91, F=PF):
    vecs, _, _ = ds
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(n, vecs.shape[1])).astype(np.float32)
    flts = [F.Equality("i0", 3) if i % 3 == 1 else
            F.And(F.Equality("i0", 3), F.Range("f0", 10, 12)) if i % 3 == 2
            else F.TrueFilter() for i in range(n)]
    return qs, flts


def _serve_one(eng, q, flt):
    """One single-query step, atomically: submit + host dispatch under the
    engine lock (so a concurrent thread can't batch-steal the row), device
    wait outside it."""
    with eng._lock:
        rid = eng.submit(q, flt)
        step = eng.begin_batch(force=True)
    (r,) = [r for r in eng.finish_batch(step) if r.rid == rid]
    return r


def _delta_rows(ds, count, seed=55):
    vecs, attrs, schema = ds
    rng = np.random.default_rng(seed)
    col = schema.int_index("i0")
    row = int(np.nonzero(attrs.ints[:, col] == 3)[0][0])
    return (rng.normal(size=(count, vecs.shape[1])).astype(np.float32),
            np.tile(attrs.ints[row], (count, 1)),
            np.tile(attrs.floats[row], (count, 1)))


def _same(a, b) -> bool:
    return (np.array_equal(a.ids, b.ids)
            and np.array_equal(a.dists.view(np.uint32),
                               b.dists.view(np.uint32)))


# ---------------------------------------------------------------------------
# deferred execution
# ---------------------------------------------------------------------------
def test_deferred_execute_bit_identical_and_idempotent(built, ds):
    be = LocalBackend(_port(built))
    qs, flts = _queries(ds, n=9)
    sync = router.execute(be, qs, flts, OPTS)
    assert sync.routed_brute.any() and not sync.routed_brute.all()
    pend = router.execute(be, qs, flts, OPTS, defer=True)
    assert isinstance(pend, router.PendingExecution)
    res = pend.finish()
    assert pend.finish() is res                  # idempotent
    assert _same(res, sync)
    np.testing.assert_array_equal(res.routed_brute, sync.routed_brute)
    np.testing.assert_array_equal(res.waves, sync.waves)
    # the JAX package's deferred step returns the same ids
    rqs, rflts = _queries(ds, n=9, F=RF)
    ref = r_router.execute(built.backend, rqs, rflts, ROPTS,
                           defer=True).finish()
    np.testing.assert_array_equal(res.ids, ref.ids)
    np.testing.assert_array_equal(res.routed_brute, ref.routed_brute)


def test_finish_from_other_threads_returns_one_result(built, ds):
    """Two steps dispatched back to back and finished in reverse order,
    the first from two other threads at once: each returns the one result
    object, bit-identical to serial steps."""
    eng = _fresh(built)
    qs, flts = _queries(ds, n=12, seed=5)
    serial = []
    for lo in (0, 6):
        for i in range(lo, lo + 6):
            eng.submit(qs[i], flts[i])
        serial.append(eng.step(force=True))
    for i in range(12):
        eng.submit(qs[i], flts[i])
    eng.max_batch = 6
    a = eng.begin_batch(force=True)
    b = eng.begin_batch(force=True)
    assert eng._m_inflight.value() == 2
    got_b = eng.finish_batch(b)
    results, start = [], threading.Barrier(2)

    def finish():
        start.wait()
        results.append(a.pending.finish())

    threads = [threading.Thread(target=finish) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results[0] is results[1]
    got_a = eng.finish_batch(a)
    assert a.pending.finish() is results[0]
    assert eng._m_inflight.value() == 0
    for got, want in ((got_a, serial[0]), (got_b, serial[1])):
        for r, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(r.ids, w.ids)
            assert np.array_equal(r.dists.view(np.uint32),
                                  w.dists.view(np.uint32))
            assert r.route == w.route


# ---------------------------------------------------------------------------
# threaded stress: search + upsert + delete + background merge
# ---------------------------------------------------------------------------
def test_threaded_stress_bit_identical_to_epoch_replay(built, ds):
    """Concurrent responses must each bit-match the single-threaded replay
    of one epoch-consistent snapshot (S0 pre-upsert, S1 post-upsert, S2
    post-delete, S3 post-merge) -- never a torn in-between.  The replay's
    ids are also the JAX package's, state by state."""
    vecs, _, _ = ds
    qs, flts = _queries(ds)
    rqs, rflts = _queries(ds, F=RF)
    uv, ui, uf = _delta_rows(ds, 24)

    rep = _fresh(built)
    ref = RIndex(built.index, built.attrs)
    expected = {}

    def snap(name):
        expected[name] = [_serve_one(rep, qs[i], flts[i])
                          for i in range(len(qs))]
        want = r_router.execute(ref.backend, rqs, rflts, ROPTS)
        for i, r in enumerate(expected[name]):
            np.testing.assert_array_equal(r.ids, want.ids[i], err_msg=name)

    snap("S0")
    rep_ids = rep.upsert(uv, ui, uf)
    ref.upsert(uv, ui, uf)
    snap("S1")
    rep.delete([int(rep_ids[0]), int(rep_ids[1]), 5])
    ref.delete([int(rep_ids[0]), int(rep_ids[1]), 5])
    snap("S2")
    rep.merge()
    ref.merge()
    snap("S3")

    eng = _fresh(built, merge_background=True)  # worker idles: no frac set
    stop = threading.Event()
    errors = []
    checked = np.zeros(4, np.int64)             # responses matched per state

    def searcher(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                i = int(rng.integers(len(qs)))
                r = _serve_one(eng, qs[i], flts[i])
                for s, name in enumerate(("S0", "S1", "S2", "S3")):
                    if _same(r, expected[name][i]):
                        checked[s] += 1
                        break
                else:
                    errors.append(f"query {i}: ids {r.ids.tolist()} match "
                                  "no epoch-consistent state")
                    stop.set()
        except Exception as e:                  # pragma: no cover
            errors.append(repr(e))
            stop.set()

    threads = [threading.Thread(target=searcher, args=(100 + t,))
               for t in range(2)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.1)
        ids = eng.upsert(uv, ui, uf)
        np.testing.assert_array_equal(ids, rep_ids)   # positional parity
        time.sleep(0.1)
        assert eng.delete([int(ids[0]), int(ids[1]), 5]) == 3
        time.sleep(0.1)
        # the real prepare (no lock) / epoch-guarded commit (engine lock)
        # path while the searchers keep serving
        out = eng._merge_ctl.merge_once()
        assert out is not None and out["merged_slots"] == 24
        # let the searchers serve the merged state (bounded, not a bar)
        t0 = time.perf_counter()
        while checked[3] == 0 and not stop.is_set() \
                and time.perf_counter() - t0 < 60.0:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join()
        eng.close()
    assert not errors, errors[:3]
    assert checked.sum() > 0 and checked[3] > 0, checked.tolist()
    for i in range(len(qs)):
        assert _same(_serve_one(eng, qs[i], flts[i]), expected["S3"][i])
    st = eng.stats["mutations"]
    assert st["delta_rows"] == 0 and st["base_rows"] == vecs.shape[0] + 24


# ---------------------------------------------------------------------------
# background merge
# ---------------------------------------------------------------------------
def test_background_merge_commits_while_steps_complete(built, ds):
    """The worker is parked inside its pacing hook, mid-build: steps keep
    completing (and never return a deleted id) until it is released; the
    merge then commits exactly once, and the merged engine serves what a
    foreground merge of the same script serves."""
    eng = _fresh(built, merge_background=True, merge_delta_frac=0.01)
    eng._merge_ctl.stop()
    ctl = eng._merge_ctl = MergeController(eng, wave=16, poll_s=0.005)
    parked, release = threading.Event(), threading.Event()
    waves = []
    pace = ctl._on_wave

    def on_wave():
        waves.append(eng._m_merge_active.value())
        if len(waves) == 2:            # mid-build: park until released
            parked.set()
            assert release.wait(60.0)
        pace()

    ctl._on_wave = on_wave
    qs, flts = _queries(ds, n=4)
    uv, ui, uf = _delta_rows(ds, 96)
    dead = [3, 7]
    ids = eng.upsert(uv, ui, uf)                # 96/768 = 12.5 % > 1 %
    assert eng.delete(dead + [int(ids[0])]) == 3
    dead.append(int(ids[0]))
    _serve_one(eng, qs[0], flts[0])             # this step's finish pokes
    assert parked.wait(60.0), "the merge worker never reached a wave"
    during = []
    for i in range(6):
        assert eng._m_merge_active.value() == 1.0 and ctl.merges == 0
        during.append(_serve_one(eng, qs[i % 4], flts[i % 4]))
    release.set()
    t0 = time.perf_counter()
    while ctl.merges == 0 and time.perf_counter() - t0 < 60.0:
        _serve_one(eng, qs[0], flts[0])
        time.sleep(0.005)
    eng.close()
    assert ctl.merges == 1 and ctl.stale == 0
    assert all(w == 1.0 for w in waves) and len(waves) > 2
    assert not any(np.isin(r.ids, dead).any() for r in during)
    assert eng._m_merge_s.count() == 1 and eng._m_merge_stall.count() == 1
    assert eng._m_merge_active.value() == 0.0
    st = eng.stats["mutations"]
    assert st["auto_merges"] == 1 and st["delta_rows"] == 0
    # the same script merged in the foreground
    fg = _fresh(built)
    fg.upsert(uv, ui, uf)
    fg.delete(dead)
    fg.merge()
    for i in range(4):
        a, b = _serve_one(eng, qs[i], flts[i]), _serve_one(fg, qs[i], flts[i])
        assert _same(a, b) and not np.isin(a.ids, dead).any()


def test_merge_commit_epoch_guard_rejects_stale_prepare(built, ds):
    be = LocalBackend(_port(built))
    uv, ui, uf = _delta_rows(ds, 12)
    be.upsert(uv, ui, uf)
    v0 = be.versions()
    prep = be.merge_prepare()
    assert prep is not None and be.versions() == v0   # nothing served moved
    be.merge()                   # foreground merge moves the graph epoch
    assert be.merge_commit(prep) is None        # stale build thrown away
    assert be.live_stats()["delta_rows"] == 0
    assert be.merge_prepare() is None           # nothing left to merge


@pytest.mark.parametrize("count,wave", [(96, 16), (300, 64), (5, 512)])
def test_on_wave_once_per_bulk_wave_as_reference(built, ds, count, wave):
    uv, _, _ = _delta_rows(ds, count)
    calls = {"jax": 0, "torch": 0}

    def counter(pkg):
        def hook():
            calls[pkg] += 1
        return hook

    r = r_bulk.bulk_add(built.index, uv, wave=wave, on_wave=counter("jax"))
    p = bulk.bulk_add(_port(built).index, uv, wave=wave,
                      on_wave=counter("torch"), device="cpu")
    assert calls["torch"] == calls["jax"] > 0
    for lp, lr in zip(p.levels, r.levels, strict=True):
        np.testing.assert_array_equal(lp, lr)
    # once per device wave: the waves of at most ``wave`` linked rows
    assert calls["torch"] >= -(-count // wave)


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------
def test_launch_counters_exact_across_threads():
    K.reset_launch_counts()
    n_threads, per = 8, 4000
    start = threading.Barrier(n_threads)

    def hammer(t):
        start.wait()
        for i in range(per):
            K.count_launch("gather_distance", (t % 2 + 1, 32))
            K.count_launch("filtered_topk")

    threads = [threading.Thread(target=hammer, args=(t,), name=f"w{t}")
               for t in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)                  # switch threads often
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert K.launch_counts["gather_distance"] == n_threads * per
    assert K.launch_counts["filtered_topk"] == n_threads * per
    assert K.launch_widths["gather_distance"] == {
        (1, 32): n_threads // 2 * per, (2, 32): n_threads // 2 * per}
    assert K.launch_threads == {
        f"w{t}": {"gather_distance": per, "filtered_topk": per}
        for t in range(n_threads)}
    K.reset_launch_counts()
    assert not any(K.launch_counts.values()) and not K.launch_threads
