"""Port parity, serving engine: ``repro_torch.serving.ServeEngine`` over the
port's ``LocalBackend`` against the JAX package's ``ServeEngine``
(``tests/test_obs.py``, ``tests/test_backends.py``, ``tests/test_mutation.py``),
on ``small_index`` carried across with ``repro_torch.convert``.

Both engines get the same traffic under their own copy of one fake clock,
so their latency histograms, stage spans and ``prometheus_text()`` must be
equal line for line.  Bars, from ``ROADMAP.md`` section 3: brute ids
identical, graph ids identical on ``small_index`` (the exact scorer is
bit-stable there), routes and p_hat identical (bits), distances within
rtol/atol 1e-5, and the ``stats`` dicts equal.  The port's engine also
returns exactly what ``FavorIndex.query`` returns for the same batches."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import BatchSpec as RBatch  # noqa: E402
from repro.core import BuildSpec as RBuild  # noqa: E402
from repro.core import FavorIndex as RIndex  # noqa: E402
from repro.core import LocalBackend as RBackend  # noqa: E402
from repro.core import ObsSpec as RObsSpec  # noqa: E402
from repro.core import QuantSpec as RQuant  # noqa: E402
from repro.core import SearchOptions as ROpts  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.core import router as r_router  # noqa: E402
from repro.configs import favor_anns as r_favor_anns  # noqa: E402
from repro.obs import Obs as RObs  # noqa: E402
from repro.obs.probes import true_fraction as r_true_fraction  # noqa: E402
from repro.serving import ServeEngine as RServe  # noqa: E402
from repro_torch.configs import favor_anns  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import (BatchSpec, BuildSpec, FavorIndex,  # noqa: E402
                              LocalBackend, QuantSpec, SearchOptions,
                              router)
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core.options import ObsSpec  # noqa: E402
from repro_torch.core.selector import SelectorConfig  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.obs.probes import innermost, true_fraction  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K, EF = 10, 64
PER_SCENARIO = 3
QUANT = dict(kind="pq", m=4, nbits=5, train_iters=5, rerank=4)


class FakeClock:
    """Monotonic fake: every call advances by ``tick`` seconds."""

    def __init__(self, tick=0.001):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


# Attributes only the port's trace carries (``repro_torch.obs.trace``):
# where the host waits on the card, and the graph traversal's wave
# counters.  They are taken out of the port's trace before it is compared
# with the JAX package's, and held present by ``_assert_port_only``.
PORT_ONLY = {"trace": ("finish_wait_ms",), "compile": ("upload_ms",),
             "estimate": ("read_ms",),
             "graph/search": ("waves", "sync_ms", "lanes_active",
                              "lanes_launched", "ids_launched",
                              "ids_useful")}


def _without_port_only(trace: dict) -> dict:
    """A port trace dict with the ``PORT_ONLY`` attributes taken out."""
    def spans(items, path):
        out = []
        for sp in items:
            name = f"{path}/{sp['name']}" if path else sp["name"]
            drop = PORT_ONLY.get(name, ())
            out.append(dict(sp, attrs={k: v for k, v in sp["attrs"].items()
                                       if k not in drop},
                            children=spans(sp["children"], name)))
        return out
    return dict(trace, attrs={k: v for k, v in trace["attrs"].items()
                              if k not in PORT_ONLY["trace"]},
                spans=spans(trace["spans"], ""))


def _assert_port_only(traces: list) -> None:
    """Every ``PORT_ONLY`` attribute is present wherever its span is, with
    a number >= 0, and the graph search's is seen at least once."""
    seen = set()

    def walk(items, path):
        for sp in items:
            name = f"{path}/{sp['name']}" if path else sp["name"]
            for k in PORT_ONLY.get(name, ()):
                assert sp["attrs"][k] >= 0, (name, k, sp["attrs"])
                seen.add(name)
            walk(sp["children"], name)
    for t in traces:
        assert t["attrs"]["finish_wait_ms"] >= 0
        walk(t["spans"], "")
    assert "graph/search" in seen and "compile" in seen


def _mixed(F, schema):
    """The six paper scenarios plus a < 1 % filter (the brute route),
    PER_SCENARIO requests each, interleaved."""
    flts = list(F.paper_filters(schema).values())
    flts.append(F.And(F.Equality("i0", 3), F.Range("f0", 10, 12)))
    return [flts[i % len(flts)] for i in range(len(flts) * PER_SCENARIO)]


def _port_of(ref, **kw):
    """The port's FavorIndex over a JAX index's state (graph, attributes
    and, when quantized, codebook and codes)."""
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
def traffic(small_dataset):
    vecs, _, schema = small_dataset
    rflt = _mixed(RF, schema)
    pflt = _mixed(PF, PF.paper_schema())
    rng = np.random.default_rng(41)
    qs = rng.normal(size=(len(rflt), vecs.shape[1])).astype(np.float32)
    return qs, rflt, pflt


@pytest.fixture(scope="module")
def pq_pair(small_index, small_dataset):
    _, attrs, _ = small_dataset
    ref = RIndex(small_index.index, attrs, RBuild(quant=RQuant(**QUANT)))
    return ref, _port_of(ref)


def _opts(**kw):
    """The same options for both packages (BatchSpec converted)."""
    batch = kw.pop("batch", None)
    return (ROpts(k=K, ef=EF, batch=None if batch is None else RBatch(**batch),
                  **kw),
            SearchOptions(k=K, ef=EF,
                          batch=None if batch is None else BatchSpec(**batch),
                          **kw))


def _serve(eng, qs, flts, scopes=None):
    rids = [eng.submit(qs[i], flts[i],
                       scope=0 if scopes is None else scopes[i])
            for i in range(len(qs))]
    out = eng.run()
    assert [r.rid for r in out] == rids
    return out


def _assert_same_responses(p_out, r_out):
    for p, r in zip(p_out, r_out, strict=True):
        assert p.route == r.route, p.rid
        assert np.float32(p.p_hat).view(np.uint32) == \
            np.float32(r.p_hat).view(np.uint32), p.rid
        np.testing.assert_array_equal(p.ids, r.ids, err_msg=str(p.rid))
        np.testing.assert_allclose(p.dists, r.dists, rtol=1e-5, atol=1e-5)
        assert p.latency_s == r.latency_s


CASES = {
    "f32_prepad": ({}, {}),
    "f32_bucketed": ({"batch": dict(min_bucket=4, max_bucket=16)}, {}),
    "pq_both_routes": ({"use_pq": True, "graph_quant": "pq"}, {}),
    "obs_full": ({}, dict(trace_sample=1.0, probe_sample=0.5,
                          shadow_sample=0.5, slow_ms=0.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_reference(case, small_index, pq_pair, traffic):
    over, obs_kw = CASES[case]
    quant = over.get("use_pq", False)
    ref, port = (pq_pair if quant else (small_index, _port_of(small_index)))
    ropts, popts = _opts(**over)
    qs, rflt, pflt = traffic
    kw = dict(max_batch=8, max_wait_ms=0.0)
    r_eng = RServe(RBackend(ref), ropts, time_fn=FakeClock(),
                   obs=RObsSpec(**obs_kw), **kw)
    p_eng = ServeEngine(LocalBackend(port), popts, time_fn=FakeClock(),
                        obs=ObsSpec(**obs_kw), **kw)
    r_out = _serve(r_eng, qs, rflt)
    p_out = _serve(p_eng, qs, pflt)
    _assert_same_responses(p_out, r_out)
    routes = {r.route for r in p_out}
    assert routes == {"graph", "brute"}
    assert p_eng.stats == r_eng.stats
    assert p_eng.stats["scorers"]["use_pallas"] is False
    assert list(p_eng.latencies) == list(r_eng.latencies)
    assert p_eng.latency_percentiles() == r_eng.latency_percentiles()
    p_snap, r_snap = p_eng.obs.snapshot(), r_eng.obs.snapshot()
    assert (p_snap["histograms"]["favor_request_latency_seconds"]
            == r_snap["histograms"]["favor_request_latency_seconds"])
    if not obs_kw.get("shadow_sample"):
        # shadow runs time real executions: only their counts compare
        assert p_snap == r_snap
        assert (p_eng.obs.prometheus_text().splitlines()
                == r_eng.obs.prometheus_text().splitlines())
    else:
        for name in ("favor_route_shadow_total",
                     "favor_estimator_probes_total"):
            assert (sum(p_snap["counters"][name]["series"].values())
                    == sum(r_snap["counters"][name]["series"].values()) > 0)
        assert (p_snap["histograms"]["favor_estimator_abs_error"]
                == r_snap["histograms"]["favor_estimator_abs_error"])
        p_tr = [t.to_dict() for t in p_eng.obs.tracer.traces]
        r_tr = [t.to_dict() for t in r_eng.obs.tracer.traces]
        assert [_without_port_only(t) for t in p_tr] == r_tr
        _assert_port_only(p_tr)
        assert ([s.to_dict() for s in p_eng.obs.tracer.slow_log]
                == [s.to_dict() for s in r_eng.obs.tracer.slow_log])
    # the engine returns what FavorIndex.query returns for its batches
    for lo in range(0, len(qs), 8):
        res = port.query(qs[lo:lo + 8], pflt[lo:lo + 8], popts)
        for i, r in enumerate(p_out[lo:lo + 8]):
            np.testing.assert_array_equal(r.ids, res.ids[i])
            assert np.array_equal(r.dists.view(np.uint32),
                                  res.dists[i].view(np.uint32))
            assert r.route == ("brute" if res.routed_brute[i] else "graph")


class HookBackend:
    """A stand-in for the cache layers (the port's come later): serves a
    request it has recorded before, records every freshly computed row,
    and declares ``scope_aware`` so the router hands it the ``scope``
    sidecar, which it notes and strips before the inner backend."""

    scope_aware = True

    def __init__(self, inner):
        self.inner = inner
        self.store = {}
        self.scopes = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _strip(self, programs):
        sc = programs.get("scope")
        self.scopes.append(None if sc is None else
                           (sc.cpu().numpy() if hasattr(sc, "cpu")
                            else np.asarray(sc)).tolist())
        return {k: v for k, v in programs.items() if k != "scope"}

    def estimate(self, programs, valid=None):
        return self.inner.estimate(self._strip(programs), valid=valid)

    def search_graph(self, queries, programs, p_hat, opts, valid=None):
        return self.inner.search_graph(queries, self._strip(programs), p_hat,
                                       opts, valid=valid)

    def search_brute(self, queries, programs, opts, valid=None):
        return self.inner.search_brute(queries, self._strip(programs), opts,
                                       valid=valid)

    def lookup_result(self, queries, programs, opts):
        keys = [q.tobytes() for q in np.asarray(queries)]
        hit = np.array([k in self.store for k in keys])
        if not hit.any():
            return None
        rows = [self.store[k] for k, h in zip(keys, hit) if h]
        return {"hit": hit, "ids": np.stack([r[0] for r in rows]),
                "dists": np.stack([r[1] for r in rows]),
                "p_hat": np.array([r[2] for r in rows], np.float32),
                "routed_brute": np.array([r[3] for r in rows])}

    def record_result(self, queries, programs, opts, ids, dists, p_hat,
                      routed_brute):
        for i, q in enumerate(np.asarray(queries)):
            self.store[q.tobytes()] = (ids[i].copy(), dists[i].copy(),
                                       p_hat[i], bool(routed_brute[i]))


def test_spans_hooks_and_scopes_match_reference(small_index, traffic):
    """Every router stage's span (names, attributes and fake-clock
    durations) equals the JAX package's, with the lookup / record hooks
    and the scope sidecar exercised through a stub backend; the second
    pass over the same traffic is served from the stub's store."""
    ropts, popts = _opts(batch=dict(min_bucket=4, max_bucket=16))
    qs, rflt, pflt = traffic
    scopes = [(i % 3) for i in range(len(qs))]
    out = {}
    for pkg, eng_cls, be, opts, flts, spec_cls in (
            ("jax", RServe, HookBackend(RBackend(small_index)), ropts, rflt,
             RObsSpec),
            ("torch", ServeEngine,
             HookBackend(LocalBackend(_port_of(small_index))), popts, pflt,
             ObsSpec)):
        eng = eng_cls(be, opts, max_batch=8, max_wait_ms=0.0,
                      time_fn=FakeClock(), obs=spec_cls(slow_ms=None))
        first = _serve(eng, qs, flts, scopes)
        second = _serve(eng, qs, flts, scopes)
        traces = [t.to_dict() for t in eng.obs.tracer.traces]
        out[pkg] = (first, second, traces, be.scopes, eng.stats)
    _assert_same_responses(out["torch"][0], out["jax"][0])
    _assert_same_responses(out["torch"][1], out["jax"][1])
    assert [_without_port_only(t) for t in out["torch"][2]] == out["jax"][2]
    _assert_port_only(out["torch"][2])
    assert out["torch"][3] == out["jax"][3]
    assert any(s is not None and any(s) for s in out["torch"][3])
    assert out["torch"][4] == out["jax"][4]
    names = [s["name"] for s in out["torch"][2][0]["spans"]]
    for stage in ("compile", "cache_lookup", "estimate", "route",
                  "cache_record"):
        assert stage in names, names
    route_sp = next(s for s in out["torch"][2][0]["spans"]
                    if s["name"] in ("graph", "brute"))
    assert [c["name"] for c in route_sp["children"]] == ["pad", "search"]
    # the repeat pass hit the store for every request: no route ran
    last = out["torch"][2][-1]
    assert last["attrs"]["cache_hits"] == last["batch"]
    assert [s["name"] for s in last["spans"]] == ["compile", "cache_lookup"]


def test_obs_disabled_is_bit_identical_and_inert(small_index, traffic):
    port = _port_of(small_index)
    qs, _, pflt = traffic
    _, popts = _opts(batch=dict(min_bucket=4, max_bucket=16))
    obs = Obs(ObsSpec(trace_sample=1.0, kernel_annotations=True))
    try:
        r_obs = router.execute(port.backend, qs, pflt, popts, obs=obs)
    finally:
        from repro_torch.obs import profiling
        profiling.set_kernel_annotations(False)
    r_off = router.execute(port.backend, qs, pflt, popts, obs=None)
    sampled_out = Obs(ObsSpec(trace_sample=0.0))
    r_skip = router.execute(port.backend, qs, pflt, popts, obs=sampled_out)
    for r in (r_obs, r_skip):
        np.testing.assert_array_equal(r.ids, r_off.ids)
        assert np.array_equal(r.dists.view(np.uint32),
                              r_off.dists.view(np.uint32))
        np.testing.assert_array_equal(r.routed_brute, r_off.routed_brute)
    assert sampled_out.tracer is None and len(obs.tracer.traces) == 1
    eng_on = ServeEngine(LocalBackend(port), popts, max_batch=8)
    eng_off = ServeEngine(LocalBackend(port), popts, max_batch=8,
                          obs=ObsSpec(enabled=False))
    assert eng_off.obs.tracer is None and not eng_off.obs.wants_probe
    for a, b in zip(_serve(eng_on, qs, pflt), _serve(eng_off, qs, pflt)):
        np.testing.assert_array_equal(a.ids, b.ids)
        assert np.array_equal(a.dists.view(np.uint32),
                              b.dists.view(np.uint32))
        assert a.route == b.route
    assert eng_off.stats["obs"] == {"enabled": False, "trace_sample": 1.0}
    assert eng_off.stats["graph"] + eng_off.stats["brute"] == len(qs)


def test_true_fraction_and_probes_match_reference(small_index,
                                                  small_dataset):
    _, attrs, schema = small_dataset
    port = _port_of(small_index)
    pb = LocalBackend(port)
    assert innermost(pb) is pb
    assert innermost(HookBackend(pb)) is pb
    for name, rflt in RF.paper_filters(schema).items():
        pflt = PF.paper_filters(PF.paper_schema())[name]
        assert (true_fraction(pb, pflt)
                == r_true_fraction(RBackend(small_index), rflt))
    assert true_fraction(pb, PF.TrueFilter()) == 1.0


def test_legacy_engine_kwargs_warn(small_index):
    port = _port_of(small_index)
    with pytest.deprecated_call():
        eng = ServeEngine(port, k=5, ef=48, max_batch=8)
    assert eng.opts == SearchOptions(k=5, ef=48)
    assert isinstance(eng.backend, LocalBackend)
    with pytest.raises(ValueError, match="not both"):
        ServeEngine(port, SearchOptions(), k=5)
    with pytest.deprecated_call():
        eng = ServeEngine(port, 5)
    assert eng.opts.k == 5 and (eng.k, eng.ef) == (5, 100)
    with pytest.raises(TypeError, match="SearchOptions"):
        ServeEngine(port, {"k": 5})
    with pytest.raises(TypeError, match="obs must be"):
        ServeEngine(port, SearchOptions(), obs=RObsSpec())
    with pytest.raises(ValueError, match="latency_window"):
        ServeEngine(port, SearchOptions(), latency_window=0)
    with pytest.raises(ValueError, match="use_pq=True needs"):
        ServeEngine(port, SearchOptions(use_pq=True))


def test_engine_deadline_warmup_and_reset(small_index, traffic):
    qs, _, pflt = traffic
    port = _port_of(small_index)
    clock = FakeClock(tick=0.0)
    eng = ServeEngine(port, SearchOptions(k=K, ef=EF), max_batch=4,
                      max_wait_ms=5.0, time_fn=clock)
    eng.submit(qs[0], pflt[0])
    assert eng.step() == []                 # not full, deadline not reached
    clock.t += 0.006
    assert len(eng.step()) == 1             # the deadline passed
    for i in range(4):
        eng.submit(qs[i], pflt[i])
    assert len(eng.run(until_empty=False)) == 4   # a full batch is due
    with pytest.raises(ValueError, match="BatchSpec"):
        eng.warmup()
    _, popts = _opts(batch=dict(min_bucket=4, max_bucket=8))
    eng = ServeEngine(port, popts, max_batch=8)
    assert eng.warmup() == (4, 8)
    assert eng.stats["batching"]["pad_rows"] == 0
    _serve(eng, qs, pflt)
    assert eng.stats["batches"] > 0
    eng.reset_stats()
    st = eng.stats
    assert st["graph"] == st["brute"] == st["batches"] == 0
    assert st["obs"]["traces"] == 0 and not eng.latencies


def test_engine_mutation_stats_and_auto_merge(small_index, small_dataset):
    vecs, attrs, schema = small_dataset
    out = {}
    col = schema.int_index("i0")
    row = int(np.nonzero(attrs.ints[:, col] == 3)[0][0])
    rng = np.random.default_rng(89)
    new = rng.normal(size=(25, vecs.shape[1])).astype(np.float32)
    ints = np.tile(attrs.ints[row], (25, 1))
    floats = np.tile(attrs.floats[row], (25, 1))
    probes = rng.normal(size=(3, vecs.shape[1])).astype(np.float32)
    for pkg, eng_cls, be, opts, F in (
            ("jax", RServe,
             RBackend(RIndex(small_index.index, small_index.attrs)),
             ROpts(k=5, ef=48), RF),
            ("torch", ServeEngine, LocalBackend(_port_of(small_index)),
             SearchOptions(k=5, ef=48), PF)):
        eng = eng_cls(be, opts, merge_delta_frac=0.01, max_wait_ms=0.0)
        ids = eng.upsert(new, ints, floats)
        assert eng.delete([int(ids[0])]) == 1
        flt = F.Equality("i0", 3)
        for q in probes:
            eng.submit(q, flt)
        res = eng.run()
        st = eng.stats["mutations"]
        eng.submit(new[1], flt)
        own = eng.run()[0]
        out[pkg] = (ids, [r.ids for r in res], st, own.ids, be.version(),
                    be.versions())
    p, r = out["torch"], out["jax"]
    np.testing.assert_array_equal(p[0], r[0])
    for a, b in zip(p[1], r[1]):
        np.testing.assert_array_equal(a, b)
    assert p[2] == r[2]
    assert p[2]["upserts"] == 25 and p[2]["deletes"] == 1
    assert p[2]["auto_merges"] == 1 and p[2]["delta_rows"] == 0
    np.testing.assert_array_equal(p[3], r[3])
    assert int(p[0][1]) in p[3]
    assert p[4:] == r[4:]


def test_engine_mutation_unsupported_backend_raises(small_index):
    eng = ServeEngine(_port_of(small_index), SearchOptions(k=5, ef=48))

    class Static:
        def validate(self, o):
            pass

        def version(self):
            return 0

    eng.backend = Static()
    with pytest.raises(ValueError, match="does not support live mutation"):
        eng.upsert(np.zeros((1, 16), np.float32))
    with pytest.raises(ValueError, match="does not support live mutation"):
        eng.merge()
    with pytest.raises(ValueError, match="merge_delta_frac"):
        ServeEngine(_port_of(small_index), SearchOptions(k=5, ef=48),
                    merge_delta_frac=0.0)


def test_search_shim_bytes_per_vector_and_bump_version(small_index,
                                                       pq_pair, traffic):
    qs, rflt, pflt = traffic
    port = _port_of(small_index)
    with pytest.deprecated_call():
        legacy = port.search(qs, pflt, k=5, ef=48, use_pallas=True)
    typed = port.query(qs, pflt, SearchOptions(k=5, ef=48))
    with pytest.deprecated_call():
        ref = small_index.search(qs, rflt, k=5, ef=48)
    for r in (typed, ref):
        np.testing.assert_array_equal(legacy.ids, r.ids)
        np.testing.assert_array_equal(legacy.routed_brute, r.routed_brute)
    rq, pq = pq_pair
    for q in (False, True):
        assert (pq.bytes_per_vector(quantized=q)
                == rq.bytes_per_vector(quantized=q))
    assert port.bytes_per_vector() == small_index.bytes_per_vector()
    with pytest.raises(ValueError, match="not quantized"):
        port.bytes_per_vector(quantized=True)
    # bump_version: the same epochs as the JAX package, and the same
    # results after each bump (the device copies re-uploaded)
    ref = RIndex(small_index.index, small_index.attrs)
    port = _port_of(small_index)
    port.delete([3])
    ref.delete([3])
    for comps in (("attributes",), None, ("vectors", "graph")):
        assert port.bump_version(comps) == ref.bump_version(comps)
        assert port.versions() == ref.versions()
        got = port.query(qs, pflt, SearchOptions(k=K, ef=EF))
        want = ref.query(qs, rflt, ROpts(k=K, ef=EF))
        np.testing.assert_array_equal(got.ids, want.ids)
        assert 3 not in got.ids
    with pytest.raises(ValueError, match="unknown epoch component"):
        port.bump_version(("bogus",))


def test_legacy_build_kwargs_warn(small_index, small_dataset):
    _, attrs, _ = small_dataset
    idx = small_index.index
    with pytest.deprecated_call():
        fi = FavorIndex(idx, attrs, quantize="sq", rerank=2, device="cpu")
    with pytest.deprecated_call():
        ref = RIndex(idx, attrs, quantize="sq", rerank=2)
    assert fi.quantize == ref.quantize == "sq" and fi.rerank == 2
    assert dataclasses.asdict(fi.spec.quant) == dataclasses.asdict(
        ref.spec.quant)
    with pytest.deprecated_call():
        fi = FavorIndex(idx, attrs, SelectorConfig(lam=0.02), device="cpu")
    assert fi.sel_cfg.lam == 0.02
    with pytest.deprecated_call():
        fi = FavorIndex(idx, attrs, prefbf_chunk=512, device="cpu")
    assert fi.spec.prefbf_chunk == 512
    with pytest.raises(TypeError, match="BuildSpec"):
        FavorIndex(idx, attrs, {"quant": None}, device="cpu")
    with pytest.raises(TypeError, match="unexpected FavorIndex kwargs"):
        FavorIndex(idx, attrs, bogus=1, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        FavorIndex(idx, attrs, BuildSpec(), rerank=2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        FavorIndex(idx, attrs, rerank=None, device="cpu")   # all None: quiet


def test_favor_anns_config_matches_reference():
    r, p = r_favor_anns.FavorServeConfig(), favor_anns.FavorServeConfig()
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert (dataclasses.asdict(p.quant_spec())
            == dataclasses.asdict(r.quant_spec()))
    want = dataclasses.asdict(r.search_options())
    assert want.pop("use_pallas") is False     # the port has no such option
    assert dataclasses.asdict(p.search_options()) == want
    po = p.search_options(graph_quant="pq", ef=96)
    assert po.graph_quant == "pq" and po.ef == 96 and po.use_pq
    assert p.build_spec().quant == p.quant_spec()
    assert p.build_spec(quant=None).quant is None
    assert isinstance(p.build_spec(), BuildSpec)
    with pytest.deprecated_call():
        assert p.quant_kwargs() == {"quantize": "pq", "pq_m": 32,
                                    "pq_nbits": 8, "rerank": 8}
    spec, rspec = favor_anns.spec(), r_favor_anns.spec()
    assert (spec.arch_id, spec.family, [c.name for c in spec.cells]) == (
        rspec.arch_id, rspec.family, [c.name for c in rspec.cells])
    assert dataclasses.asdict(spec.reduced) == dataclasses.asdict(
        rspec.reduced)
    assert spec.config == p


def test_obs_facade_over_router_matches_reference(small_index, traffic):
    """``router.execute(obs=...)`` straight (no engine): the same trace as
    the JAX package's under a fake clock."""
    qs, rflt, pflt = traffic
    ropts, popts = _opts(batch=dict(min_bucket=4, max_bucket=16))
    r_obs = RObs(RObsSpec(slow_ms=0.0), time_fn=FakeClock())
    p_obs = Obs(ObsSpec(slow_ms=0.0), time_fn=FakeClock())
    r_router.execute(RBackend(small_index), qs, rflt, ropts, obs=r_obs)
    router.execute(_port_of(small_index).backend, qs, pflt, popts, obs=p_obs)
    p_tr = [t.to_dict() for t in p_obs.tracer.traces]
    assert ([_without_port_only(t) for t in p_tr]
            == [t.to_dict() for t in r_obs.tracer.traces])
    _assert_port_only(p_tr)
    assert p_obs.snapshot() == r_obs.snapshot()
