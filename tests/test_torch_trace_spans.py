"""The port's spans and counters inside the router and the wave loop
(``repro_torch.obs.trace``, ``core/router.py``, ``core/search.py``), on a
tiny index on the CPU: the wave counters are exact, tracing changes no
answer bit and no untraced op, and under kernel annotations every span is
a profiler range of the same name, nesting and length."""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.core import (BatchSpec, FavorIndex, HnswParams,  # noqa: E402
                              ObsSpec, SearchOptions, exclusion, router,
                              search)
from repro_torch.core import filters as F  # noqa: E402
from repro_torch.core.search import SearchConfig  # noqa: E402
from repro_torch.obs import Obs, profiling  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402

N, DIM, B = 600, 16, 12
WAVE_KEYS = ("waves", "sync_ms", "lanes_active", "lanes_launched",
             "ids_launched", "ids_useful")
# attributes read with the host's clock: they differ between two runs
TIMED = ("upload_ms", "read_ms", "finish_wait_ms", "sync_ms")
# torch ops an untraced traversal of ``_setup``'s batch issues, counted by
# ``_ops`` under a dispatch mode with lane_compact=0: the counts the
# traversal issued before it had counters (3 and 9 waves: 169 a wave)
UNTRACED_OPS = {3: 1172, 9: 2186}


class FakeClock:
    def __init__(self, tick=0.001):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(N, DIM)).astype(np.float32)
    schema = F.paper_schema()
    attrs = F.random_attributes(schema, N, seed=9)
    fi = FavorIndex.build(vecs, attrs, HnswParams(M=6, efc=32, seed=3),
                          device="cpu")
    flts = list(F.paper_filters(schema).values())
    flts = [flts[i % len(flts)] for i in range(B)]
    q = torch.as_tensor(rng.normal(size=(B, DIM)).astype(np.float32))
    return fi, q, flts


def _inputs(fi, flts, cfg):
    """The traversal's filter programs and exclusion distances."""
    progs = fi.compile_filters(flts)
    p_hat = fi.backend.estimate(progs)
    return progs, exclusion.exclusion_distance(
        p_hat, cfg.ef, fi.delta_d, k=cfg.k, p_min=fi.sel_cfg.p_min, xp=torch)


def _traverse(fi, q, flts, cfg):
    return search.favor_graph_search(fi.g, q, *_inputs(fi, flts, cfg), cfg)


def _traced_traverse(fi, q, flts, cfg):
    """The traversal inside a sampled trace's span; (output, attrs)."""
    tr = T.RequestTrace(1, B, time.perf_counter)
    with tr.span("search") as sp:
        out = _traverse(fi, q, flts, cfg)
    tr.finish()
    return out, sp.attrs


def _ops(fi, q, flts, cfg, traced=False):
    """Torch ops the traversal issues (dispatch-mode count) and its waves."""
    progs, D = _inputs(fi, flts, cfg)
    tr = T.RequestTrace(1, B, time.perf_counter) if traced else None
    with _Count() as c:
        if traced:
            with tr.span("search"):
                out = search.favor_graph_search(fi.g, q, progs, D, cfg)
        else:
            out = search.favor_graph_search(fi.g, q, progs, D, cfg)
    return c.n, int(out["waves"][0])


def test_neighbour_lists_repeat_no_id(setup):
    """The recount below needs lists without repeats (``new`` counts each
    copy of a repeated id, the visited set one bit)."""
    nb = setup[0].g["neighbors0"].numpy()
    for row in nb:
        ids = row[row >= 0]
        assert len(ids) == len(set(ids.tolist()))


@pytest.mark.parametrize("lane_compact", [0, 2])
def test_wave_counters_are_exact(setup, monkeypatch, lane_compact):
    """``ids_useful`` is the bits set in the traversal's visited sets less
    each lane's entry point (recounted at lane_compact=0, and the same with
    the ladder on); ``lanes_*`` and ``ids_launched`` replay the waves'
    widths; ``waves`` is the result's."""
    fi, q, flts = setup
    cfg = SearchConfig(k=5, ef=32, lane_compact=lane_compact)
    widths, visited = [], []
    seen, visit = search._seen_bits, search._visit_bits

    def seen_bits(v, rows, safe):
        widths.append(int(safe.shape[0]))
        return seen(v, rows, safe)

    def visit_bits(v, rows, safe, mark):
        out = visit(v, rows, safe, mark)
        visited[:] = [out.clone()]
        return out
    monkeypatch.setattr(search, "_seen_bits", seen_bits)
    monkeypatch.setattr(search, "_visit_bits", visit_bits)
    out, attrs = _traced_traverse(fi, q, flts, cfg)
    m0 = fi.g["neighbors0"].shape[1]
    waves = int(out["waves"][0])
    assert attrs["waves"] == waves == len(widths)
    assert waves < cfg.steps
    assert attrs["lanes_launched"] == sum(widths)
    assert attrs["ids_launched"] == sum(widths) * m0
    # every lane is active at the start of each wave it expands in and of
    # the one it stops in
    assert attrs["lanes_active"] == int(out["hops"].sum()) + B
    assert attrs["sync_ms"] >= 0.0
    assert isinstance(attrs["ids_useful"], int)
    if lane_compact == 0:
        bits = np.unpackbits(visited[0].numpy().view(np.uint8)).sum()
        assert attrs["ids_useful"] == int(bits) - B
        assert set(widths) == {B}
    else:
        assert len(set(widths)) > 1
        assert attrs["ids_useful"] == _traced_traverse(
            fi, q, flts, SearchConfig(k=5, ef=32, lane_compact=0))[1][
                "ids_useful"]


def test_traced_and_untraced_answers_are_bit_identical(setup):
    fi, q, flts = setup
    for force in (None, "graph"):
        opts = SearchOptions(k=5, ef=32, force=force)
        plain = fi.query(q, flts, opts)
        obs = Obs(ObsSpec(slow_ms=None), time_fn=FakeClock())
        traced = fi.query(q, flts, opts, obs=obs)
        for key in ("ids", "hops", "path_td", "waves", "routed_brute"):
            np.testing.assert_array_equal(getattr(traced, key),
                                          getattr(plain, key))
        assert np.array_equal(traced.dists.view(np.uint32),
                              plain.dists.view(np.uint32))
        search_sp = [c for s in obs.tracer.traces[-1].spans
                     if s.name == "graph" for c in s.children
                     if c.name == "search"]
        assert len(search_sp) == 1
        assert set(WAVE_KEYS) <= set(search_sp[0].attrs)
        assert search_sp[0].attrs["waves"] == int(plain.waves.max())


def test_untraced_wave_issues_the_ops_it_issued_before(setup):
    """Without a sampled trace the loop issues exactly the torch ops it
    issued before it had counters; a traced traversal adds two a wave (the
    useful-id count's sum and add) and one at its end."""
    fi, q, flts = setup
    counts = {}
    for steps in UNTRACED_OPS:
        cfg = SearchConfig(k=5, ef=32, lane_compact=0, max_steps=steps)
        n, waves = _ops(fi, q, flts, cfg)
        assert waves == steps
        counts[steps] = n
        n_tr, _ = _ops(fi, q, flts, cfg, traced=True)
        assert n_tr == n + 2 * waves + 1
    assert counts == UNTRACED_OPS


def test_favor_index_query_traces_as_execute(setup):
    fi, q, flts = setup
    opts = SearchOptions(k=5, ef=32)
    dicts = []
    for run in (lambda o: fi.query(q, flts, opts, obs=o),
                lambda o: router.execute(fi.backend, q, flts, opts, obs=o)):
        obs = Obs(ObsSpec(slow_ms=None), time_fn=FakeClock())
        run(obs)
        dicts.append(_untimed(obs.tracer.traces[-1].to_dict()))
    assert dicts[0] == dicts[1]
    assert any(s["name"] == "graph" for s in dicts[0]["spans"])


def _untimed(d: dict) -> dict:
    """A trace or span dict without the attributes read on the host's
    clock."""
    out = dict(d, attrs={k: v for k, v in d["attrs"].items()
                         if k not in TIMED})
    key = "spans" if "spans" in d else "children"
    out[key] = [_untimed(c) for c in d[key]]
    return out


def _ranges(path) -> list:
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("favor/")]


def test_spans_are_profiler_ranges(setup, tmp_path):
    """Under kernel annotations every span is a range named by its path,
    nested as the spans are and as long within 10 % or 200 us; the waits on
    the device have ranges of their own."""
    fi, q, flts = setup
    flts = flts[:-1] + [F.And(F.Equality("i0", 3), F.Range("f0", 10, 12))]
    opts = SearchOptions(k=5, ef=32,
                         batch=BatchSpec(min_bucket=4, max_bucket=16))
    obs = Obs(ObsSpec(slow_ms=None, kernel_annotations=True))
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            router.execute(fi.backend, q, flts, opts, obs=obs)
    finally:
        profiling.set_kernel_annotations(False)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    ranges = _ranges(tmp_path / "trace.json")
    by_name = {}
    for e in ranges:
        by_name.setdefault(e["name"], []).append(e)
    tr = obs.tracer.traces[-1]
    assert {s.name for s in tr.spans} >= {"compile", "estimate", "graph",
                                          "brute"}

    def check(spans, path, parent):
        for sp in spans:
            name = f"{path}/{sp.name}"
            (e,) = by_name.pop(name)
            dur_ms = float(e["dur"]) / 1e3
            assert abs(dur_ms - sp.duration_s * 1e3) <= max(
                0.1 * sp.duration_s * 1e3, 0.2), name
            if parent is not None:
                assert float(parent["ts"]) <= float(e["ts"])
                assert (float(e["ts"]) + float(e["dur"])
                        <= float(parent["ts"]) + float(parent["dur"]))
            check(sp.children, name, e)
    check(tr.spans, "favor", None)
    for name in ("favor/compile/upload", "favor/estimate/read",
                 "favor/finish/wait", "favor/graph/sync"):
        assert by_name.get(name), (name, sorted(by_name))
    waves = next(c for s in tr.spans if s.name == "graph"
                 for c in s.children if c.name == "search").attrs["waves"]
    assert len(by_name["favor/graph/sync"]) >= waves
