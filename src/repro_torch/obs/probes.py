"""Selectivity-estimator accuracy probes and route-decision confusion.

FAVOR's stable-QPS claim stands on the selector routing queries correctly
off an *estimated* selectivity (paper section 4.1: ``p_hat < lambda`` ->
brute PreFBF, else exclusion-distance graph search).  Generic metrics stacks
can't see whether that estimate is right; these probes can, because they sit
next to the corpus:

  * ``EstimatorProbe`` -- on a sampled batch, pick one query and evaluate
    its compiled filter program over the backend's *actual* attribute
    columns (host-side, exact).  ``|p_hat - p_true|`` lands in an error
    histogram; when truth and estimate fall on opposite sides of lambda the
    route-flip counter increments (labeled by the route actually taken) --
    a flip means the selector mis-routed that query.

  * ``RouteConfusion`` -- estimator error only matters when the *other*
    route would have been faster.  On a sampled batch, re-execute one query
    on BOTH routes (force="graph" / force="brute") against the innermost
    (cache-unwrapped) backend and time them; the confusion counter is
    labeled (chosen, faster), and the regret counter accumulates the
    seconds lost when chosen != faster.  Shadow executions never touch the
    cache layers and never record into the engine's shape ledger.  Each
    shadow run's time ends in the host copies ``router.execute`` makes of
    its results, so it covers the device work.

Both are sampled (deterministic 1-in-N) and default OFF in ``ObsSpec`` --
they do real work and are meant for benches and diagnosis windows.
"""
from __future__ import annotations

import time

from ..device import to_host as _host
from .trace import sample_period

# |p_hat - p_true| bounds: estimates live in [0,1]; sub-0.001 error is noise
ERROR_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                 0.1, 0.25, 0.5, 1.0)


def innermost(backend):
    """Unwrap cache/decorator backends to the executing one."""
    target, inner = backend, getattr(backend, "inner", None)
    while inner is not None:
        target, inner = inner, getattr(inner, "inner", None)
    return target


def corpus_attrs(backend):
    """(ints, floats) attribute columns of the backend's base corpus as
    host arrays, or None when the backend shape is unknown.  LocalBackend
    exposes them on its FavorIndex; a backend holding a device-array dict
    (the sharded layout) under ``sharded.arrays``."""
    target = innermost(backend)
    fi = getattr(target, "index", None)
    attrs = getattr(fi, "attrs", None)
    if attrs is not None:
        return _host(attrs.ints), _host(attrs.floats)
    sh = getattr(target, "sharded", None)
    arrays = getattr(sh, "arrays", None)
    if arrays is not None and "attrs_int" in arrays:
        return _host(arrays["attrs_int"]), _host(arrays["attrs_float"])
    return None


def true_fraction(backend, flt) -> float | None:
    """Exact corpus match fraction of ``flt`` (the estimator's ground
    truth), or None when the corpus attributes are unreachable/empty."""
    from ..core import filters as F  # lazy: keep obs import-light
    attrs = corpus_attrs(backend)
    if attrs is None or not len(attrs[0]):
        return None
    prog = F.compile_filter(flt, backend.schema)
    mask = F.eval_program(prog, attrs[0], attrs[1]).numpy()
    return float(mask.mean())


class EstimatorProbe:
    def __init__(self, spec, registry):
        self._period = sample_period(spec.probe_sample)
        self._seen = 0
        self._next_q = 0
        self._m_err = registry.histogram(
            "favor_estimator_abs_error",
            "|p_hat - true match fraction| on probed queries",
            buckets=ERROR_BUCKETS)
        self._m_probes = registry.counter(
            "favor_estimator_probes_total",
            "Estimator accuracy probes run, by route taken",
            labels=("route",))
        self._m_flips = registry.counter(
            "favor_estimator_route_flips_total",
            "Probes where truth and estimate disagree across lambda",
            labels=("route",))

    def maybe_probe(self, backend, flts, res) -> None:
        """Sampled: check one query of this batch against ground truth."""
        if not self._period:
            return
        self._seen += 1
        if (self._seen - 1) % self._period:
            return
        i = self._next_q % len(flts)
        self._next_q += 1
        p_true = true_fraction(backend, flts[i])
        if p_true is None:
            return
        p_hat = float(res.p_hat[i])
        route = "brute" if res.routed_brute[i] else "graph"
        self._m_err.observe(abs(p_hat - p_true))
        self._m_probes.inc(route=route)
        lam = float(backend.sel_cfg.lam)
        if (p_true < lam) != (p_hat < lam):
            self._m_flips.inc(route=route)

    def reset(self) -> None:
        self._seen = 0
        self._next_q = 0


class RouteConfusion:
    def __init__(self, spec, registry, time_fn=time.perf_counter):
        self._period = sample_period(spec.shadow_sample)
        self._seen = 0
        self._next_q = 0
        self._time = time_fn
        self._m_shadow = registry.counter(
            "favor_route_shadow_total",
            "Shadow executions, by (route chosen, route that was faster)",
            labels=("chosen", "faster"))
        self._m_regret = registry.counter(
            "favor_route_regret_seconds_total",
            "Wall time lost to queries routed onto the slower route "
            "(shadow-measured)")

    def maybe_shadow(self, backend, queries, flts, res, opts) -> None:
        """Sampled: run one query on both routes, record which was faster.

        Executes against the innermost backend so shadow traffic cannot
        pollute (or be served by) the cache layers; first-shadow timings can
        include a compile for a not-yet-warmed forced-route bucket, which
        sampling amortizes away."""
        if not self._period:
            return
        self._seen += 1
        if (self._seen - 1) % self._period:
            return
        from ..core import router  # lazy: avoid core<->obs import cycles
        i = self._next_q % len(flts)
        self._next_q += 1
        target = innermost(backend)
        q = _host(queries[i:i + 1])
        times = {}
        for route in ("graph", "brute"):
            t0 = self._time()
            router.execute(target, q, [flts[i]], opts.with_(force=route))
            times[route] = self._time() - t0
        chosen = "brute" if res.routed_brute[i] else "graph"
        faster = min(times, key=times.get)
        self._m_shadow.inc(chosen=chosen, faster=faster)
        if faster != chosen:
            self._m_regret.inc(times[chosen] - times[faster])

    def reset(self) -> None:
        self._seen = 0
        self._next_q = 0
