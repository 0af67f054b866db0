"""Metrics registry: labeled counters, gauges and fixed-bucket histograms.

One ``MetricsRegistry`` per serving stack (``ServeEngine`` owns it through
``Obs``); every stats surface in the repo -- engine routing counters,
request-latency window, ShapeRegistry pad ledger, cache layer hit/miss,
mutation counters, frontend tenant ledgers -- either records into a typed
instrument here or registers a *view* (a zero-argument callable returning a
nested dict) so one ``snapshot()`` / ``prometheus_text()`` call exports the
whole system.

Design constraints, in order:

  * **Lock-cheap on the hot path.**  An ``inc``/``observe`` is a dict lookup
    plus a float add on a plain ``dict`` -- atomic under the GIL, so no lock
    is taken per sample.  The registry lock guards registration only (cold
    path, idempotent ``counter()``/``gauge()``/``histogram()`` lookups).
  * **Labels declared once.**  Each instrument fixes its label *names* at
    creation; a sample supplies the label *values* as kwargs and lands in
    its own series.  Mismatched label sets raise instead of silently
    creating junk series.
  * **Resets cascade.**  ``reset()`` zeroes every instrument, then runs the
    registered ``on_reset`` hooks -- the engine, frontend and cache layers
    hang their legacy-counter resets there, so one call zeroes the stack
    (the ``ServeEngine.reset_stats`` contract).

The port's copy of the JAX package's ``repro.obs.registry`` (pure Python);
``tests/test_torch_obs.py`` holds the two to the same behaviour.
"""
from __future__ import annotations

import threading

# shared default: matches ObsSpec.latency_buckets (seconds)
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                   0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats print as integers."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _fmt_le(b: float) -> str:
    return "+Inf" if b == float("inf") else ("%g" % b)


def _label_str(names: tuple, values: tuple) -> str:
    return ",".join(f'{n}="{v}"' for n, v in zip(names, values))


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, labels=()):
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"bad metric name {name!r} (use "
                             "[a-zA-Z0-9_], prometheus-style)")
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._series: dict[tuple, object] = {}

    def _key(self, labels: dict) -> tuple:
        if len(labels) != len(self.labels) or \
                any(k not in labels for k in self.labels):
            raise ValueError(f"{self.name} takes labels {self.labels}, "
                             f"got {tuple(labels)}")
        return tuple(str(labels[k]) for k in self.labels)

    def series(self) -> dict:
        """label-values tuple -> raw series state (copy)."""
        return dict(self._series)


class Counter(_Instrument):
    """Monotonically increasing float (resets only via registry.reset)."""
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(amount={amount})")
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))

    def total(self) -> float:
        return float(sum(self._series.values()))

    def reset(self) -> None:
        for key in self._series:
            self._series[key] = 0.0


class Gauge(_Instrument):
    """Point-in-time value (set/add semantics)."""
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[self._key(labels)] = float(value)

    def add(self, amount: float, **labels) -> None:
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))

    def reset(self) -> None:
        for key in self._series:
            self._series[key] = 0.0


class Histogram(_Instrument):
    """Fixed-bucket histogram: per-series cumulative-able counts + sum.

    ``buckets`` are inclusive upper bounds (prometheus ``le`` semantics);
    an implicit +Inf bucket catches the overflow.  ``observe_many`` takes a
    sequence and bins it in one numpy pass -- the engine uses it for
    per-batch p_hat distributions without a python loop per row.
    """
    kind = "histogram"

    def __init__(self, name, help, labels=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        buckets = tuple(float(b) for b in buckets)
        if not buckets or any(a >= b for a, b in zip(buckets, buckets[1:])):
            raise ValueError(f"histogram {name} buckets must be strictly "
                             f"increasing, got {buckets}")
        self.buckets = buckets

    def _slot(self, key: tuple) -> list:
        s = self._series.get(key)
        if s is None:
            # [per-bucket counts (+Inf last), sum, count]
            s = self._series[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
        return s

    def observe(self, value: float, **labels) -> None:
        s = self._slot(self._key(labels))
        value = float(value)
        lo, hi = 0, len(self.buckets)
        while lo < hi:  # bisect_left over bounds: first bucket with le >= v
            mid = (lo + hi) // 2
            if self.buckets[mid] < value:
                lo = mid + 1
            else:
                hi = mid
        s[0][lo] += 1
        s[1] += value
        s[2] += 1

    def observe_many(self, values, **labels) -> None:
        import numpy as np
        values = np.asarray(values, np.float64).ravel()
        if not len(values):
            return
        s = self._slot(self._key(labels))
        idx = np.searchsorted(np.asarray(self.buckets), values, side="left")
        for i, c in zip(*np.unique(idx, return_counts=True)):
            s[0][int(i)] += int(c)
        s[1] += float(values.sum())
        s[2] += int(len(values))

    def count(self, **labels) -> int:
        s = self._series.get(self._key(labels))
        return int(s[2]) if s else 0

    def sum(self, **labels) -> float:
        s = self._series.get(self._key(labels))
        return float(s[1]) if s else 0.0

    def percentile(self, p: float, **labels) -> float | None:
        """Bucket-interpolated percentile estimate (None when empty)."""
        s = self._series.get(self._key(labels))
        if not s or not s[2]:
            return None
        target = s[2] * min(max(p / 100.0, 0.0), 1.0)
        cum, lo = 0, 0.0
        for i, c in enumerate(s[0]):
            if cum + c >= target and c:
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1])
                frac = (target - cum) / c
                return lo + (hi - lo) * frac
            cum += c
            if i < len(self.buckets):
                lo = self.buckets[i]
        return self.buckets[-1]

    def reset(self) -> None:
        for key in self._series:
            self._series[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]


class MetricsRegistry:
    """Instrument + view + reset-hook registry (module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Instrument] = {}
        self._views: dict[str, object] = {}
        self._reset_hooks: list = []

    # -- registration (idempotent: same name returns the same instrument) ----
    def _get(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labels != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}{m.labels}, cannot re-register "
                        f"as {cls.__name__}{tuple(labels)}")
                return m
            m = cls(name, help, labels, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def register_view(self, name: str, fn) -> None:
        """Attach a zero-arg callable whose nested-dict result joins every
        snapshot/exposition (last registration under a name wins -- e.g. a
        rebuilt frontend re-binding its ledger view)."""
        with self._lock:
            self._views[name] = fn

    def has_view(self, name: str) -> bool:
        return name in self._views

    def view(self, name: str) -> dict:
        return self._views[name]()

    def on_reset(self, fn) -> None:
        """Run ``fn`` on every ``reset()`` -- the cascade hook legacy
        counters (latency deques, tenant ledgers, cache layers) hang on."""
        with self._lock:
            self._reset_hooks.append(fn)

    # -- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()
        for fn in list(self._reset_hooks):
            fn()

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able export of every instrument and view."""
        out = {"counters": {}, "gauges": {}, "histograms": {}, "views": {}}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                series = {}
                for key, s in m.series().items():
                    cum, buckets = 0, []
                    for le, c in zip(m.buckets + (float("inf"),), s[0]):
                        cum += c
                        buckets.append([_fmt_le(le), cum])
                    series[_label_str(m.labels, key)] = {
                        "buckets": buckets, "sum": s[1], "count": s[2]}
                out["histograms"][name] = {"help": m.help, "series": series}
            else:
                slot = "counters" if isinstance(m, Counter) else "gauges"
                out[slot][name] = {
                    "help": m.help,
                    "series": {_label_str(m.labels, k): v
                               for k, v in m.series().items()}}
        for name, fn in self._views.items():
            out["views"][name] = fn()
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format, views flattened into one
        ``favor_view`` gauge family labeled (view, path)."""
        lines = []
        for name, m in self._metrics.items():
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, s in sorted(m.series().items()):
                    base = _label_str(m.labels, key)
                    sep = "," if base else ""
                    cum = 0
                    for le, c in zip(m.buckets + (float("inf"),), s[0]):
                        cum += c
                        lines.append(f'{name}_bucket{{{base}{sep}le='
                                     f'"{_fmt_le(le)}"}} {cum}')
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{name}_sum{suffix} {_fmt(s[1])}")
                    lines.append(f"{name}_count{suffix} {s[2]}")
            else:
                for key, v in sorted(m.series().items()):
                    base = _label_str(m.labels, key)
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{name}{suffix} {_fmt(v)}")
        if self._views:
            lines.append("# HELP favor_view Flattened numeric leaves of "
                         "registered stats views")
            lines.append("# TYPE favor_view gauge")
            for vname in sorted(self._views):
                for path, v in _flatten(self._views[vname]()):
                    lines.append(f'favor_view{{view="{vname}",'
                                 f'path="{path}"}} {_fmt(v)}')
        return "\n".join(lines) + "\n"


def _flatten(d, prefix=""):
    """Numeric leaves of a nested dict as (dot.path, value) pairs."""
    out = []
    if not isinstance(d, dict):
        return out
    for k in sorted(d, key=str):
        v = d[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(_flatten(v, path + "."))
        elif isinstance(v, bool):
            out.append((path, 1.0 if v else 0.0))
        elif isinstance(v, (int, float)):
            out.append((path, float(v)))
    return out
