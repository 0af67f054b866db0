"""The router's traces of a traced run's window, for the readers of
program spans and counters.

A traced run's ``Runner`` has the router trace every batch; the port keeps
each finished trace in ``repro_torch.obs.trace.finished``, the process's
ring of the last traces any tracer finished.  The window's traces are those
that began after its first dispatch and ended before its last finish.  A
batch record that carries its trace as ``trace`` (``RequestTrace.to_dict``)
is read instead.  A program without the ring, or a run without traces,
gives none, and its readers read nothing.
"""
from __future__ import annotations


def window_traces(ctx) -> list:
    """The window's traces as ``RequestTrace.to_dict()`` dicts, in order."""
    rows = ctx.get("batches") or []
    if not rows:
        return []
    if all("trace" in r for r in rows):
        return [r["trace"] for r in rows]
    try:
        from repro_torch.obs.trace import finished
    except ImportError:
        return []
    t0, t1 = rows[0]["t_dispatch"], rows[-1]["t_finish"]
    return [t.to_dict() for t in list(finished)
            if t.t1 is not None and t0 <= t.t0 and t.t1 <= t1]


def span_attrs(traces, path: tuple) -> list:
    """The ``attrs`` of every span at ``path`` (span names from the top)."""
    out = []
    for t in traces:
        level = t["spans"]
        for depth, name in enumerate(path):
            found = [s for s in level if s["name"] == name]
            if depth == len(path) - 1:
                out += [s["attrs"] for s in found]
            level = [c for s in found for c in s["children"]]
    return out


def total(attrs: list, key: str):
    """The sum of ``key`` over ``attrs``, or None where none has it."""
    vals = [a[key] for a in attrs if key in a]
    return sum(vals) if vals else None


def per_kq(traces, value: float) -> float:
    """``value`` per 1,000 of the traces' queries."""
    return 1e3 * value / sum(t["batch"] for t in traces)
