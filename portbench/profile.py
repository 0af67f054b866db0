"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a few
batches of the window, read back from its Chrome trace.

``summarize`` reduces the trace to what the per-layer readers and the
result's ``device`` and ``breakdown`` take: the traced window's length,
the seconds in which a device operation ran (the union of kernel, memcpy
and memset intervals), the device time of each operation name, and the
idle gaps with the host range or operator in progress at each gap's middle.
The interval arithmetic is ``chip_smoke.py``'s ``trace_summary``.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from contextlib import contextmanager

import torch

WINDOW = "portbench/traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@contextmanager
def traced(out: dict):
    """Profile the block; on exit ``out`` gets ``summarize``'s reading.
    The device is synchronised on entry and exit, so the trace holds the
    device work of exactly the calls made inside."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    out.update(summarize(events))


def _merged(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    """A host range's name without its bucket size (favor/graph/b9472 ->
    favor/graph)."""
    return re.sub(r"/b\d+$", "", str(name))[:120]


def _end(e) -> float:
    return float(e["ts"]) + float(e["dur"])


def summarize(events) -> dict:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) <= w1]
    merged = _merged((float(e["ts"]), min(w1, float(e["ts"]) + float(e["dur"])))
                     for e in dev)
    busy = sum(max(0.0, min(b, w1) - max(a, w0)) for a, b in merged)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) / 1e6
    host = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") != WINDOW and w0 <= float(e["ts"]) <= w1]
    host.sort(key=lambda e: float(e["ts"]))
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    # innermost host range at each gap's middle: one sweep over the host
    # events in start order, keeping the chain of ranges still open
    idle: dict[str, float] = {}
    stack: list = []
    j = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while j < len(host) and float(host[j]["ts"]) <= mid:
            e = host[j]
            while stack and _end(stack[-1]) < float(e["ts"]):
                stack.pop()
            stack.append(e)
            j += 1
        while stack and _end(stack[-1]) < mid:
            stack.pop()
        name = _short(stack[-1]["name"]) if stack else "no host range"
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "device_s": by_name,
            "device_ops": sorted(([n[:120], s] for n, s in by_name.items()),
                                 key=lambda r: -r[1])[:TOP],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                key=lambda r: -r[1])[:TOP]}
