"""The general traffic generator: a mix file's filter templates, drawn per
query from the seed.

A traffic file (``traffic/<name>.json``) holds ``batch`` (queries a batch),
``pool`` (distinct batches made at set-up; the window cycles through them),
``check_per_batch`` (answers a batch contributes to the sample the
reference checks), ``trace_batches`` (batches the profiler covers in a
``--trace 1`` run) and ``mix``: a list of scenarios, each a ``name``, a
``weight`` and a ``filter`` template.

A template is a JSON list: ``["eq", column, value]``, ``["in", column,
values]``, ``["range", column, lo, hi]``, ``["and", t, ...]``,
``["or", t, ...]`` or ``["not", t]``.  A value is a number or a draw:
``{"int": [a, b]}`` (uniform over a..b inclusive), ``{"uniform": [a, b]}``
(uniform real, rounded to float32), ``{"choose": [n, k]}`` (k distinct ints
of 0..n-1, sorted); a range's ``hi`` may be ``{"plus": value}``, its ``lo``
plus the value.  Every real bound is rounded to float32, the precision the
attributes are stored in, so that the program and the reference read the
same bound.  Drawn templates ("specs") have the same shape with numbers in
place of draws; the program side turns them into the port's filters, the
reference evaluates them itself.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

KEYS = ("batch", "pool", "check_per_batch", "trace_batches", "mix")


def load(path) -> dict:
    traffic = json.loads(Path(path).read_text())
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise ValueError(f"{path}: traffic file lacks {missing}")
    return traffic


def _f32(x: float) -> float:
    return float(np.float32(x))


def _value(v, rng: np.random.Generator):
    if not isinstance(v, dict):
        return v
    (kind, arg), = v.items()
    if kind == "int":
        return int(rng.integers(arg[0], arg[1] + 1))
    if kind == "uniform":
        return _f32(rng.uniform(arg[0], arg[1]))
    if kind == "choose":
        return sorted(int(x) for x in rng.choice(arg[0], size=arg[1],
                                                 replace=False))
    raise ValueError(f"unknown draw {kind!r}")


def draw(template, rng: np.random.Generator):
    """One spec from ``template``."""
    op = template[0]
    if op in ("and", "or"):
        return [op] + [draw(t, rng) for t in template[1:]]
    if op == "not":
        return ["not", draw(template[1], rng)]
    if op in ("eq", "in"):
        return [op, template[1], _value(template[2], rng)]
    if op == "range":
        lo = _value(template[2], rng)
        hi = template[3]
        if isinstance(hi, dict) and "plus" in hi:
            hi = _f32(lo + _value(hi["plus"], rng))
        else:
            hi = _value(hi, rng)
        return ["range", template[1], lo, hi]
    raise ValueError(f"unknown filter op {op!r}")


def draw_batch(traffic: dict, count: int, rng: np.random.Generator):
    """``count`` specs and the scenario name of each."""
    mix = traffic["mix"]
    w = np.asarray([float(s["weight"]) for s in mix])
    pick = rng.choice(len(mix), size=count, p=w / w.sum())
    return ([draw(mix[j]["filter"], rng) for j in pick],
            [mix[j]["name"] for j in pick])
