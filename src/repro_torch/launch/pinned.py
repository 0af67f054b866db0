"""The partitioned counts of two reduced cells on the (2, 4) test mesh,
pinned: gemma2-2b ``train_4k`` (attention, the split head dimension, the
softcaps) and gcn-cora ``ogb_products`` (the edge scatter-adds).

DTensor's strategies change between torch versions, and with them the
collectives a count charges.  The count's own rules (``dryrun._RULES``) fix
the strategy wherever the versions differ, so one table holds for every
torch: the CPU tests hold the torch they run under to it, and
``chip_smoke.py``'s ``dryrun`` phase the card machine's (hard checks).

    PYTHONPATH=src python -m repro_torch.launch.pinned [--out F.json]

counts both cells and prints, as one JSON line, each one's FLOPs per
device, its collectives by kind (count and link bytes), the ops split by a
rule or replicated, its heaviest collective sites, the torch version, and
its differences from the table; exits 1 when there is one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

PINNED = {
    "gemma2-2b:train_4k": {
        "flops": 1913857295473.0,
        "counts": {"all-gather": 10, "all-reduce": 63, "all-to-all": 2},
        "by_op": {"all-gather": 402800640.0, "all-reduce": 3033734692.0,
                  "all-to-all": 100663296.0},
    },
    "gcn-cora:ogb_products": {
        "flops": 34946827950.0,
        "counts": {"all-reduce": 4},
        "by_op": {"all-reduce": 2160043578.0},
    },
}


def count_cell(key: str):
    """The partitioned count (``dryrun.Count``) of the pinned cell ``key``
    ("arch:shape") at its reduced config on the (2, 4) test mesh."""
    from ..configs import get_spec
    from . import cells as C
    from . import dryrun as D
    from .mesh import make_test_mesh
    arch, shape = key.split(":")
    spec = get_spec(arch)
    mesh = make_test_mesh()
    cell = C.BUILDERS[spec.family](dataclasses.replace(
        spec, config=spec.reduced), spec.cell(shape), mesh)
    return D.count(cell.step_fn, cell.args, shardings=cell.in_shardings,
                   mesh=mesh)


def record(c) -> dict:
    """A count's pinned terms, and what explains them."""
    return {"flops": c.cost.flops,
            "counts": dict(sorted(c.cost.collectives["counts"].items())),
            "by_op": dict(sorted(c.cost.collectives["by_op"].items())),
            "split_by_rule": c.split, "replicated_ops": c.replicated,
            "sites": dict(sorted(c.sites.items(), key=lambda kv: -kv[1]))}


def measure(key: str) -> dict:
    return record(count_cell(key))


def differences(key: str, got: dict) -> list[str]:
    """How ``got`` (``measure``'s record) departs from the table: counts
    equal, link bytes and FLOPs equal to a relative 1e-9 (float sums)."""
    want, out = PINNED[key], []
    if got["counts"] != want["counts"]:
        out.append(f"{key} counts {got['counts']} != {want['counts']}")
    if set(got["by_op"]) != set(want["by_op"]) or any(
            not math.isclose(got["by_op"][k], v, rel_tol=1e-9)
            for k, v in want["by_op"].items()):
        out.append(f"{key} link bytes {got['by_op']} != {want['by_op']}")
    if want["flops"] is None or not math.isclose(got["flops"], want["flops"],
                                                 rel_tol=1e-9):
        out.append(f"{key} flops {got['flops']!r} != {want['flops']!r}")
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rec = {"torch": torch.__version__, "cells": {}, "differences": []}
    for key in PINNED:
        got = measure(key)
        rec["cells"][key] = got
        rec["differences"] += differences(key, got)
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 1 if rec["differences"] else 0


if __name__ == "__main__":
    sys.exit(main())
