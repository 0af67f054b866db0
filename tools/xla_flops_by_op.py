#!/usr/bin/env python3
"""XLA's FLOPs of a reduced LM cell's program, by HLO opcode: the JAX
package's ``train_4k`` cell at the reduced config on a 1 x 1 mesh,
compiled with its layers unrolled, its optimized HLO summed instruction by
instruction inside every fusion by ``HloCostAnalysis``' rules (a dot 2 x
output x contracted size; an elementwise op one an element; a
transcendental none; a reduce input minus output elements, a
reduce-window output x window, a scatter its updates, each times its
reducer's FLOPs), beside ``cost_analysis()["flops"]``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/xla_flops_by_op.py \
        [--arch qwen1.5-32b] [--top 40]

Prints one JSON line: the cost analysis' FLOPs, the rebuilt total, and
the FLOPs by opcode and by the JAX op each instruction came from (its
``op_name``), largest first -- what the port's dry-run count
(``repro_torch.launch.dryrun.xla_flops``) is held to.  CPU only.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

TRANSCENDENTAL = {"exponential", "log", "tanh", "logistic", "sqrt", "rsqrt",
                  "power", "sine", "cosine", "exponential-minus-one",
                  "log-plus-one", "atan2", "erf", "cbrt", "tan"}
FREE = {"parameter", "constant", "broadcast", "reshape", "transpose", "copy",
        "slice", "concatenate", "pad", "gather", "dynamic-slice",
        "dynamic-update-slice", "iota", "tuple", "get-tuple-element",
        "bitcast", "reverse", "copy-start", "copy-done", "after-all",
        "partition-id", "replica-id", "opt-barrier", "custom-call", "while",
        "conditional", "sort", "all-gather", "all-to-all",
        "collective-permute", "reduce-scatter", "rng-bit-generator"}
SHAPE = re.compile(r"[a-z]+[0-9]*\[([0-9,]*)\]")


def _dims(shape: str) -> list[int]:
    m = SHAPE.search(shape)
    return [int(x) for x in m.group(1).split(",") if x] if m else []


def parse(text: str):
    """{computation: {"params": {name: shape}, "ins": [(name, shape, op,
    operands, attrs)]}} and the entry computation's name."""
    comps, cur, entry = {}, None, None
    for line in text.splitlines():
        if not line.startswith(" ") and line.endswith("{") and "->" in line:
            name = line.split()[1] if line.startswith("ENTRY") else \
                line.split()[0]
            entry = name if line.startswith("ENTRY") else entry
            cur = comps.setdefault(name, {"params": {}, "ins": []})
            sig = line[line.index("(") + 1: line.rindex("->")]
            for m in re.finditer(r"([%\w.\-]+): ([a-z]+[0-9]*\[[0-9,]*\])",
                                 sig):
                cur["params"][m.group(1)] = m.group(2)
            continue
        if line.startswith("}"):
            cur = None
            continue
        if cur is None or " = " not in line:
            continue
        lhs, rhs = line.strip().split(" = ", 1)
        m = re.match(r"(\(.*?\)|[a-z]+[0-9]*\[[0-9,]*\](?:\{[^}]*\})?) "
                     r"([a-z\-]+)\((.*?)\)(.*)$", rhs)
        if m:
            shape, op, operands, attrs = m.groups()
            cur["ins"].append((lhs.replace("ROOT ", ""), shape, op,
                               [o.strip() for o in operands.split(",")
                                if o.strip()], attrs))
    return comps, entry


def cost(comps, name: str, by_op, by_src) -> float:
    """The FLOPs of computation ``name``, added to the tallies."""
    c = comps[name]
    shapes = dict(c["params"])
    shapes.update({ins[0]: ins[1] for ins in c["ins"]})
    total = 0.0
    for lhs, shape, op, ops, attrs in c["ins"]:
        if op in ("fusion", "call"):
            callee = re.search(r"calls=([%\w.\-]+)", attrs).group(1)
            total += cost(comps, callee, by_op, by_src)
            continue
        sub = re.search(r"to_apply=([%\w.\-]+)", attrs)
        per = cost(comps, sub.group(1), collections.Counter(),
                   collections.Counter()) if sub else 1.0
        n = math.prod(_dims(shape)) if not shape.startswith("(") else 0
        if op == "dot":
            lc = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}",
                           attrs).group(1)
            ld = _dims(shapes[ops[0]])
            f = 2.0 * n * math.prod(ld[int(i)] for i in lc.split(",") if i)
        elif op == "reduce":
            out = shape[1:] if shape.startswith("(") else shape
            f = per * (math.prod(_dims(shapes[ops[0]]))
                       - math.prod(_dims(out)))
        elif op == "reduce-window":
            w = re.search(r"window=\{size=([0-9x]+)", attrs).group(1)
            f = per * n * math.prod(int(x) for x in w.split("x"))
        elif op in ("all-reduce", "scatter", "select-and-scatter"):
            f = per * n
        elif op in TRANSCENDENTAL or op in FREE:
            f = 0.0
        else:
            f = float(n)
        src = re.search(r'op_name="([^"]*)"', attrs)
        by_op[op] += f
        by_src[src.group(1).split("/")[-1] if src else "?"] += f
        total += f
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-32b")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args()
    import jax
    from jax.sharding import AxisType

    from repro.configs import get_spec
    from repro.launch import cells as JC
    from repro.launch import dryrun as JD
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])
    spec = get_spec(args.arch)
    cfg = dataclasses.replace(spec.reduced, unroll_layers=True)
    cell = JC.BUILDERS[spec.family](dataclasses.replace(spec, config=cfg),
                                    spec.cell("train_4k"), mesh)
    compiled = JD._lower_compile(cell, mesh)[1]
    comps, entry = parse(compiled.as_text())
    by_op, by_src = collections.Counter(), collections.Counter()
    total = cost(comps, entry, by_op, by_src)
    print(json.dumps({
        "arch": args.arch, "cell": "train_4k (reduced, unrolled, 1 x 1)",
        "cost_analysis_flops": float(compiled.cost_analysis()["flops"]),
        "rebuilt_flops": total,
        "by_opcode": dict(by_op.most_common(args.top)),
        "by_jax_op": dict(by_src.most_common(args.top))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
