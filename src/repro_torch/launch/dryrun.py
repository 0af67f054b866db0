"""The multi-pod dry run on the H100's constants, over ``meta`` tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out dryrun_results.json] [--skip-favor]

The counterpart of the JAX package's lower-and-compile: each cell's step
(``cells.py``) runs once on ``meta`` tensors -- nothing is allocated and no
device is touched -- under a counting dispatch mode.  Every output that
lands off ``meta`` is recorded with its op, shape, bytes and calling line
(``off_meta_ops``; ``torch.utils.checkpoint`` in torch 2.11 makes one empty
host tensor, 0 bytes, per checkpointed layer), and ``off_meta_bytes`` sums
them: the dry run allocates nothing when it is 0 and no card is named.

  * FLOPs are ``torch.utils.flop_counter``'s (the matmul-like ops:
    ``mm``, ``bmm``, ``addmm``, attention; elementwise ops count none);
  * bytes are the inputs plus outputs of every op that is not a view,
    unfused: an upper bound beside XLA's count of a fused program;
  * the port does not partition a step, so the per-device terms are the
    whole count divided evenly by the mesh's device count, and there are
    no collectives.  Each record says so (``partition``).

The count runs every layer of the step (a Python loop, not a scan counted
once), so the JAX package's depth probes have no counterpart here.  The
record keeps the JAX package's fields: ``lower_s`` times building the cell,
``compile_s`` the counted run, ``memory`` the step's argument and output
bytes per device.  A cell whose step reads device values to steer its
control flow is recorded as skipped (``cells.META_SKIP``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import all_specs
from ..roofline import analysis as RA
from . import cells as C
from .mesh import make_production_mesh


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _caller() -> str:
    """The innermost frame of this package (``file:line``) on the stack:
    the call that made an op's output."""
    for f in reversed(traceback.extract_stack()[:-2]):
        if _PKG in f.filename and not f.filename.endswith("dryrun.py"):
            return f"{f.filename.split(_PKG)[-1]}:{f.lineno}"
    return "outside repro_torch"


_PKG = f"repro_torch{os.sep}"


class _ByteCount(TorchDispatchMode):
    """Bytes read and written by every op that is not a view, and each
    output that is not on ``meta``: {device: [{op, shape, dtype, bytes,
    at, count}]}, one entry per (op, shape, dtype, caller)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.off_meta: dict = {}

    def _note_off_meta(self, func, t: torch.Tensor) -> None:
        key = (str(func), tuple(t.shape), str(t.dtype), _caller())
        per_dev = self.off_meta.setdefault(str(t.device), {})
        if key not in per_dev:
            per_dev[key] = {"op": key[0], "shape": list(key[1]),
                            "dtype": key[2], "bytes": _nbytes(t),
                            "at": key[3], "count": 0}
        per_dev[key]["count"] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            if t.device.type != "meta":
                self._note_off_meta(func, t)
        if not _is_view(func):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out


def count_step(step_fn, args) -> tuple[RA.Cost, dict]:
    """Run ``step_fn(*args)`` once under the counting modes.  Returns its
    ``Cost`` and the outputs that landed anywhere but ``meta`` ({device:
    [{op, shape, dtype, bytes, at, count}]}; empty when the step allocated
    nothing)."""
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCount()
    arg_bytes = sum(_nbytes(t) for t in _tensors(args))
    with flops, nbytes:
        out = step_fn(*args)
    cost = RA.Cost(flops=float(flops.get_total_flops()),
                   bytes_accessed=float(nbytes.bytes),
                   argument_bytes=arg_bytes,
                   output_bytes=sum(_nbytes(t) for t in _tensors(out)))
    return cost, {d: list(ops.values())
                  for d, ops in nbytes.off_meta.items()}


def off_meta_bytes(off_meta: dict) -> int:
    """The bytes of every output ``count_step`` saw land off ``meta``."""
    return sum(e["bytes"] * e["count"] for ops in off_meta.values()
               for e in ops)


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             builder=None) -> dict:
    """Build one (arch x shape x mesh) cell on ``meta`` tensors, run its
    step once under the counting modes, and return the record."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = math.prod(mesh.devices.shape)
    rec = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16", "ok": False,
           "partition": ("none: per-device terms are the whole count / "
                         f"{n_dev} devices; no collectives")}
    try:
        t0 = time.perf_counter()
        cell = (builder or C.build_cell)(arch, shape, mesh)
        rec["lower_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cost, off_meta = count_step(cell.step_fn, cell.args)
        rec["compile_s"] = time.perf_counter() - t0
        rec["off_meta_ops"] = off_meta
        rec["memory"] = RA.memory_analysis_dict(cost, n_dev)
        rec["roofline"] = RA.analyze(cost, n_dev, cell.model_flops).to_dict()
        rec["note"] = cell.note
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--skip-favor", action="store_true")
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    todo = []
    for arch, spec in all_specs(include_favor=not args.skip_favor).items():
        if args.arch and arch != args.arch:
            continue
        for cell in spec.cells:
            if args.shape and cell.name != args.shape:
                continue
            todo.append((arch, cell.name, C.skip_reason(arch, cell.name)))

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r.get("ok")}

    for arch, shape, skip in todo:
        for multi in meshes:
            mesh_name = "2x16x16" if multi else "16x16"
            if (arch, shape, mesh_name) in done:
                print(f"[skip-done] {arch} x {shape} x {mesh_name}")
                continue
            if skip:
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "ok": True, "skipped": skip}
                print(f"[SKIP] {arch} x {shape}: {skip}")
            else:
                print(f"[run ] {arch} x {shape} x {mesh_name} ...", flush=True)
                rec = run_cell(arch, shape, multi)
                if rec["ok"]:
                    r = rec["roofline"]
                    print(f"   ok build={rec['lower_s']:.1f}s "
                          f"count={rec['compile_s']:.1f}s "
                          f"bottleneck={r['bottleneck']} "
                          f"tc={r['t_compute_s']:.4f} tm={r['t_memory_s']:.4f} "
                          f"tx={r['t_collective_s']:.4f} "
                          f"roofline_frac={r['roofline_frac']:.3f}", flush=True)
                else:
                    print(f"   FAIL {rec['error']}", flush=True)
            results = [r for r in results
                       if (r["arch"], r["shape"], r["mesh"]) !=
                       (arch, shape, mesh_name)]
            results.append(rec)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells ok -> {args.out}")


if __name__ == "__main__":
    main()
