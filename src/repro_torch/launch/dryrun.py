"""The multi-pod dry run on the H100's constants, over ``meta`` tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out dryrun_results.json] [--skip-favor]
        [--device cuda|cpu] [--seed 0]

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
    unfused: an upper bound beside XLA's count of a fused program (an
    indexing op is charged its whole source tensor, as XLA's cost model
    charges a gather its whole operand);
  * a kernel wrapper's call is charged its analytic work instead of its
    own torch ops (``kernels.counted``: each input read once, each output
    written once, the kernel table's FLOPs), on every device; each
    record lists those charges (``count.kernels``);
  * the port does not partition a step, so the per-device terms are the
    whole count divided evenly by the mesh's device count, and there are
    no collectives.  Each record says so (``partition``).

One cell is counted on real tensors: favor-anns' ``serve_graph``, whose
Python loops read device values.  Its record counts one mesh cell's block
-- the per-device program, on synthetic data from ``--seed`` -- on
``--device`` (the card unless ``cpu`` is given; without a card the record
is ``ok: false`` with the device error), and its per-device terms are that
count.  It also states the block's rows and queries, the waves run, the
peak memory on the card, and the bytes of each part of the step
(``count.parts``) and of its heaviest ops (``count.top_ops``).

The count runs every layer of the step (a Python loop, not a scan counted
once), so the JAX package's depth probes have no counterpart here.  The
record keeps the JAX package's fields: ``lower_s`` times building the cell
(and making a block's data), ``compile_s`` the counted run, ``memory`` the
step's argument and output bytes per device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .. import kernels
from ..configs import all_specs
from ..device import resolve_device
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

# the parts of the favor-anns graph step a count gives bytes to: the
# innermost function of this package on the stack that names one
_PARTS = {"estimate": "estimate", "_descend": "descent",
          "_seen_bits": "visited", "_visit_bits": "visited",
          "_merge_pool": "pools", "stage_loop": "wave",
          "_graph_traverse": "traversal", "_merge_topk": "shard merge"}


def _part() -> str:
    f = sys._getframe(2)
    while f is not None:
        part = _PARTS.get(f.f_code.co_name)
        if part is not None and _PKG in f.f_code.co_filename:
            return part
        f = f.f_back
    return "other"


class _ByteCount(TorchDispatchMode):
    """Bytes read and written by every op that is not a view, and the
    kernel wrappers' analytic charges (``charge``: {name: {calls, flops,
    bytes}}).  With ``note_off_meta``, each output that is not on ``meta``:
    {device: [{op, shape, dtype, bytes, at, count}]}, one entry per (op,
    shape, dtype, caller); with ``parts``, the bytes of each part
    (``_PARTS``) and of each (part, op)."""

    def __init__(self, *, note_off_meta: bool = True, parts: bool = False):
        super().__init__()
        self.bytes = 0
        self.off_meta: dict = {}
        self.note_off_meta = note_off_meta
        self.parts = {} if parts else None
        self.ops: dict = {}
        self.kernels: dict = {}

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.bytes += nbytes

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
        if self.note_off_meta:
            for t in outs:
                if t.device.type != "meta":
                    self._note_off_meta(func, t)
        if not _is_view(func):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            nb = sum(_nbytes(t) for t in ins + outs)
            self.bytes += nb
            if self.parts is not None:
                part = _part()
                self.parts[part] = self.parts.get(part, 0) + nb
                key = f"{part}: {func}"
                self.ops[key] = self.ops.get(key, 0) + nb
        return out


@dataclass
class Count:
    """One counted run: its ``Cost`` (the kernels' analytic FLOPs and bytes
    included), the outputs off ``meta`` (a meta run's), the kernels'
    charges, the bytes by part and by (part, op) (when asked), and the
    step's output."""
    cost: RA.Cost
    off_meta: dict
    kernels: dict
    parts: dict | None
    ops: dict | None
    out: object


def count(step_fn, args, *, meta: bool = True, parts: bool = False) -> Count:
    """Run ``step_fn(*args)`` once under the counting modes; ``meta=False``
    for real tensors (no record of outputs off ``meta``), ``parts`` to
    split the bytes by part of the step."""
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCount(note_off_meta=meta, parts=parts)
    arg_bytes = sum(_nbytes(t) for t in _tensors(args))
    with flops, nbytes, kernels.count_kernels(nbytes.charge):
        out = step_fn(*args)
    kernel_flops = sum(k["flops"] for k in nbytes.kernels.values())
    cost = RA.Cost(flops=float(flops.get_total_flops()) + kernel_flops,
                   bytes_accessed=float(nbytes.bytes),
                   argument_bytes=arg_bytes,
                   output_bytes=sum(_nbytes(t) for t in _tensors(out)))
    return Count(cost, {d: list(ops.values())
                        for d, ops in nbytes.off_meta.items()},
                 nbytes.kernels, nbytes.parts,
                 nbytes.ops if parts else None, out)


def count_step(step_fn, args) -> tuple[RA.Cost, dict]:
    """Run ``step_fn(*args)`` once under the counting modes.  Returns its
    ``Cost`` and the outputs that landed anywhere but ``meta`` ({device:
    [{op, shape, dtype, bytes, at, count}]}; empty when the step allocated
    nothing)."""
    c = count(step_fn, args)
    return c.cost, c.off_meta


BLOCK_NOTE = ("one mesh cell on synthetic data: a random graph's wave "
              "count is not a production one")


def count_block(cell, device=None, seed: int = 0, data_device=None):
    """Make ``cell``'s block (``cells.Block``) on ``device`` (the card
    unless given; raises without one) from ``seed`` and count its step on
    those real tensors.  Returns (the record's fields, the ``Count``, the
    ``Block``)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    block = cell.block(dev, seed, data_device)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = count(block.step_fn, block.args, meta=False, parts=True)
    if cuda:
        torch.cuda.synchronize(dev)
    count_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    top = sorted(c.ops.items(), key=lambda kv: -kv[1])[:8]
    fields = {"lower_s": made_s, "compile_s": count_s,
              "block": {**block.info, **block.facts(), "device": str(dev),
                        "seed": seed, "peak_memory_bytes": peak},
              "count": {"kernels": c.kernels, "parts": c.parts,
                        "top_ops": dict(top)}}
    return fields, c, block


def off_meta_bytes(off_meta: dict) -> int:
    """The bytes of every output ``count_step`` saw land off ``meta``."""
    return sum(e["bytes"] * e["count"] for ops in off_meta.values()
               for e in ops)


def run_cell(arch: str, shape: str, multi_pod: bool, *, builder=None,
             device=None, seed: int = 0, keep: dict | None = None) -> dict:
    """Build one (arch x shape x mesh) cell on ``meta`` tensors, run its
    step once under the counting modes, and return the record.  A cell
    with a ``block`` is counted on real tensors instead: one mesh cell's
    block on ``device`` from ``seed`` (``count_block``).  ``keep``, a
    dict, receives the ``Count`` (and a block cell's ``Block``)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = math.prod(mesh.devices.shape)
    rec = {"arch": arch, "shape": shape,
           "mesh": "x".join(str(s) for s in mesh.devices.shape), "ok": False,
           "partition": ("none: per-device terms are the whole count / "
                         f"{n_dev} devices; no collectives")}
    try:
        t0 = time.perf_counter()
        cell = (builder or C.build_cell)(arch, shape, mesh)
        rec["lower_s"] = time.perf_counter() - t0
        if cell.block is not None:
            rec["partition"] = (
                "one mesh cell counted on real tensors: the per-device "
                f"program of one of the {n_dev} blocks; per-device terms "
                "are that count, not divided; no collectives")
            fields, c, block = count_block(cell, device, seed)
            if keep is not None:
                keep["block"] = block
            fields["lower_s"] += rec["lower_s"]
            rec.update(fields)
            n_per, mf = 1, fields["block"]["model_flops"]
            rec["note"] = f"{cell.note}; {BLOCK_NOTE}"
        else:
            t0 = time.perf_counter()
            c = count(cell.step_fn, cell.args)
            rec["compile_s"] = time.perf_counter() - t0
            rec["off_meta_ops"] = c.off_meta
            rec["count"] = {"kernels": c.kernels}
            n_per, mf = n_dev, cell.model_flops
            rec["note"] = cell.note
        if keep is not None:
            keep["count"] = c
        rec["memory"] = RA.memory_analysis_dict(c.cost, n_per)
        rec["roofline"] = RA.analyze(c.cost, n_per, mf).to_dict()
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
    ap.add_argument("--device", default=None,
                    help="where a cell counted on real tensors runs "
                         "(default: the card)")
    ap.add_argument("--seed", type=int, default=0)
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
                rec = run_cell(arch, shape, multi, device=args.device,
                               seed=args.seed)
                if rec["ok"]:
                    r = rec["roofline"]
                    waves = (f" waves={rec['block']['waves']}"
                             if "block" in rec else "")
                    print(f"   ok build={rec['lower_s']:.1f}s "
                          f"count={rec['compile_s']:.1f}s "
                          f"bottleneck={r['bottleneck']} "
                          f"tc={r['t_compute_s']:.4f} tm={r['t_memory_s']:.4f} "
                          f"tx={r['t_collective_s']:.4f} "
                          f"roofline_frac={r['roofline_frac']:.3f}{waves}",
                          flush=True)
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
