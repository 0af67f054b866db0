#!/usr/bin/env python3
"""The dry run's partitioned counts against XLA's, at the reduced configs,
on the CPU: per-device FLOPs and link bytes of the three reduced LM
``train_4k`` cells (gemma2-2b, qwen1.5-32b, olmoe-1b-7b) on a 1 x 1 and on
the (2, 4) test mesh, and of gcn-cora ``ogb_products`` on (2, 4), each
beside the JAX package's compile -- the LM cells with their layers
unrolled (the JAX dry run's cost method) and scanned (a layer counted
once, the reference ``tests/test_torch_partition.py`` held before).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/compare_partition_xla.py

The JAX side runs in a subprocess with 8 fake host devices (as the test
runs it); the port's counts run here.  Prints one JSON line per case
({"case", "mesh", "port", "xla_unrolled", "xla_scanned", ratios, the
collectives by kind}); takes ~3 min.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LM = ["gemma2-2b", "qwen1.5-32b", "olmoe-1b-7b"]


def reference(out_path: str) -> None:
    """The JAX side (the subprocess): each case's FLOPs, link bytes and
    collectives, unrolled and scanned."""
    import jax
    from jax.sharding import AxisType

    from repro.configs import get_spec
    from repro.launch import cells as JC
    from repro.launch import dryrun as JD

    meshes = {"2x4": jax.make_mesh((2, 4), ("data", "model"),
                                   axis_types=(AxisType.Auto,) * 2),
              "1x1": jax.make_mesh((1, 1), ("data", "model"),
                                   axis_types=(AxisType.Auto,) * 2,
                                   devices=jax.devices()[:1])}
    out = {}
    for arch, shape in [(a, "train_4k") for a in LM] + [
            ("gcn-cora", "ogb_products")]:
        spec = get_spec(arch)
        for name, mesh in meshes.items():
            if arch == "gcn-cora" and name == "1x1":
                continue
            for unroll in ((False, True) if spec.family == "lm" else
                           (False,)):
                cfg = spec.reduced
                if unroll:
                    cfg = dataclasses.replace(cfg, unroll_layers=True)
                cell = JC.BUILDERS[spec.family](
                    dataclasses.replace(spec, config=cfg), spec.cell(shape),
                    mesh)
                compiled = JD._lower_compile(cell, mesh)[1]
                flops, _, link, counts, _ = JD._cost_of(
                    compiled, mesh.devices.size)
                key = f"{arch}:{shape}:{name}:" + (
                    "unrolled" if unroll or spec.family != "lm" else
                    "scanned")
                out[key] = {"flops": flops, "link": link, "counts": counts}
    Path(out_path).write_text(json.dumps(out))


def port_count(arch: str, shape: str, mesh_name: str) -> dict:
    from repro_torch.configs import get_spec
    from repro_torch.launch import cells as C
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh
    spec = get_spec(arch)
    mesh = make_test_mesh(*(int(n) for n in mesh_name.split("x")))
    cell = C.BUILDERS[spec.family](dataclasses.replace(
        spec, config=spec.reduced), spec.cell(shape), mesh)
    if mesh_name == "1x1":
        c = D.count(cell.step_fn, cell.args)
    else:
        c = D.count(cell.step_fn, cell.args, shardings=cell.in_shardings,
                    mesh=mesh)
    return {"flops": c.cost.flops, "link": c.cost.coll_link_bytes,
            "counts": c.cost.collectives["counts"],
            "flops_by": getattr(c, "flops_by", None),
            "split_by_rule": c.split, "replicated_ops": c.replicated}


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ref.json")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.Popen(
            [sys.executable, __file__, "--reference", out], env=env,
            cwd=ROOT)
        ports = {}
        for arch in LM:
            for mesh_name in ("1x1", "2x4"):
                ports[(arch, "train_4k", mesh_name)] = port_count(
                    arch, "train_4k", mesh_name)
        ports[("gcn-cora", "ogb_products", "2x4")] = port_count(
            "gcn-cora", "ogb_products", "2x4")
        if proc.wait() != 0:
            print("the JAX reference failed", file=sys.stderr)
            return 1
        ref = json.loads(Path(out).read_text())
    for (arch, shape, mesh_name), got in ports.items():
        un = ref[f"{arch}:{shape}:{mesh_name}:unrolled"]
        sc = ref.get(f"{arch}:{shape}:{mesh_name}:scanned")
        rec = {"case": f"{arch}:{shape}", "mesh": mesh_name, "port": got,
               "xla_unrolled": un, "xla_scanned": sc,
               "flops_over_unrolled": got["flops"] / un["flops"],
               "flops_over_scanned": (got["flops"] / sc["flops"]
                                      if sc else None),
               "link_over_unrolled": (got["link"] / un["link"]
                                      if un["link"] else None),
               "link_over_scanned": (got["link"] / sc["link"]
                                     if sc and sc["link"] else None)}
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--reference":
        reference(sys.argv[2])
        sys.exit(0)
    sys.path.insert(0, str(ROOT / "src"))
    sys.exit(main())
