#!/usr/bin/env python3
"""Time the ``embedding_bag`` kernel's two instantiations on one CUDA card:
float4 row loads (what the launcher picks when d % 4 == 0) against scalar
loads (what it picks for any other d), at the smoke run's shape.

    python3 tools/time_embedding_bag_vec.py [--rounds R]

Builds ``src/repro_torch/csrc/embedding_bag.cu`` twice into the git-ignored
``src/repro_torch/_build/`` -- as it is, and with the launcher's
``vec4`` choice forced false -- then, on dlrm-rm2's vocabulary and width
(1,000,000 x 64 f32) and 65,536 bags of up to 32 ids with a random -1 tail
(``chip_smoke.py``'s draw), checks that both give the plain version's bits
and times each, sum and mean, by CUDA-graph replay with L2 flushed
(``chip_smoke.graph_ms``), in R interleaved rounds.  Prints one JSON line
with every round's milliseconds and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

VEC4 = "const bool vec4 = (d & 3) == 0;"


def build(name: str, text: str, out_dir: Path):
    from repro_torch import kernels as Kn
    src = out_dir / f"{name}.cu"
    lib = out_dir / f"{name}.so"
    src.write_text(text)
    subprocess.run([Kn.nvcc_path(), *Kn.NVCC_FLAGS, "-I", str(Kn.CSRC),
                    "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).embedding_bag_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_embedding_bag_vec: no CUDA device available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import kernels as Kn
    from repro_torch.kernels.embedding_bag import ops as eb

    text = (Kn.CSRC / "embedding_bag.cu").read_text()
    if VEC4 not in text:
        raise SystemExit(f"launcher line not found: {VEC4}")
    out_dir = Kn.BUILD_DIR / "vec_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    fns = {"float4": build("eb_float4", text, out_dir),
           "scalar": build("eb_scalar", text.replace(
               VEC4, "const bool vec4 = false;"), out_dir)}

    dev = torch.device("cuda")
    v, d, b, length = cs.BAG_V, cs.BAG_D, cs.BAG_B, cs.BAG_L
    rng = np.random.default_rng(cs.SEED + 5)
    table = torch.as_tensor(rng.standard_normal((v, d), dtype=np.float32),
                            device=dev)
    bags = rng.integers(0, v, size=(b, length)).astype(np.int32)
    cut = rng.integers(1, length + 1, size=b)
    bags[np.arange(length)[None, :] >= cut[:, None]] = -1
    bags = torch.as_tensor(bags, device=dev)
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def call(name, mean):
        status = fns[name](bags.data_ptr(), table.data_ptr(), b, length, v,
                           d, mean, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"{name}: cudaError {status}")

    res = {"shape": {"V": v, "d": d, "B": b, "L": length}}
    for mode in ("sum", "mean"):
        mean = int(mode == "mean")
        want = eb.embedding_bag_plain(table, bags, mode=mode)
        rounds = {name: [] for name in fns}
        for name in fns:
            call(name, mean)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"{name} ({mode}) differs from the plain "
                                 "version")
        for _ in range(args.rounds):
            for name in fns:
                rounds[name].append(cs.graph_ms(
                    lambda: call(name, mean), repeats=2 * cs.REPEATS,
                    flush=scratch.zero_))
        res[mode] = {"rounds_ms": rounds,
                     "median_ms": {k: statistics.median(x)
                                   for k, x in rounds.items()}}
    res["nvidia_smi"] = cs.nvidia_smi_line()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
