"""Hand-written CUDA kernels for FAVOR's hot spots, one package each:

  filtered_topk   -- fused L2 distance + filter program + PreFBF mask or
                     exclusion distance + running top-k (the brute route)
  gather_distance -- neighbour-row gather + L2 distance + filter program +
                     exclusion distance (the graph route's expansion)

Each package's ``ops`` module holds the wrapper (the JAX package's ``ops``
contract: -1 / +inf for missing results and the ``valid`` lane mask) and the
plain PyTorch version of the same function.  A wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernel or raises.

The kernels are CUDA C++ for ``sm_90a`` in ``repro_torch/csrc``, compiled by
``nvcc`` into one shared library per source with a plain C interface, loaded
with ``ctypes``.  ``build_kernels()`` compiles every source in parallel into
``repro_torch/_build/`` (keyed by a hash of the source, so an edited source
is rebuilt); a wrapper's first launch builds what is missing.

``launch_counts`` counts the kernel launches each wrapper made, so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {"filtered_topk": "filtered_topk.cu",
           "gather_distance": "gather_distance.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

launch_counts = {name: 0 for name in SOURCES}
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_kernels(names=None) -> dict[str, str]:
    """Compile (one ``nvcc`` per source, all started together) and load every
    kernel library; returns each build's ``nvcc -Xptxas -v`` log ("" when the
    library was already built)."""
    names = tuple(SOURCES) if names is None else tuple(names)
    with _lock:
        jobs = {n: _start_build(n) for n in names if n not in _libs}
        logs = {}
        try:
            for n, job in jobs.items():
                logs[n] = _finish_build(n, job)
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
        for n in jobs:
            _libs[n] = ctypes.CDLL(str(_lib_path(n)))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build_kernels((name,))
        lib = _libs[name]
    return lib


def check_status(name: str, status: int) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")
