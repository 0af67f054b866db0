"""Hand-written CUDA kernels for FAVOR's hot spots, one package each:

  filtered_topk   -- fused L2 distance + filter program + PreFBF mask or
                     exclusion distance + running top-k (the brute route)
  gather_distance -- neighbour-row gather + L2 distance + filter program +
                     exclusion distance (the graph route's expansion)
  pq_adc          -- pq_adc_topr: fused ADC LUT scan + filter program +
                     running top-R (the compressed brute route, ``use_pq``);
                     pq_adc_gather: neighbour code-row ADC sums + filter
                     program + exclusion distance (the compressed graph
                     route, ``graph_quant="pq"``)
  embedding_bag   -- per bag, the sum or mean of the table rows its ids
                     name (the JAX package's public ``embedding_bag`` op)

Each package's ``ops`` module holds the wrappers (the JAX package's ``ops``
contract: -1 / +inf for missing results and the ``valid`` lane mask) and the
plain PyTorch version of each function.  A wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernel or raises.

The kernels are CUDA C++ for ``sm_90a`` in ``repro_torch/csrc``, compiled by
``nvcc`` into one shared library per source with a plain C interface, loaded
with ``ctypes``.  ``SOURCES`` maps each kernel to its source.
``build_kernels()`` compiles every source in parallel into
``repro_torch/_build/`` (keyed by a hash of the source and the headers, so
an edited source is rebuilt); a wrapper's first launch builds what is
missing.

``launch_counts`` counts the kernel launches each wrapper made, so a run can
show that its main path went through the kernels; ``launch_widths`` counts
the graph route's gather launches by their (B, M) width, and
``launch_threads`` the launches by the name of the thread that made them
(the background merge's worker is ``favor-merge``), so a run can tell a
step's launches from a concurrent merge's.  All three are updated under a
lock of their own: serving threads and a background merge launch kernels
at the same time.

While a dry-run count is active on a thread (``count_kernels``, entered by
``launch.dryrun.count``), each wrapper (``counted``) charges the count
its call's analytic work -- each input read once, each output written
once, FLOPs as the kernel table's bounds count them -- and runs with the
count's dispatch modes off, so its own torch ops (the plain version's, or
a launch's allocations) are not counted: one cell gives one count on the
CPU and on the card.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
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
           "gather_distance": "gather_distance.cu",
           "pq_adc_topr": "pq_adc.cu",
           "pq_adc_gather": "pq_adc.cu",
           "embedding_bag": "embedding_bag.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

launch_counts = {name: 0 for name in SOURCES}
launch_widths: dict[str, dict[tuple[int, int], int]] = {
    name: {} for name in SOURCES}
launch_threads: dict[str, dict[str, int]] = {}
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0
            launch_widths[name].clear()
        launch_threads.clear()


def count_launch(name: str, width: tuple[int, int] | None = None) -> None:
    """One launch of kernel ``name``, counted for the calling thread too;
    ``width`` (B, M), where given, is counted in ``launch_widths``."""
    thread = threading.current_thread().name
    with _count_lock:
        launch_counts[name] += 1
        per = launch_threads.setdefault(thread, {})
        per[name] = per.get(name, 0) + 1
        if width is not None:
            widths = launch_widths[name]
            widths[width] = widths.get(width, 0) + 1


_counting = threading.local()


@contextlib.contextmanager
def count_kernels(charge):
    """While active on this thread, every ``counted`` wrapper call charges
    ``charge(name, flops, nbytes, (args, kwargs), out)`` its analytic work
    instead of its own torch ops (the count marks the inputs read and
    holds the outputs as live)."""
    prev = getattr(_counting, "charge", None)
    _counting.charge = charge
    try:
        yield
    finally:
        _counting.charge = prev


def counted(name: str, work):
    """Decorator of kernel ``name``'s wrapper: under ``count_kernels`` a
    call charges ``work(*args, **kwargs)`` -> (FLOPs, bytes) and runs with
    the current dispatch modes off (a nested wrapper charges nothing)."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            charge = getattr(_counting, "charge", None)
            if charge is None:
                return fn(*args, **kwargs)
            from torch.utils._python_dispatch import _disable_current_modes
            from torch.utils._pytree import tree_flatten
            if any(type(t).__name__ == "DTensor"
                   for t in tree_flatten((args, kwargs))[0]):
                raise NotImplementedError(
                    f"{name}: a kernel wrapper takes one device's tensors, "
                    "not DTensors: call it inside a per-device program")
            _counting.charge = None
            try:
                with _disable_current_modes():
                    flops, nbytes = work(*args, **kwargs)
                    out = fn(*args, **kwargs)
            finally:
                _counting.charge = charge
            charge(name, float(flops), float(nbytes), (args, kwargs), out)
            return out
        return inner
    return deco


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


def _lib_path(src: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(src).stem}-{digest}.so"


def _start_build(src: str):
    out = _lib_path(src)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(src: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_kernels(names=None) -> dict[str, str]:
    """Compile (one ``nvcc`` per source, all started together) and load the
    libraries of the kernels ``names`` (default: all); returns each source's
    ``nvcc -Xptxas -v`` log ("" when its library was already built)."""
    names = tuple(SOURCES) if names is None else tuple(names)
    srcs = dict.fromkeys(SOURCES[n] for n in names)
    with _lock:
        jobs = {s: _start_build(s) for s in srcs if s not in _libs}
        logs = {}
        try:
            for s, job in jobs.items():
                logs[s] = _finish_build(s, job)
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
        for s in jobs:
            _libs[s] = ctypes.CDLL(str(_lib_path(s)))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _libs.get(SOURCES[name])
    if lib is None:
        build_kernels((name,))
        lib = _libs[SOURCES[name]]
    return lib


def check_status(name: str, status: int) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")
