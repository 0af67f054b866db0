"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see ``portbench/harness.py``.  The kernel
build and the caches of torch, Triton and CUDA stay in fixed directories
inside the checkout.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _main() -> int:
    try:
        from portbench import harness
        import repro_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"cannot import the benchmark or the port: {e}", file=sys.stderr)
        return 2
    return harness.main(sys.argv[1:], T_START, ROOT)


if __name__ == "__main__":
    sys.exit(_main())
