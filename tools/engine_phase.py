#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s engine, frontend, sharded or models phase, or
several, alone on the card.

    python3 tools/engine_phase.py [--phases engine frontend sharded models]

Builds the serve index as the smoke test's serve phase does (16,384 rows
of the synthetic paper dataset, HNSW M=16 on the host, favor-anns' PQ
``QuantSpec`` trained on the card), saves it to a temporary directory in
the checkout and runs ``chip_smoke.phase_engine`` on it: the engine against
``FavorIndex.query``, obs on against off, one profiled step, pipelined
steps and the background merge, each printing its JSON line (with
``FAVOR_TRACE_DIR`` set, the profiled step's trace is kept there as
``engine_step_trace.json.gz``); ``--phases frontend`` runs
``chip_smoke.phase_frontend`` on the same index (the cached, multi-tenant
front-end), ``--phases sharded`` ``chip_smoke.phase_sharded`` (the
sharded backend on a (1, 4) mesh of the card over the same rows);
``--phases models`` ``chip_smoke.phase_models`` (the model zoo at its
published widths; it needs no index, so alone it builds none).  It skips
the kernel, serve, live and widths phases, so a serving change is measured
in a third of the smoke test's time.  Exits non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", nargs="+",
                    choices=("engine", "frontend", "sharded", "models"),
                    default=["engine"])
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as Kn
    from repro_torch.core import BuildSpec, FavorIndex, HnswParams, QuantSpec
    from repro_torch.data import synthetic

    if not torch.cuda.is_available():
        print("engine_phase: no CUDA device available", file=sys.stderr)
        return 2
    cs.emit({"tool": "engine_phase", "nvidia_smi": cs.nvidia_smi_line()})
    Kn.build_kernels()
    index_phases = [p for p in args.phases if p != "models"]
    if not index_phases:
        return run_models(cs, torch)
    vecs, attrs, _ = synthetic.make_paper_dataset(cs.SERVE_N, 128,
                                                  seed=cs.SEED)
    spec = BuildSpec(hnsw=HnswParams(M=16, efc=100, seed=cs.SEED),
                     quant=QuantSpec(kind="pq", m=cs.PQ_M, nbits=cs.PQ_BITS,
                                     rerank=cs.RERANK))
    t0 = time.perf_counter()
    fi = FavorIndex.build(vecs, attrs, spec=spec)
    build_s = time.perf_counter() - t0
    tmp = Path(tempfile.mkdtemp(prefix=".smoke-index-", dir=ROOT))
    try:
        fi.save(str(tmp / "serve"))
        del fi
        phases = {"engine": cs.phase_engine, "frontend": cs.phase_frontend,
                  "sharded": cs.phase_sharded}
        for name in index_phases:
            t0 = time.perf_counter()
            launches = phases[name](torch.device("cuda"), tmp / "serve")
            cs.emit({"tool": "engine_phase", "phase": name,
                     "build_s": build_s,
                     "phase_s": time.perf_counter() - t0,
                     "launches": launches})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return run_models(cs, torch) if "models" in args.phases else 0


def run_models(cs, torch) -> int:
    t0 = time.perf_counter()
    launches = cs.phase_models(torch.device("cuda"))
    cs.emit({"tool": "engine_phase", "phase": "models",
             "phase_s": time.perf_counter() - t0,
             "launches": {"filtered_topk": launches}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
