#!/usr/bin/env python3
"""Run one live mutation script through both packages on the CPU and print
the graph route's waves and hops before and after ``merge()``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/compare_merge_waves.py \
        [--n 4096] [--d 32] [--queries 256]

The JAX package builds the HNSW graph; the port serves the same graph
(``repro_torch.convert``).  The script scales ``chip_smoke.py``'s live
phase to ``--n`` rows: n/8 upserts (an eighth of them replacing base ids),
then n/16 deletes (a quarter of them upserted rows).  Every query is forced
onto the graph route with the paper's six scenario filters.  Prints one
JSON line: per stage (static, before merge, after merge) the maximum waves
and mean hops of each package and whether their ids agree row for row.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from repro.core import FavorIndex as RIndex
    from repro.core import HnswParams as RParams
    from repro.core import SearchOptions as ROpts
    from repro.core import filters as RF
    from repro.core import router as r_router
    from repro.data import synthetic
    from repro_torch.convert import from_reference_arrays
    from repro_torch.core import SearchOptions, router
    from repro_torch.core import filters as PF

    n, d, b = args.n, args.d, args.queries
    vecs, attrs, schema = synthetic.make_paper_dataset(n, d, seed=args.seed)
    t0 = time.perf_counter()
    ref = RIndex.build(vecs, attrs, RParams(M=16, efc=100, seed=args.seed))
    build_s = time.perf_counter() - t0
    idx = ref.index
    port = from_reference_arrays(
        vectors=idx.vectors, levels=idx.levels, node_level=idx.node_level,
        entry_point=idx.entry_point, delta_d=idx.delta_d, params=idx.params,
        ints=ref.attrs.ints, floats=ref.attrs.floats, schema=ref.schema,
        norms=idx.norms, device="cpu")
    qs = synthetic.make_queries(b, d, dataset_seed=args.seed, seed=100)
    r_scen = list(RF.paper_filters(schema).values())
    p_scen = list(PF.paper_filters(PF.paper_schema()).values())
    r_flt = [r_scen[i % len(r_scen)] for i in range(b)]
    p_flt = [p_scen[i % len(p_scen)] for i in range(b)]
    stages = {}

    def run(stage):
        r = r_router.execute(ref.backend, qs, r_flt,
                             ROpts(k=10, ef=128, force="graph"))
        p = router.execute(port.backend, qs, p_flt,
                           SearchOptions(k=10, ef=128, force="graph"))
        stages[stage] = {
            "waves_jax": int(r.waves.max()), "waves_port": int(p.waves.max()),
            "hops_jax": float(r.hops.mean()), "hops_port": float(p.hops.mean()),
            "ids_identical_rows": float((r.ids == p.ids).all(axis=1).mean())}

    run("static")
    rng = np.random.default_rng(args.seed + 9)
    ups, rep, dels = n // 8, n // 64, n // 16
    new_v = synthetic.make_queries(ups, d, dataset_seed=args.seed, seed=300)
    new_a = RF.random_attributes(schema, ups, seed=args.seed + 11)
    perm = rng.permutation(n)
    for fi in (ref, port):
        ids = np.concatenate([
            fi.upsert(new_v[:ups - rep], new_a.ints[:ups - rep],
                      new_a.floats[:ups - rep]),
            fi.upsert(new_v[ups - rep:], new_a.ints[ups - rep:],
                      new_a.floats[ups - rep:], replace=perm[:rep])])
        fi.delete(np.concatenate([perm[rep:rep + dels - dels // 4],
                                  ids[:dels // 4]]))
    run("before_merge")
    ref.merge()
    port.merge()
    run("after_merge")
    print(json.dumps({"n": n, "d": d, "queries": b, "upserts": ups,
                      "replaced": rep, "deletes": dels, "build_s": build_s,
                      "stages": stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
