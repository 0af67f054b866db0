#!/usr/bin/env python3
"""Time this checkout's graph-route gather kernels, ``gather_distance`` and
``pq_adc_gather``, against other trees' on one CUDA card, in turns, in one
process:

    python3 tools/time_gather_kernels.py --old DIR [DIR ...] [--rows N]
        [--rounds R] [--widths 1024x32,878x32,...]

Each DIR is the root of another checkout (unpack it with ``git archive``
into a git-ignored directory such as ``cmp_trees/``); its
``src/repro_torch`` is imported under another name, so every tree's
wrappers run on the same tensors.  At the kernel phase's shape of
``chip_smoke.py`` -- N rows (default 4,000,000) of d = 128 f32 vectors and
favor-anns' PQ codes (M = 32 subspaces of K = 256 centroids) with the paper
schema's attributes, padded as ``prefbf.pad_db`` pads; bf16 LUTs from
``build_luts``; the six paper scenarios and a < 1 % filter over the batch;
random neighbour ids, about 10 % -1 -- and at each width B x M of
``--widths`` (the first B queries, the first M ids of each), every round
times, per other tree, old, new, new, old: each kernel captured in a CUDA
graph and replayed with L2 flushed before each replay (the traversal's rows
come from HBM; "cold"), again with L2 refilled by reading a 64 MB buffer
("clean": the flush above leaves L2 full of dirty lines, which the kernel
then pays to write back), and ``pq_adc_gather`` also with warm LUTs (L2
refilled clean, then the batch's tables read once, untimed: the state the
traversal reads them in, wave after wave).  ``floor_ms`` is a one-element
fill timed the same way: the fixed cost of the method.  ``resident_..._ms``
times the full batch with its ids folded onto the first 32,768 rows and L2
warmed by an untimed call (then a spin of the card, so that the replay is
queued before the card falls idle): the kernels' latency chain and work
without device-memory traffic.  Beside them the eager wrapper call (``call_ms``,
L2 flushed) and the new kernels given the traversal's int64 ids.  Every
tree must return the same bits (the kernels' sums are taken in one fixed
order); the script checks that at every width and, end to end, on an index
of ``--serve-rows`` rows saved by this tree and loaded by every tree (the
serve passes' ids, distance bits, routes, waves and launches), and exits 1
if anything differs.

Prints each gather kernel's nvcc ``-Xptxas -v`` register / spill lines,
then one JSON line with every round's times and the card's name and power
limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

GATHER_SOURCES = ("gather_distance.cu", "pq_adc.cu")
RESIDENT = 32768   # rows whose vectors (16 MB) and codes fit in L2


def load_tree(root: Path, name: str):
    """Another tree's ``repro_torch`` as the package ``name`` (its imports
    are relative, and its kernels build from its own csrc): (kernels,
    gather_distance ops, pq_adc ops)."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.kernels"),
            importlib.import_module(f"{name}.kernels.gather_distance.ops"),
            importlib.import_module(f"{name}.kernels.pq_adc.ops"))


def gather_ptxas(logs: dict) -> list[str]:
    """The ptxas lines of the gather kernels' entries in ``logs``."""
    out, keep = [], False
    for src in GATHER_SOURCES:
        for ln in logs.get(src, "").splitlines():
            if "Compiling entry" in ln:
                keep = "gather" in ln or "gd_kernel" in ln
            if keep and ("registers" in ln or "spill" in ln
                         or "Compiling entry" in ln):
                out.append(ln.strip())
    return out


def serve_equal(roots: dict, rows: int, batch: int) -> dict:
    """The graph route end to end in every tree: one index (favor-anns'
    widths: HNSW M = 16, PQ m = 32 x 8 bits, ``rows`` rows of the synthetic
    paper dataset) built by this tree and saved, then loaded by each tree's
    ``FavorIndex.load``; ``batch`` queries over the six paper scenarios and
    a < 1 % filter under the f32 options and under ``use_pq`` +
    ``graph_quant="pq"``.  Returns per pass whether every tree returned the
    same ids and distance bits, routes, waves and kernel launches."""
    import tempfile

    import numpy as np

    import chip_smoke as cs

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "serve")
        pkg = roots["new"]
        core = importlib.import_module(f"{pkg}.core")
        synth = importlib.import_module(f"{pkg}.data.synthetic")
        vecs, attrs, _ = synth.make_paper_dataset(rows, 128, seed=cs.SEED)
        spec = core.BuildSpec(
            hnsw=core.HnswParams(M=16, efc=100, seed=cs.SEED),
            quant=core.QuantSpec(kind="pq", m=cs.PQ_M, nbits=cs.PQ_BITS,
                                 rerank=cs.RERANK))
        core.FavorIndex.build(vecs, attrs, spec=spec).save(path)
        qs = synth.make_queries(batch, 128, dataset_seed=cs.SEED, seed=100)
        results = {}
        for label, name in roots.items():
            core = importlib.import_module(f"{name}.core")
            filt = importlib.import_module(f"{name}.core.filters")
            kn = importlib.import_module(f"{name}.kernels")
            fi = core.FavorIndex.load(path)
            flts, _ = cs.mixed_filters(filt, fi.schema, batch)
            for pass_, kw in (("f32", {}),
                              ("use_pq+graph_pq",
                               dict(use_pq=True, graph_quant="pq"))):
                opts = core.SearchOptions(k=cs.K, ef=cs.EF, **kw)
                fi.query(qs[:8], flts[:8], opts)
                kn.reset_launch_counts()
                res = fi.query(qs, flts, opts)
                results.setdefault(pass_, {})[label] = (
                    res, {k: v for k, v in kn.launch_counts.items() if v})
    for pass_, by_tree in results.items():
        ref, ref_l = by_tree["new"]
        out[pass_] = {
            "waves": int(ref.waves.max()), "launches": ref_l,
            "graph_queries": int((~ref.routed_brute).sum()),
            "same": {label: bool(
                np.array_equal(res.ids, ref.ids)
                and np.array_equal(res.dists.view(np.uint32),
                                   ref.dists.view(np.uint32))
                and np.array_equal(res.routed_brute, ref.routed_brute)
                and np.array_equal(res.waves, ref.waves) and lc == ref_l)
                for label, (res, lc) in by_tree.items() if label != "new"}}
    return out


def same_bits(a, b) -> bool:
    import torch
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(a, b))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as Kn
    from repro_torch.core import filters as F
    from repro_torch.core import prefbf
    from repro_torch.core.router import compile_programs
    from repro_torch.kernels.gather_distance import ops as gd
    from repro_torch.kernels.pq_adc import ops as pq
    from repro_torch.quant.adc import build_luts

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path, nargs="+")
    ap.add_argument("--rows", type=int, default=cs.DB_ROWS)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--widths", default="1024x32",
                    help="comma-separated BxM widths, B <= 1024, M <= 32")
    ap.add_argument("--serve-rows", type=int, default=4096,
                    help="rows of the end-to-end check's index (0: skip)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_gather_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    trees = {"new": (Kn, gd, pq)}
    roots = {"new": "repro_torch"}
    for i, root in enumerate(args.old):
        trees[f"old{i}:{root.name}"] = load_tree(root.resolve(),
                                                 f"repro_torch_old{i}")
        roots[f"old{i}:{root.name}"] = f"repro_torch_old{i}"
    for label, (kn, _, _) in trees.items():
        logs = kn.build_kernels(["gather_distance", "pq_adc_gather"])
        for ln in gather_ptxas(logs):
            print(f"ptxas {label}: {ln}", flush=True)

    n, d, bmax, m0 = args.rows, 128, cs.BATCH, cs.M0
    pm, ksub = cs.PQ_M, 1 << cs.PQ_BITS
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    schema = F.paper_schema()
    attrs = F.random_attributes(schema, n, seed=cs.SEED + 1)
    padded = prefbf.pad_db(np.zeros((n, 1), np.float32),
                           np.ones(n, np.float32), attrs.ints, attrs.floats,
                           8192)
    pi, pf = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
              for a in padded[2:])
    del padded
    n_pad = pi.shape[0]
    vecs = torch.randn((n_pad, d), generator=gen, device=dev)
    norms = (vecs * vecs).sum(dim=1)
    codes = torch.randint(0, ksub, (n_pad, pm), generator=gen, device=dev,
                          dtype=torch.uint8)
    cents = torch.randn((pm, ksub, d // pm), generator=gen, device=dev)
    qs = torch.randn((bmax, d), generator=gen, device=dev)
    lb = build_luts(cents, qs).to(torch.bfloat16)
    flts, _ = cs.mixed_filters(F, schema, bmax)
    progs = compile_programs(flts, schema, bmax, device=dev)
    dvec = torch.rand((bmax,), generator=gen, device=dev) * 2.5 + 0.5
    ids = torch.randint(0, n, (bmax, m0), generator=gen, device=dev,
                        dtype=torch.int32)
    ids = torch.where(torch.rand((bmax, m0), generator=gen, device=dev) < 0.1,
                      -1, ids)
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    sweep = torch.ones(64 * 2**20, dtype=torch.uint8, device=dev)

    def clean():                  # L2 refilled with clean lines, not dirty
        sweep.sum()
    one = torch.zeros(1, device=dev)
    floor = {state: cs.graph_ms(lambda: one.fill_(1.0), repeats=args.repeats,
                                flush=fl)
             for state, fl in (("cold", flush), ("clean", clean))}

    widths = [tuple(int(x) for x in w.split("x"))
              for w in args.widths.split(",")]
    out = {}
    ok = True
    for b, m in widths:
        q_b = qs[:b].contiguous()
        p_b = {k: v[:b].contiguous() for k, v in progs.items()}
        d_b, l_b = dvec[:b].contiguous(), lb[:b].contiguous()
        i_b = ids[:b, :m].contiguous()
        i64 = i_b.long()

        def gd_call(mod, ii=i_b):
            return mod.gather_distance(vecs, norms, pi, pf, q_b, ii, p_b,
                                       d_b)

        def pq_call(mod, ii=i_b):
            return mod.pq_adc_gather(codes, l_b, ii, ints=pi, floats=pf,
                                     programs=p_b, dvec=d_b)

        def warm():
            clean()
            l_b.sum()

        row = {"valid_ids": int((i_b >= 0).sum())}
        equal = {}
        for kname, call in (("gather_distance", gd_call),
                            ("pq_adc_gather", pq_call)):
            want = call(trees["new"][1 if kname == "gather_distance" else 2])
            equal[f"{kname}_int64_ids"] = same_bits(
                want, call(gd if kname == "gather_distance" else pq, i64))
            states = (("cold", flush), ("clean", clean), ("warm", warm)) \
                if kname == "pq_adc_gather" else (("cold", flush),
                                                  ("clean", clean))
            times = {}
            for label, mods in trees.items():
                mod = mods[1 if kname == "gather_distance" else 2]
                if label != "new":
                    equal[f"{kname}_{label}"] = same_bits(want, call(mod))
            for state, fl in states:
                rounds = []
                for _ in range(args.rounds):
                    rd = {}
                    for label, mods in trees.items():
                        if label == "new":
                            continue
                        mod_old = mods[1 if kname == "gather_distance" else 2]
                        mod_new = trees["new"][
                            1 if kname == "gather_distance" else 2]
                        for who, mod in (("old", mod_old), ("new", mod_new),
                                         ("new", mod_new), ("old", mod_old)):
                            key = label if who == "old" else "new"
                            rd.setdefault(key, []).append(cs.graph_ms(
                                lambda: call(mod), repeats=args.repeats,
                                flush=fl))
                    rounds.append(rd)
                times[state] = {
                    "rounds": rounds,
                    "median_ms": {k: statistics.median(
                        t for rd in rounds for t in rd[k])
                        for k in rounds[0]}}
            mod_new = trees["new"][1 if kname == "gather_distance" else 2]
            times["new_int64_ids_ms"] = cs.graph_ms(
                lambda: call(mod_new, i64), repeats=args.repeats, flush=flush)
            times["call_ms"] = {
                label: cs.cuda_ms(
                    lambda: call(mods[1 if kname == "gather_distance" else 2]),
                    repeats=args.repeats, flush=flush)
                for label, mods in trees.items()}
            row[kname] = times
        row["same_bits"] = equal
        ok = ok and all(equal.values())
        out[f"{b}x{m}"] = row
        print(json.dumps({"width": f"{b}x{m}", **row}), flush=True)
    # the latency chain without DRAM: the full batch's ids folded onto the
    # first RESIDENT rows (16 MB of vectors, L2-resident), L2 warmed by an
    # untimed call before each replay
    rid = torch.where(ids >= 0, ids % RESIDENT, ids).contiguous()
    resident = {}
    for kname, pos in (("gather_distance", 1), ("pq_adc_gather", 2)):
        for label, mods in trees.items():
            mod = mods[pos]
            if kname == "gather_distance":
                def call(mod=mod):
                    return mod.gather_distance(vecs, norms, pi, pf, qs, rid,
                                               progs, dvec)
            else:
                def call(mod=mod):
                    return mod.pq_adc_gather(codes, lb, rid, ints=pi,
                                             floats=pf, programs=progs,
                                             dvec=dvec)
            def warm_call(call=call):   # then spin, so the host keeps ahead
                call()
                torch.cuda._sleep(100_000)
            resident.setdefault(kname, {})[label] = cs.graph_ms(
                call, repeats=args.repeats, flush=warm_call)
    serve = serve_equal(roots, args.serve_rows, bmax) if args.serve_rows \
        else {}
    ok = ok and all(v for r in serve.values() for v in r["same"].values())
    print(json.dumps({
        "tool": "time_gather_kernels", "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.nvidia_smi_line(), "rows": n, "d": d, "M": pm,
        "K": ksub, "lut": "bf16", "trees": list(trees), "ok": ok,
        "floor_ms": floor, f"resident_{bmax}x{m0}_ms": resident,
        "serve_same_as_new": serve,
        "summary": {w: {f"{k}_{s}": r[k][s]["median_ms"]
                        for k in ("gather_distance", "pq_adc_gather")
                        for s in (("cold", "clean", "warm")
                                  if k == "pq_adc_gather"
                                  else ("cold", "clean"))}
                    for w, r in out.items()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
