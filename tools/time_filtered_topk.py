#!/usr/bin/env python3
"""Time this checkout's ``filtered_topk`` kernel against another tree's on
one CUDA card, in turns, in one process:

    python3 tools/time_filtered_topk.py --old DIR [--rows N] [--rounds R]

DIR is the root of an older checkout (unpack it with ``git archive`` into a
git-ignored directory); its ``src/repro_torch`` is imported under another
name, so both wrappers run on the same tensors.  At the kernel phase's shape
of ``chip_smoke.py`` -- N rows (default 4,000,000) x d = 128 f32 with the
paper schema's attributes, padded as ``prefbf.pad_db`` pads, 1024 queries
over the six paper scenarios and a < 1 % filter, k = 10 -- each round times
old, new, new, old in PreFBF mode and in exclusion mode (CUDA events,
median of ``--repeats`` runs after a warm-up run); then the new kernel in
PreFBF mode with one filter for the whole batch, ``true`` and the < 1 %
filter (the fewest and the most screen candidates), and at k = 100
(chained passes of the kernel's list length).  Both kernels return each
distance from the same per-pair f32 FMA chain, so their outputs must be
equal bit for bit; the script checks that.  It also counts, per scenario,
the pairs that passed the new kernel's TF32 screen and the pairs it then
re-scored exactly.

Prints each nvcc ``-Xptxas -v`` register / spill line, then one JSON line
with every round's times, the candidate counts, and the card's name and
power limit (``nvidia-smi``).
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


def load_old(root: Path):
    """The older tree's ``repro_torch`` as the package ``repro_torch_old``
    (its imports are relative, and its kernels build from its own csrc)."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "repro_torch_old", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["repro_torch_old"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("repro_torch_old.kernels"),
            importlib.import_module("repro_torch_old.kernels.filtered_topk.ops"))


def ptxas_lines(logs: dict) -> list[str]:
    return [ln.strip() for v in logs.values() for ln in v.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as Kn
    from repro_torch.core import filters as F
    from repro_torch.core import prefbf
    from repro_torch.core.router import compile_programs
    from repro_torch.kernels.filtered_topk import ops as ft

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--rows", type=int, default=cs.DB_ROWS)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_filtered_topk: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kn_old, ft_old = load_old(args.old.resolve())
    new_logs = Kn.build_kernels(["filtered_topk"])
    old_logs = kn_old.build_kernels(["filtered_topk"])
    for label, logs in (("old", old_logs), ("new", new_logs)):
        for ln in ptxas_lines(logs):
            print(f"ptxas {label}: {ln}", flush=True)

    n, d, b = args.rows, 128, cs.BATCH
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    vecs = torch.randn((n, d), generator=gen, device=dev)
    norms = (vecs * vecs).sum(dim=1)
    schema = F.paper_schema()
    attrs = F.random_attributes(schema, n, seed=cs.SEED + 1)
    padded = prefbf.pad_db(vecs.cpu().numpy(), norms.cpu().numpy(),
                           attrs.ints, attrs.floats, 8192)
    del vecs, norms
    pv, pn, pi, pf = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                      for a in padded)
    del padded
    qs = torch.randn((b, d), generator=gen, device=dev)
    flts, names = cs.mixed_filters(F, schema, b)
    progs = compile_programs(flts, schema, b, device=dev)
    dvec = (torch.rand((b,), generator=gen, device=dev) * 2.5 + 0.5)

    def run(mod, exclude):
        return mod.filtered_topk(pv, pn, pi, pf, qs, progs, k=cs.K,
                                 dvec=dvec, exclude=exclude)

    equal = {}
    for mode, exclude in (("prefbf", False), ("exclusion", True)):
        a, b_ = run(ft_old, exclude), run(ft, exclude)
        equal[mode] = bool(torch.equal(a[0], b_[0])
                           and torch.equal(a[1], b_[1]))
    cands, rescored = {}, {}
    for mode, exclude in (("prefbf", False), ("exclusion", True)):
        counts = torch.zeros(b, dtype=torch.int32, device=dev)
        exact = torch.zeros(b, dtype=torch.int32, device=dev)
        ft.filtered_topk(pv, pn, pi, pf, qs, progs, k=cs.K, dvec=dvec,
                         exclude=exclude, screen_counts=counts,
                         rescore_counts=exact)
        for out, t in ((cands, counts), (rescored, exact)):
            per = t.cpu().numpy()
            out[mode] = {s: float(np.mean([per[i] for i in range(b)
                                           if names[i] == s]))
                         for s in dict.fromkeys(names)}
            out[mode]["all"] = float(per.mean())

    rounds = []
    for _ in range(args.rounds):
        row = {}
        for mode, exclude in (("prefbf", False), ("exclusion", True)):
            times = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                mod = ft_old if who == "old" else ft
                times[who].append(cs.cuda_ms(lambda: run(mod, exclude),
                                             repeats=args.repeats, warmup=1))
            row[mode] = times
        rounds.append(row)
    # the new kernel alone under one filter for the whole batch: `true`
    # (few screen candidates) and the < 1 % filter (the most), PreFBF mode
    alone = {}
    for label, flt in (("true", F.TrueFilter()), ("tiny_lt1pct", flts[
            names.index("tiny_lt1pct")])):
        one = compile_programs([flt] * b, schema, b, device=dev)
        alone[label] = cs.cuda_ms(
            lambda: ft.filtered_topk(pv, pn, pi, pf, qs, one, k=cs.K),
            repeats=args.repeats, warmup=1)
    k_long = 100
    alone[f"mixed_k{k_long}"] = cs.cuda_ms(
        lambda: ft.filtered_topk(pv, pn, pi, pf, qs, progs, k=k_long),
        repeats=args.repeats, warmup=1)
    summary = {mode: {who: statistics.median(
        t for r in rounds for t in r[mode][who]) for who in ("old", "new")}
        for mode in ("prefbf", "exclusion")}
    print(json.dumps({
        "tool": "time_filtered_topk", "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.nvidia_smi_line(), "rows": n, "batch": b, "d": d,
        "k": cs.K, "old_equals_new": equal, "rounds": rounds,
        "median_ms": summary, "new_prefbf_one_filter_ms": alone,
        "screen_candidates_per_query": cands,
        "exact_rescores_per_query": rescored}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
