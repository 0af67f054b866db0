#!/usr/bin/env python3
"""Time this checkout's ``filtered_topk`` kernel against another tree's on
one CUDA card, in turns, in one process:

    python3 tools/time_filtered_topk.py --old DIR [--rows N] [--dim D]
        [--batch B] [--rounds R] [--repeats P]

DIR is the root of an older checkout (unpack it with ``git archive`` into a
git-ignored directory); its ``src/repro_torch`` is imported under another
name, so both wrappers run on the same tensors.  The DB is N rows (default
4,000,000) x D (default 128) f32 with the paper schema's attributes, padded
as ``prefbf.pad_db`` pads; B queries (default 1,024), k = 10.  The defaults
are the kernel phase's shape of ``chip_smoke.py``; ``--rows 1000000 --dim
960 --batch 1000`` is the benchmark's ``gist1m-f32.lowsel.b1000`` cell.

Two batches of filters: ``mixed`` cycles over the six paper scenarios and a
< 1 % filter; ``lowsel`` draws the cell's two filters of 0.1-0.5 % per query
from ``portbench/traffic/lowsel.b1000.json``.  Each round times old, new,
new, old on each batch in PreFBF mode, and on ``mixed`` in exclusion mode
(CUDA events, median of ``--repeats`` runs after a warm-up run).  Then the
new kernel alone in PreFBF mode under one filter for the whole batch,
``true`` and the < 1 % filter, and at k = 100 (chained passes of the
kernel's list length).  Both kernels return each distance from the same
per-pair f32 FMA chain, so their outputs must be equal bit for bit; the
script checks that on every batch and mode.  It counts, per scenario, the
pairs each path evaluated and re-scored, and which path each took.

The break-even: one range filter of passing share s for the whole batch,
at shares under the kernel's cut (filter first) and above it, timed in
PreFBF mode (the path the count picks) and in exclusion mode with D = +inf
(the screen, for any share: a failing row is never its candidate).  The
filter-first times give a line t = t0 + s * t1 (least squares): t0 / (B N)
is its cost per evaluated pair, t1 / (B N) its cost per passing pair; the
screen's cost per pair is its time / (B N); the break-even share is where
the line meets the screen's time at the nearest measured share.

Prints each nvcc ``-Xptxas -v`` register / spill line, then one JSON line
with every round's times, the counts, the break-even, and the card's name
and power limit (``nvidia-smi``).
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

# passing shares of the break-even's range filters (f0 is uniform over
# [0, 100])
SHARES = (0.001, 0.005, 0.01, 0.02, 0.05, 0.1, 0.3)


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


def lowsel_filters(b: int, seed: int) -> tuple[list, list]:
    """``b`` filters drawn from the benchmark's lowsel traffic."""
    import numpy as np

    from portbench import program, traffic
    trf = traffic.load(ROOT / "portbench" / "traffic" / "lowsel.b1000.json")
    specs, names = traffic.draw_batch(trf, b, np.random.default_rng(seed))
    return [program.to_filter(s) for s in specs], names


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
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=cs.BATCH)
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

    n, d, b = args.rows, args.dim, args.batch
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
    n_pad = int(pv.shape[0])
    qs = torch.randn((b, d), generator=gen, device=dev)
    dvec = (torch.rand((b,), generator=gen, device=dev) * 2.5 + 0.5)
    batches = {}
    for label, (flts, names) in (("mixed", cs.mixed_filters(F, schema, b)),
                                 ("lowsel", lowsel_filters(b, cs.SEED))):
        batches[label] = (compile_programs(flts, schema, b, device=dev),
                          flts, names)

    def run(mod, progs, exclude, k=cs.K, dv=dvec):
        return mod.filtered_topk(pv, pn, pi, pf, qs, progs, k=k, dvec=dv,
                                 exclude=exclude)

    modes = [("mixed", "prefbf", False), ("mixed", "exclusion", True),
             ("lowsel", "prefbf", False)]
    equal = {}
    for batch, mode, exclude in modes:
        progs = batches[batch][0]
        a, b_ = run(ft_old, progs, exclude), run(ft, progs, exclude)
        equal[f"{batch}/{mode}"] = bool(torch.equal(a[0], b_[0])
                                        and torch.equal(a[1], b_[1]))
    evaluated, rescored, path = {}, {}, {}
    for batch, mode, exclude in modes:
        progs, _, names = batches[batch]
        counts = torch.zeros(b, dtype=torch.int32, device=dev)
        exact = torch.zeros(b, dtype=torch.int32, device=dev)
        routes = torch.zeros(b, dtype=torch.int32, device=dev)
        ft.filtered_topk(pv, pn, pi, pf, qs, progs, k=cs.K, dvec=dvec,
                         exclude=exclude, screen_counts=counts,
                         rescore_counts=exact, routes=routes)
        key = f"{batch}/{mode}"
        for out, t in ((evaluated, counts), (rescored, exact),
                       (path, routes)):
            per = t.cpu().numpy()
            out[key] = {s: float(np.mean([per[i] for i in range(b)
                                          if names[i] == s]))
                        for s in dict.fromkeys(names)}
            out[key]["all"] = float(per.mean())

    rounds = []
    for _ in range(args.rounds):
        row = {}
        for batch, mode, exclude in modes:
            progs = batches[batch][0]
            times = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                mod = ft_old if who == "old" else ft
                times[who].append(cs.cuda_ms(
                    lambda: run(mod, progs, exclude),
                    repeats=args.repeats, warmup=1))
            row[f"{batch}/{mode}"] = times
        rounds.append(row)
    # the new kernel alone under one filter for the whole batch, PreFBF mode
    alone = {}
    mixed_flts, mixed_names = batches["mixed"][1], batches["mixed"][2]
    for label, flt in (("true", F.TrueFilter()), ("tiny_lt1pct", mixed_flts[
            mixed_names.index("tiny_lt1pct")])):
        one = compile_programs([flt] * b, schema, b, device=dev)
        alone[label] = cs.cuda_ms(lambda: run(ft, one, False),
                                  repeats=args.repeats, warmup=1)
    k_long = 100
    alone[f"mixed_k{k_long}"] = cs.cuda_ms(
        lambda: run(ft, batches["mixed"][0], False, k=k_long),
        repeats=args.repeats, warmup=1)

    # the break-even: one range filter of share s for the whole batch
    inf = torch.full((b,), float("inf"), device=dev)
    real = pn < 3.0e38
    curve = []
    for s in SHARES:
        one = compile_programs([F.Range("f0", 0.0, 100.0 * s)] * b, schema,
                               b, device=dev)
        routes = torch.zeros(b, dtype=torch.int32, device=dev)
        run(ft, one, False)
        ft.filtered_topk(pv, pn, pi, pf, qs, one, k=cs.K, routes=routes)
        passing = int((F.eval_program_batched(
            {k_: v[:1] for k_, v in one.items()}, pi, pf) & real).sum())
        curve.append({
            "share": passing / n_pad, "filter_first": int(routes.sum()) / b,
            "prefbf_ms": cs.cuda_ms(lambda: run(ft, one, False),
                                    repeats=args.repeats, warmup=1),
            "screen_ms": cs.cuda_ms(lambda: run(ft, one, True, dv=inf),
                                    repeats=args.repeats, warmup=1)})
    pairs = b * n_pad
    ff = [c for c in curve if c["filter_first"] == 1.0]
    even = {"pairs": pairs, "curve": curve}
    if len(ff) >= 2:
        t1, t0 = np.polyfit([c["share"] for c in ff],
                            [c["prefbf_ms"] for c in ff], 1)
        even.update(
            ff_ns_per_pair=1e6 * t0 / pairs,
            ff_ns_per_passing_pair=1e6 * t1 / pairs,
            screen_ns_per_pair={f"{c['share']:.4g}": 1e6 * c["screen_ms"]
                                / pairs for c in curve})
        # where t0 + s t1 meets the screen's time at the nearest share
        cross = [(abs(c["share"] - (c["screen_ms"] - t0) / t1),
                  (c["screen_ms"] - t0) / t1) for c in curve]
        even["break_even_share"] = float(min(cross)[1])

    summary = {key: {who: statistics.median(
        t for r in rounds for t in r[key][who]) for who in ("old", "new")}
        for key in rounds[0]}
    print(json.dumps({
        "tool": "time_filtered_topk", "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.nvidia_smi_line(), "rows": n, "rows_padded": n_pad,
        "batch": b, "d": d, "k": cs.K, "old_equals_new": equal,
        "rounds": rounds, "median_ms": summary,
        "new_prefbf_one_filter_ms": alone,
        "evaluated_pairs_per_query": evaluated,
        "exact_rescores_per_query": rescored,
        "filter_first_share": path, "break_even": even}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
