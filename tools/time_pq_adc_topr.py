#!/usr/bin/env python3
"""Time this checkout's ``pq_adc_topr`` kernel against another tree's on one
CUDA card, in turns, in one process:

    python3 tools/time_pq_adc_topr.py --old DIR [--rows N] [--rounds R]

DIR is the root of an older checkout (unpack it with ``git archive`` into a
git-ignored directory); its ``src/repro_torch`` is imported under another
name, so both wrappers run on the same tensors.  At the kernel phase's shape
of ``chip_smoke.py`` -- N rows (default 4,000,000) of favor-anns' PQ codes
(M = 32 subspaces of K = 256 centroids) with the paper schema's attributes,
padded as ``prefbf.pad_db`` pads, 1024 queries over the six paper scenarios
and a < 1 % filter, f32 LUTs from ``build_luts``, R = 80 -- each round
times old, new, new, old (CUDA events, median of ``--repeats`` runs after a
warm-up run).  Then the new kernel alone with one filter for the whole
batch (``true`` and the < 1 % filter), at R = 1600 (chained passes of
1024 and 576, each pass also alone), and the old kernel once at R = 1600
and once on all-equal codes, where every lane of a warp reads
the same table word (no shared-memory bank conflicts), and the new kernel
on bank-spread codes (random codes whose low three bits make the 8 lanes of
each quarter-warp read 8 different 16-byte bank groups: no conflicts
either).  Last, old, new, new, old at M = 16 subspaces of the same
vectors, where the new kernel runs its generic 16-query instantiation (the
timed shape above has one with M = 32 and K = 256 fixed at compile time).
Both kernels sum each pair in subspace order from 0 with f32 adds, so their
outputs must be equal bit for bit, at R = 80 and at R = 1600 and at M = 16;
the script checks that.  It
also counts, per scenario, the pairs that passed the new kernel's 8-bit
screen and the pairs it then re-scored exactly.

Prints each nvcc ``-Xptxas -v`` register / spill line, then one JSON line
with every round's times, the counts, and the card's name and power limit
(``nvidia-smi``).
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
            importlib.import_module("repro_torch_old.kernels.pq_adc.ops"))


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
    from repro_torch.kernels.pq_adc import ops as pq
    from repro_torch.quant.adc import build_luts

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--rows", type=int, default=cs.DB_ROWS)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_pq_adc_topr: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kn_old, pq_old = load_old(args.old.resolve())
    new_logs = Kn.build_kernels(["pq_adc_topr"])
    old_logs = kn_old.build_kernels(["pq_adc_topr"])
    for label, logs in (("old", old_logs), ("new", new_logs)):
        for ln in ptxas_lines(logs):
            print(f"ptxas {label}: {ln}", flush=True)

    n, d, b = args.rows, 128, cs.BATCH
    m, ksub, r = cs.PQ_M, 1 << cs.PQ_BITS, cs.RERANK * cs.K
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    schema = F.paper_schema()
    attrs = F.random_attributes(schema, n, seed=cs.SEED + 1)
    padded = prefbf.pad_db(np.zeros((n, 1), np.float32),
                           np.ones(n, np.float32), attrs.ints, attrs.floats,
                           8192)
    pn, pi, pf = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                  for a in padded[1:])
    del padded
    n_pad = pn.shape[0]
    codes = torch.randint(0, ksub, (n_pad, m), generator=gen, device=dev,
                          dtype=torch.uint8)
    cents = torch.randn((m, ksub, d // m), generator=gen, device=dev)
    qs = torch.randn((b, d), generator=gen, device=dev)
    luts = build_luts(cents, qs)
    flts, names = cs.mixed_filters(F, schema, b)
    progs = compile_programs(flts, schema, b, device=dev)

    def run(mod, rr=r, c=codes, p=progs):
        return mod.pq_adc_topr(c, pn, pi, pf, luts, p, r=rr)

    def same(a, b_):
        return bool(torch.equal(a[0], b_[0]) and torch.equal(a[1], b_[1]))

    r_long = cs.R_LONG
    equal = {f"r{r}": same(run(pq_old), run(pq)),
             f"r{r_long}": same(run(pq_old, r_long), run(pq, r_long))}
    counts = torch.zeros(b, dtype=torch.int32, device=dev)
    exact = torch.zeros(b, dtype=torch.int32, device=dev)
    pq.pq_adc_topr(codes, pn, pi, pf, luts, progs, r=r,
                   screen_counts=counts, rescore_counts=exact)
    cands, rescored = {}, {}
    for out, t in ((cands, counts), (rescored, exact)):
        per = t.cpu().numpy()
        sel = np.asarray(names)
        out.update({s: float(per[sel == s].mean())
                    for s in dict.fromkeys(names)})
        out["all"] = float(per.mean())
        out["total"] = int(per.sum())

    rounds = []
    for _ in range(args.rounds):
        times = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            mod = pq_old if who == "old" else pq
            times[who].append(cs.cuda_ms(lambda: run(mod),
                                         repeats=args.repeats, warmup=1))
        rounds.append(times)
    alone = {}
    for label, flt in (("true", F.TrueFilter()),
                       ("tiny_lt1pct", flts[names.index("tiny_lt1pct")])):
        one = compile_programs([flt] * b, schema, b, device=dev)
        alone[label] = cs.cuda_ms(lambda: run(pq, p=one),
                                  repeats=args.repeats, warmup=1)
    # R = 1600 chains passes of 1024 and 576: each alone, then the chain
    for rr in (pq._lib().pq_adc_max_r(), r_long - pq._lib().pq_adc_max_r(),
               r_long):
        alone[f"mixed_r{rr}"] = cs.cuda_ms(lambda: run(pq, rr),
                                           repeats=args.repeats, warmup=1)
    old_long = cs.cuda_ms(lambda: run(pq_old, r_long), repeats=args.repeats,
                          warmup=1)
    # bank-spread codes: random, but the low 3 bits of each code are
    # (row + m) % 8, so the 8 lanes of a quarter-warp (8 consecutive rows)
    # read 8 different 16-byte bank groups of the new kernel's table
    rows = torch.arange(n_pad, device=dev)[:, None]
    spread = ((codes & 0xF8) | ((rows + torch.arange(m, device=dev)) & 7)
              ).to(torch.uint8)
    alone["bank_spread_codes"] = cs.cuda_ms(lambda: run(pq, c=spread),
                                            repeats=args.repeats, warmup=1)
    del spread
    flat = torch.zeros_like(codes)
    old_flat = cs.cuda_ms(lambda: run(pq_old, c=flat), repeats=args.repeats,
                          warmup=1)
    # the generic 16-query instantiation: M = 16 subspaces of the same space
    m16 = 16
    codes16 = codes[:, :m16].contiguous()
    luts16 = build_luts(torch.randn((m16, ksub, d // m16), generator=gen,
                                    device=dev), qs)

    def run16(mod):
        return mod.pq_adc_topr(codes16, pn, pi, pf, luts16, progs, r=r)

    equal[f"m{m16}_r{r}"] = same(run16(pq_old), run16(pq))
    generic = {"query_tile_screened": pq._query_tile(
        pq._lib(), b, m16, ksub, r, (int(progs["valid"].shape[1]),
                                     pi.shape[1], pf.shape[1])),
        "old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        generic[who].append(cs.cuda_ms(
            lambda: run16(pq_old if who == "old" else pq),
            repeats=args.repeats, warmup=1))
    del codes16, luts16
    summary = {who: statistics.median(t for rd in rounds for t in rd[who])
               for who in ("old", "new")}
    print(json.dumps({
        "tool": "time_pq_adc_topr", "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.nvidia_smi_line(), "rows": n, "batch": b, "M": m,
        "K": ksub, "R": r, "lut": "f32", "old_equals_new": equal,
        "rounds": rounds, "median_ms": summary, "new_alone_ms": alone,
        f"old_r{r_long}_ms": old_long, "old_all_equal_codes_ms": old_flat,
        f"m{m16}_generic_ms": generic,
        "screen_candidates_per_query": cands,
        "exact_rescores_per_query": rescored}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
