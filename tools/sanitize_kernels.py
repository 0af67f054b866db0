#!/usr/bin/env python3
"""The five CUDA kernels under ``compute-sanitizer`` and under three checks
that need no sanitizer, at small shapes, on one card:

    PYTHONPATH=src python3 tools/sanitize_kernels.py \
        [--tools memcheck,racecheck,synccheck,initcheck] [--repeats 20] \
        [--out F.json]

Cases: ``filtered_topk`` in PreFBF and exclusion mode, at k = 100 (three
chained passes of its list length) and at the sharded backend's d = 16;
``pq_adc_topr`` (f32 and bf16 tables, R = 1600 chained); ``pq_adc_gather``
(bf16 M = 32 x K = 256 and a generic table, with filter programs);
``gather_distance``; ``embedding_bag`` (sum and mean); and the sharded
brute scans (a (1, 4) mesh of the card, f32 and PQ, against the same
backend on a CPU mesh).  Every case launches its kernel and holds the result
to its plain version at the bar the card tests hold.

For each tool, ``compute-sanitizer --tool T --error-exitcode 86`` runs this
script with ``--launch`` (each case once) and its error summary is read; a
device the sanitizer refuses is reported as ``unsupported``, never as clean.
Then, in this process, for each case:

  * guard: every input copied into the middle of a buffer whose margins
    hold a poison value (NaN, 2**30, 255, True); the kernel's outputs must
    be the bits it gives on the plain inputs (a read past an input that
    reaches a result shows);
  * poison: the allocator's cached blocks filled with 0xFF bytes, then with
    zeros, before a launch; the outputs must be the same bits (a read of
    memory the kernel or its wrapper never wrote shows);
  * repeat: ``--repeats`` launches, each the first one's bits (a race
    whose outcome varies shows).

Prints one JSON line: the card's name and power limit (``nvidia-smi``), the
sanitizer's version, per tool its status and error count, per case the
plain-version comparison and each check's result.  Exits 0 only when no
tool found an error, no tool failed to run for another reason than an
unsupported device, and every comparison and check held.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core import prefbf  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb  # noqa: E402
from repro_torch.kernels.filtered_topk import ops as ft  # noqa: E402
from repro_torch.kernels.gather_distance import ops as gd  # noqa: E402
from repro_torch.kernels.pq_adc import ops as pq  # noqa: E402
from repro_torch.parity import topk_mismatch  # noqa: E402

TOL = 1e-5
TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
TOOL_FLAGS = {"memcheck": ["--leak-check", "no"],
              "racecheck": ["--racecheck-report", "all"],
              "synccheck": [],
              "initcheck": []}
GUARD = 4096            # poison elements on each side of a guarded input


# -- inputs ------------------------------------------------------------------
def _db(n, d, b, seed, pad_to=None):
    rng = np.random.default_rng(seed)
    schema = PF.paper_schema()
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    attrs = PF.random_attributes(schema, n, seed=seed + 1)
    db = (vecs, norms, attrs.ints, attrs.floats)
    if pad_to:
        db = prefbf.pad_db(*db, pad_to)
    pool = [PF.Equality("b0", True), PF.Range("f0", 10.0, 60.0),
            PF.Not(PF.Range("f0", 30.0, 80.0)), PF.TrueFilter(),
            PF.And(PF.Equality("i0", 3), PF.Range("f0", 10, 12)),
            PF.Inclusion("i0", [1, 5, 9])]
    progs = compile_programs([pool[i % len(pool)] for i in range(b)], schema,
                             b, device="cpu")
    qs = rng.normal(size=(b, d)).astype(np.float32)
    return ([torch.as_tensor(np.ascontiguousarray(a)) for a in db],
            torch.as_tensor(qs), progs, rng)


def _ft_case(n, d, b, k, exclude, pad_to=None):
    db, qs, progs, rng = _db(n, d, b, seed=n + d, pad_to=pad_to)
    dvec = torch.as_tensor(rng.uniform(0.1, 2.0, size=b).astype(np.float32))
    valid = torch.ones(b, dtype=torch.bool)
    valid[0] = False
    inputs = {"db": db, "qs": qs, "progs": progs, "dvec": dvec,
              "valid": valid}

    def run(x, plain=False):
        fn = ft.filtered_topk_plain if plain else ft.filtered_topk
        return fn(*x["db"], x["qs"], x["progs"], k=k, dvec=x["dvec"],
                  exclude=exclude, valid=x["valid"])

    return "filtered_topk", inputs, run, _topk_close


def _pq_topr_case(n, b, m, nbits, r, lut_dtype, n_pad=0):
    db, _, progs, rng = _db(n, 8, b, seed=n + m)
    _, norms, ints, floats = db
    if n_pad:
        norms[-n_pad:] = float("inf")
        ints[-n_pad:] = -1
        floats[-n_pad:] = float("nan")
    ksub = 1 << nbits
    codes = torch.as_tensor(rng.integers(0, ksub, size=(n, m)),
                            dtype=torch.uint8)
    luts = torch.as_tensor(rng.uniform(0, 4.0, size=(b, m, ksub)),
                           dtype=torch.float32).to(lut_dtype)
    valid = torch.ones(b, dtype=torch.bool)
    valid[-1] = False
    inputs = {"codes": codes, "norms": norms, "ints": ints,
              "floats": floats, "luts": luts, "progs": progs,
              "valid": valid}

    def run(x, plain=False):
        fn = pq.pq_adc_topr_plain if plain else pq.pq_adc_topr
        return fn(x["codes"], x["norms"], x["ints"], x["floats"], x["luts"],
                  x["progs"], r=r, valid=x["valid"])

    return "pq_adc_topr", inputs, run, _equal


def _pq_gather_case(n, b, m0, m, nbits, lut_dtype):
    db, _, progs, rng = _db(n, 8, b, seed=n + m0)
    _, _, ints, floats = db
    ksub = 1 << nbits
    codes = torch.as_tensor(rng.integers(0, ksub, size=(n, m)),
                            dtype=torch.uint8)
    luts = torch.as_tensor(rng.uniform(0, 4.0, size=(b, m, ksub)),
                           dtype=torch.float32).to(lut_dtype)
    ids = torch.as_tensor(rng.integers(-1, n, size=(b, m0)),
                          dtype=torch.int32)
    dvec = torch.full((b,), 0.4)
    inputs = {"codes": codes, "luts": luts, "ids": ids, "ints": ints,
              "floats": floats, "progs": progs, "dvec": dvec}

    def run(x, plain=False):
        fn = pq.pq_adc_gather_plain if plain else pq.pq_adc_gather
        return fn(x["codes"], x["luts"], x["ids"], ints=x["ints"],
                  floats=x["floats"], programs=x["progs"], dvec=x["dvec"])

    return "pq_adc_gather", inputs, run, _equal


def _gather_case(n, d, b, m):
    db, qs, progs, rng = _db(n, d, b, seed=n + m)
    ids = torch.as_tensor(rng.integers(-1, n, size=(b, m)),
                          dtype=torch.int32)
    inputs = {"db": db, "qs": qs, "ids": ids, "progs": progs,
              "dvec": torch.full((b,), 0.4)}

    def run(x, plain=False):
        fn = gd.gather_distance_plain if plain else gd.gather_distance
        return fn(*x["db"], x["qs"], x["ids"], x["progs"], x["dvec"])

    return "gather_distance", inputs, run, _gather_close


def _bag_case(v, d, b, ln, mode):
    rng = np.random.default_rng(v + ln)
    table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32))
    bags = rng.integers(0, v, size=(b, ln)).astype(np.int32)
    for i in range(b):
        bags[i, rng.integers(0, ln + 1):] = -1
    inputs = {"table": table, "bags": torch.as_tensor(bags)}

    def run(x, plain=False):
        fn = eb.embedding_bag_plain if plain else eb.embedding_bag
        return fn(x["table"], x["bags"], mode=mode)

    return "embedding_bag", inputs, run, _equal


def _sharded_case(use_pq):
    """The card test's sharded backend: (1, 4) mesh of 2,048 x 16 rows, 48
    queries over three filters, k = 10, brute route; the plain version is
    the same backend on a CPU mesh."""
    from repro_torch.core import (BuildSpec, HnswParams, QuantSpec,
                                  SearchOptions, ShardedBackend, router)
    from repro_torch.core.distributed import make_mesh
    rng = np.random.default_rng(31)
    n, d = 2048, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    attrs = PF.random_attributes(PF.paper_schema(), n, seed=32)
    spec = BuildSpec(hnsw=HnswParams(M=8, efc=48, seed=3),
                     quant=QuantSpec(kind="pq", m=4, nbits=8,
                                     train_iters=5))
    be = ShardedBackend.build(vecs, attrs, make_mesh((1, 4), device="cpu"),
                              spec)
    pool = [PF.Equality("b0", True), PF.Range("f0", 10.0, 60.0),
            PF.And(PF.Equality("i0", 3), PF.Range("f0", 10, 12))]
    qs = rng.normal(size=(48, d)).astype(np.float32)
    flts = [pool[i % 3] for i in range(len(qs))]
    opts = SearchOptions(k=10, ef=64, force="brute", use_pq=use_pq)
    backends = {}

    def run(x, plain=False):
        dev = "cpu" if plain else x["dev"]
        if dev not in backends:
            backends[dev] = ShardedBackend(
                make_mesh((1, 4), device=dev), be.sharded, be.schema,
                sel_cfg=be.sel_cfg, codebook=be.codebook, rerank=be.rerank)
        res = router.execute(backends[dev], qs, flts, opts)
        return torch.as_tensor(res.ids), torch.as_tensor(res.dists)

    return ("pq_adc_topr" if use_pq else "filtered_topk"), {"dev": None}, \
        run, _topk_close


def cases() -> dict:
    return {
        "filtered_topk_prefbf": _ft_case(5000, 128, 300, 10, False, 8192),
        "filtered_topk_exclusion": _ft_case(5000, 128, 300, 10, True, 8192),
        "filtered_topk_k100_chained": _ft_case(3000, 20, 37, 100, False),
        "filtered_topk_d16": _ft_case(512, 16, 48, 10, False),
        "pq_adc_topr_f32": _pq_topr_case(5000, 37, 8, 6, 40, torch.float32,
                                         100),
        "pq_adc_topr_bf16_r1600_chained": _pq_topr_case(
            20000, 21, 32, 8, 1600, torch.bfloat16),
        "pq_adc_gather_bf16_m32": _pq_gather_case(5000, 64, 32, 32, 8,
                                                  torch.bfloat16),
        "pq_adc_gather_generic": _pq_gather_case(3000, 9, 12, 7, 5,
                                                 torch.float32),
        "gather_distance": _gather_case(5000, 128, 256, 32),
        "gather_distance_d19": _gather_case(300, 19, 5, 7),
        "embedding_bag_sum": _bag_case(10000, 64, 512, 32, "sum"),
        "embedding_bag_mean": _bag_case(257, 6, 33, 7, "mean"),
        "sharded_brute_f32": _sharded_case(False),
        "sharded_brute_pq": _sharded_case(True),
    }


# -- comparisons -------------------------------------------------------------
def _np(t):
    return t.detach().cpu().numpy()


def _topk_close(got, want) -> dict:
    m = topk_mismatch(_np(want[0]), _np(want[1]), _np(got[0]), _np(got[1]),
                      rtol=TOL, atol=TOL)
    return {"ok": m["dist_mismatch"] == 0 and m["id_mismatch"] == 0, **m}


def _gather_close(got, want) -> dict:
    a, b = _np(got[0]).astype(np.float64), _np(want[0]).astype(np.float64)
    fin = np.isfinite(a) & np.isfinite(b)
    same_inf = bool((np.isfinite(a) == np.isfinite(b)).all())
    close = bool(np.allclose(a[fin], b[fin], rtol=TOL, atol=TOL))
    td = bool(np.array_equal(_np(got[1]), _np(want[1])))
    diff = float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0
    return {"ok": same_inf and close and td, "max_abs_diff": diff}


def _equal(got, want) -> dict:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    ok = all(_same_bits(a.cpu(), b.cpu()) for a, b in zip(got, want))
    return {"ok": ok}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def _outs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _all_same(a, b) -> bool:
    return all(_same_bits(x, y) for x, y in zip(_outs(a), _outs(b)))


# -- placing inputs ---------------------------------------------------------
def _poison_value(dtype):
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    if dtype == torch.uint8:
        return 255
    return 1 << 30


def _place(x, dev, guard: bool):
    """``x``'s tensors on ``dev``; with ``guard`` each one is the middle of
    a buffer with ``GUARD`` poison elements on each side."""
    if isinstance(x, dict):
        return {k: _place(v, dev, guard) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_place(v, dev, guard) for v in x)
    if not isinstance(x, torch.Tensor):
        return dev if x is None else x
    if not guard:
        return x.to(dev).contiguous()
    flat = x.reshape(-1)
    buf = torch.full((flat.numel() + 2 * GUARD,), _poison_value(x.dtype),
                     dtype=x.dtype, device=dev)
    buf[GUARD:GUARD + flat.numel()] = flat.to(dev)
    return buf[GUARD:GUARD + flat.numel()].view(x.shape)


def _poison_allocator(dev, byte: int) -> None:
    """Fill blocks of the caching allocator's small and large pools with
    ``byte`` and free them, so the next allocations start as that byte."""
    if dev.type != "cuda":
        return
    held = [torch.empty(1 << 19, dtype=torch.uint8, device=dev)
            for _ in range(64)]
    held.append(torch.empty(1 << 28, dtype=torch.uint8, device=dev))
    for t in held:
        t.fill_(byte)
    torch.cuda.synchronize(dev)
    del held


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- the two modes ----------------------------------------------------------
def launch_once(dev) -> dict:
    """``--launch``: each case's kernel once, held to its plain version (the
    run ``compute-sanitizer`` watches)."""
    out = {}
    for name, (kernel, inputs, run, close) in cases().items():
        x = _place(inputs, dev, guard=False)
        before = K.launch_counts[kernel]
        got = run(x)
        _sync(dev)
        launched = K.launch_counts[kernel] - before
        want = run(_place(inputs, torch.device("cpu"), guard=False)
                   if name.startswith("sharded") else x, plain=True)
        rec = close(got, want)
        rec["ok"] = rec["ok"] and (dev.type != "cuda" or launched > 0)
        out[name] = {"kernel": kernel, "launches": launched, **rec}
    return out


def checks(dev, repeats: int) -> dict:
    out = {}
    for name, (kernel, inputs, run, close) in cases().items():
        t0 = time.perf_counter()
        x = _place(inputs, dev, guard=False)
        before = K.launch_counts[kernel]
        first = run(x)
        _sync(dev)
        rec = {"kernel": kernel, "launches": K.launch_counts[kernel] - before}
        want = run(_place(inputs, torch.device("cpu"), guard=False)
                   if name.startswith("sharded") else x, plain=True)
        rec["plain"] = close(first, want)
        rec["guard"] = _all_same(run(_place(inputs, dev, guard=True)), first)
        runs = []
        for byte in (0xFF, 0x00):
            _poison_allocator(dev, byte)
            runs.append(run(x))
            _sync(dev)
        rec["poison"] = all(_all_same(r, first) for r in runs)
        diff = 0
        for _ in range(repeats):
            diff += not _all_same(run(x), first)
        _sync(dev)
        rec["repeat"] = {"runs": repeats, "differing": diff}
        rec["ok"] = (rec["plain"]["ok"] and rec["guard"] and rec["poison"]
                     and diff == 0
                     and (dev.type != "cuda" or rec["launches"] > 0))
        rec["seconds"] = time.perf_counter() - t0
        out[name] = rec
    return out


def sanitize(tool: str, timeout: int) -> dict:
    exe = shutil.which("compute-sanitizer") or \
        "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(exe):
        return {"status": "missing"}
    cmd = [exe, "--tool", tool, "--error-exitcode", "86",
           *TOOL_FLAGS[tool], sys.executable, str(Path(__file__).resolve()),
           "--launch"]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        text, rc = p.stdout + p.stderr, p.returncode
    except subprocess.TimeoutExpired as e:
        text = (e.stdout or b"").decode(errors="replace") if isinstance(
            e.stdout, bytes) else (e.stdout or "")
        rc = None
    rec = {"rc": rc, "seconds": time.perf_counter() - t0}
    m = re.search(r"ERROR SUMMARY: (\d+) error", text)
    rec["errors"] = int(m.group(1)) if m else None
    launched = [ln for ln in text.splitlines() if ln.startswith("{")]
    rec["cases"] = json.loads(launched[-1]) if launched else None
    if "Device not supported" in text:
        rec["status"] = "unsupported"
    elif rc == 0 and rec["errors"] == 0 and rec["cases"] and all(
            c["ok"] for c in rec["cases"].values()):
        rec["status"] = "clean"
    elif rec["errors"]:
        rec["status"] = "errors"
    else:
        rec["status"] = "failed"
    rec["report"] = [ln for ln in text.splitlines()
                     if ln.startswith("=========")][:40]
    return rec


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tools", default=",".join(TOOLS))
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds for each sanitizer run")
    ap.add_argument("--device", default="cuda",
                    help="cuda; cpu only rehearses the control flow")
    ap.add_argument("--launch", action="store_true",
                    help="launch each case once and print its comparison")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        K.build_kernels()
    if args.launch:
        res = launch_once(dev)
        print(json.dumps(res))
        return 0 if all(c["ok"] for c in res.values()) else 1
    rec = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda"
           else "cpu", "nvidia_smi": _smi(), "sanitizer": {}}
    tools = [t for t in args.tools.split(",") if t]
    if dev.type == "cuda":
        for tool in tools:
            rec["sanitizer"][tool] = sanitize(tool, args.timeout)
            print(f"[{tool}] {rec['sanitizer'][tool]['status']} errors="
                  f"{rec['sanitizer'][tool]['errors']}", flush=True)
    rec["checks"] = checks(dev, args.repeats)
    for name, c in rec["checks"].items():
        print(f"[check] {name}: ok={c['ok']} plain={c['plain']['ok']} "
              f"guard={c['guard']} poison={c['poison']} "
              f"repeat_differing={c['repeat']['differing']}", flush=True)
    bad_tool = any(s["status"] in ("errors", "failed")
                   for s in rec["sanitizer"].values())
    rec["ok"] = not bad_tool and all(c["ok"] for c in rec["checks"].values())
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
