"""One run of one cell: set-up, the measured window, the check, the result.

Set-up (``setup_s``, from the process's start): the indexed rows on the
device from the configuration's ``data_seed`` (``data``: one fixed draw, as
a dataset's file is, so that every seed serves the same rows and graph),
the query pool and its filters from the run's seed (``traffic``), the HNSW
graph (``graph``), the port's index over both (``program.make_index``), and
one warm-up batch.  The window is a closed
loop with one batch dispatched ahead: dispatch batch i+1, then finish
batch i.  A ``--trace 1`` run also keeps the router's spans on every
batch and profiles ``trace_batches`` batches of the window.  After the
window: the device's memory peak, the check that no JAX module was
loaded, the program's state freed, then the reference over a sample of
the window's answers drawn from the seed.

Every metric is a reader ``metrics/<name>.py`` with ``read(ctx)``, which
returns a number or None (nothing to read).  ``ctx`` is a dict of what the
run recorded: ``cfg``, ``traffic``, ``setup_s``, ``setup`` (its parts),
``batches`` (per finished batch of the window: ``queries``,
``t_dispatch``, ``t_finish``, ``pool``, ``brute``, ``routed_brute``,
``waves``, ``hops``, and in a traced run ``compile_ms`` and ``graph_ms``),
``window_s``, ``queries``, ``recall`` (mean recall@k of the checked
sample), and ``trace``: None, or in a traced run ``profile.summarize``'s
reading plus ``ft_calls``, the traced brute calls as (queries, passing
pairs), and ``gd_calls``, the traced graph calls as (queries, expansions
summed over them: ``SearchResult.hops``).
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import data, graph, reference, traffic as traffic_mod

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")     # top-level module names


# -- files found by name ------------------------------------------------------
def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def find_cell(bench: dict, workload: str, root: Path):
    """(cell, configuration, traffic) of ``workload``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(root / conf["file"])
    check_config(cfg)
    trf = traffic_mod.load(Path(root) / BENCH_DIR.name / "traffic"
                           / f"{cell['traffic']}.json")
    return cell, cfg, trf


LIMIT_KEYS = ("bad_ids", "short", "dist_gap", "exact_gap", "recall_gap",
              "brute_recall_gap")


def check_config(cfg: dict) -> None:
    """Refuse, before any set-up, a configuration whose ``search``,
    ``quant`` or ``limits`` object has a key the harness does not know (a
    typo would silently run, or check, something else), whose compressed
    options name no ``quant`` format, or whose brute route is compressed
    (``use_pq``) with no ``brute_recall_gap`` limit to hold it."""
    from . import program
    known = {"search": program.SEARCH_KEYS + program.SEARCH_OPTION_KEYS,
             "quant": program.QUANT_KEYS, "limits": LIMIT_KEYS}
    for group, keys in known.items():
        unknown = sorted(set(cfg.get(group) or {}) - set(keys))
        if unknown:
            raise ValueError(f"configuration {cfg.get('name')!r}: unknown "
                             f"{group} keys {unknown}; known: {list(keys)}")
    s, q = cfg["search"], cfg.get("quant")
    if s.get("use_pq") and q is None:
        raise ValueError("search.use_pq needs a quant object")
    if s.get("graph_quant") is not None and (q is None or s["graph_quant"]
                                             != q.get("kind", "pq")):
        raise ValueError(f"search.graph_quant {s['graph_quant']!r} needs a "
                         "quant object of that kind")
    if s.get("use_pq") and "brute_recall_gap" not in cfg["limits"]:
        raise ValueError("search.use_pq needs limits.brute_recall_gap: the "
                         "compressed brute route is held to its recall")
    program.build_spec(cfg)
    program.search_options(cfg)


def metric_entries(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str, metric_dir: Path):
    path = metric_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(entries: list, ctx: dict, metric_dir: Path) -> dict:
    out = {}
    for m in entries:
        value = load_reader(m["name"], metric_dir).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# -- the run ------------------------------------------------------------------
def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def make_pool(cfg: dict, trf: dict, base: dict, seed: int, dev):
    """The query pool: (pool, batch, d) queries on the device and each
    batch's drawn specs and scenario names."""
    p, b = trf["pool"], trf["batch"]
    queries = data.make_queries(cfg, base["centers"], p * b, seed, dev)
    rng = np.random.default_rng([int(seed), 1])
    specs, names = [], []
    for _ in range(p):
        s, nm = traffic_mod.draw_batch(trf, b, rng)
        specs.append(s)
        names.append(nm)
    return queries.view(p, b, -1), specs, names


def columns(cfg: dict, base: dict) -> dict:
    icols, fcols = data.schema_columns(cfg)
    cols = {n: base["ints"][:, j] for j, (n, _, _) in enumerate(icols)}
    cols.update({n: base["floats"][:, j] for j, (n, _, _) in enumerate(fcols)})
    return cols


def sample_positions(seed: int, batch_index: int, b: int, count: int):
    rng = np.random.default_rng([int(seed), 2, int(batch_index)])
    return np.sort(rng.choice(b, size=min(count, b), replace=False))


def run_cell(cfg: dict, trf: dict, *, seed: int, seconds: float, trace: bool,
             device, t_start: float | None = None, control: int = 0,
             cut_waves: int = 0, log=print) -> tuple[dict, dict, list]:
    """One run; returns (the result's fields but ``metrics``, the
    context, the compared numbers as (name, value, limit)).  ``control``
    > 0 runs the control instead of the program; ``cut_waves`` > 0 plants
    a fault in the program: every traversal cut to that many waves."""
    from . import program
    check_config(cfg)
    t0 = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    parts = {}
    tp = time.perf_counter()
    dseed = cfg["data_seed"]
    base = data.make_base(cfg, dseed, dev)
    pool_q, pool_specs, pool_names = make_pool(cfg, trf, base, seed, dev)
    cols = columns(cfg, base)
    _sync(dev)
    parts["data_s"] = time.perf_counter() - tp
    k = cfg["search"]["k"]
    ctx = dict(cfg=cfg, traffic=trf, trace=None)

    if control:
        # the control: the reference in the program's place, on TF32
        answers = []
        for i in range(control):
            p = i % trf["pool"]
            pos = sample_positions(seed, i, trf["batch"], trf["check_per_batch"])
            answers.append((p, pos, None))
        numbers, recall, failed, attempted = check(
            cfg, base, cols, pool_q, pool_specs, answers, k, control=True)
        ctx.update(setup_s=time.perf_counter() - t0, batches=[], window_s=0.0,
                   queries=0, recall=recall)
        return {"correct": _correct(numbers), "attempted": attempted,
                "failed": failed, "memory_peak_bytes": 0}, ctx, numbers

    tp = time.perf_counter()
    h = cfg["hnsw"]
    g = graph.build(base["vectors"], M=h["M"], M0=h["M0"], efc=h["efc"],
                    alpha=h["alpha"],
                    gen=data.generator(dseed, dev, 2))
    parts["graph_s"] = time.perf_counter() - tp
    parts.update({f"graph_{k2}": v for k2, v in g["stats"].items()})
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    tp = time.perf_counter()
    fi = program.make_index(cfg, base, g, dseed, dev)
    del g
    runner = program.Runner(fi, cfg, traced=trace, max_steps=cut_waves)
    filters = [[program.to_filter(s) for s in specs] for specs in pool_specs]
    _sync(dev)
    parts["index_s"] = time.perf_counter() - tp
    tp = time.perf_counter()
    runner.finish(runner.dispatch(pool_q[0], filters[0]))
    _sync(dev)
    parts["warmup_s"] = time.perf_counter() - tp
    setup_s = time.perf_counter() - t0
    log("setup " + " ".join(f"{n}={v:.3f}" if isinstance(v, float)
                            else f"{n}={v}" for n, v in parts.items())
        + f" setup_s={setup_s:.3f}")

    # -- the window ------------------------------------------------------------
    npool, b = trf["pool"], trf["batch"]
    batches, answers = [], []
    tr = {}
    trace_from = 1 if trace else -1
    trace_to = trace_from + trf["trace_batches"]
    traced_calls = []
    if trace:
        from torch.profiler import record_function as rng_
    else:
        rng_ = _no_range
    w0 = time.perf_counter()
    w_end = w0 + seconds
    t_disp = time.perf_counter()
    pending = runner.dispatch(pool_q[0], filters[0])
    i = 0
    prof = None
    while True:
        if i == trace_from:
            from . import profile
            prof = profile.traced(tr)
            prof.__enter__()
        nxt, t_next = None, None
        if time.perf_counter() < w_end:
            p = (i + 1) % npool
            t_next = time.perf_counter()
            with rng_("portbench/dispatch"):
                nxt = runner.dispatch(pool_q[p], filters[p])
        with rng_("portbench/finish"):
            out = runner.finish(pending)
        t_fin = time.perf_counter()
        if trace_from < i + 1 <= trace_to and nxt is not None:
            traced_calls.append(i + 1)
        if prof is not None and i + 1 == trace_to:
            prof.__exit__(None, None, None)
            prof = None
        p = i % npool
        rec = {"queries": b, "t_dispatch": t_disp, "t_finish": t_fin,
               "pool": p, "brute": int(out["routed_brute"].sum()),
               "routed_brute": out["routed_brute"], "waves": out["waves"],
               "hops": out["hops"]}
        for key in ("compile_ms", "graph_ms"):
            if key in out:
                rec[key] = out[key]
        batches.append(rec)
        pos = sample_positions(seed, i, b, trf["check_per_batch"])
        answers.append((p, pos, {"ids": out["ids"][pos],
                                 "dists": out["dists"][pos],
                                 "brute": out["routed_brute"][pos]}))
        if nxt is None:
            break
        pending, t_disp = nxt, t_next
        i += 1
    if prof is not None:            # the window closed inside the segment
        prof.__exit__(None, None, None)
    window_s = batches[-1]["t_finish"] - w0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    del runner, fi, pending, filters
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------------
    numbers, recall, failed, attempted = check(
        cfg, base, cols, pool_q, pool_specs, answers, k,
        names=pool_names, log=log)
    if trace and tr:
        # each route's calls under the key of the kernel that serves it:
        # the f32 readers find nothing on a compressed route
        s = cfg["search"]
        ft_key = "pq_calls" if s.get("use_pq") else "ft_calls"
        gd_key = "pq_gd_calls" if s.get("graph_quant") else "gd_calls"
        ft_calls, gd_calls = [], []
        for j in traced_calls:
            rec = batches[j]
            br = np.nonzero(rec["routed_brute"])[0]
            if len(br):
                specs = pool_specs[rec["pool"]]
                passing = sum(int(reference.eval_spec(specs[q], cols).sum())
                              for q in br)
                ft_calls.append((len(br), passing))
            if len(br) < rec["queries"]:
                gd_calls.append((rec["queries"] - len(br), rec["hops"]))
        tr[ft_key] = ft_calls
        tr[gd_key] = gd_calls
        ctx["trace"] = tr
    ctx.update(setup_s=setup_s, setup=parts, batches=batches,
               window_s=window_s, queries=sum(r["queries"] for r in batches),
               recall=recall)
    return {"correct": _correct(numbers),
            "attempted": sum(r["queries"] for r in batches),
            "failed": failed, "checked": attempted,
            "memory_peak_bytes": int(peak)}, ctx, numbers


@contextlib.contextmanager
def _no_range(name):
    yield


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("modules loaded in the run: " + ", ".join(names))
        self.names = names


def check(cfg, base, cols, pool_q, pool_specs, answers, k, *,
          control: bool = False, names=None, log=None):
    """Compare the sampled answers with the reference; returns (the
    numbers as (name, value, limit), mean recall, failed answers, checked
    answers)."""
    uniq = sorted({(p, int(q)) for p, pos, _ in answers for q in pos})
    index = {key: j for j, key in enumerate(uniq)}
    qs = torch.stack([pool_q[p, q] for p, q in uniq])
    specs = [pool_specs[p][q] for p, q in uniq]
    ref = reference.topk(base["vectors"], qs, specs, cols, k)
    if control:
        ctl = reference.topk(base["vectors"], qs, specs, cols, k, tf32=True)
        lam = cfg["search"]["lam"]
        n = base["vectors"].shape[0]
        exact = ref[2].to(torch.float64) / n < lam
        got_i, got_d, rows = ctl[0], ctl[1], list(range(len(uniq)))
        route = exact
    else:
        rows, ids, dists, route = [], [], [], []
        for p, pos, ans in answers:
            rows += [index[(p, int(q))] for q in pos]
            ids.append(torch.as_tensor(ans["ids"]))
            dists.append(torch.as_tensor(ans["dists"]))
            route.append(torch.as_tensor(ans["brute"]))
        got_i, got_d = torch.cat(ids), torch.cat(dists)
        route = torch.cat(route)
    sel = torch.as_tensor(rows, device=qs.device)
    r_sub = tuple(t[sel] for t in ref)
    # the brute route is exact only on the f32 scan; under ``use_pq`` it
    # is the ADC scan and an exact re-rank of its candidates, held to its
    # recall (``brute_recall_gap``) and, by ``dist_gap``, to exact distances
    exact = route & (not cfg["search"].get("use_pq", False))
    res = reference.compare(base["vectors"], qs[sel], [specs[j] for j in rows],
                            cols, got_i, got_d, exact, k, ref=r_sub)
    limits = cfg["limits"]
    per = {"bad_ids": res["bad_ids"] > limits["bad_ids"],
           "short": res["short"] & (res["short"].sum() > limits["short"]),
           "dist_gap": res["dist_gap"] > limits["dist_gap"],
           "exact_gap": res["exact_gap"] > limits["exact_gap"]}
    failed = int(torch.stack([v.bool() for v in per.values()]).any(0).sum())
    recall = float(res["recall"].double().mean())
    numbers = [("bad_ids", int(res["bad_ids"].sum()), limits["bad_ids"]),
               ("short", int(res["short"].sum()), limits["short"]),
               ("dist_gap", float(res["dist_gap"].max()), limits["dist_gap"]),
               ("exact_gap", float(res["exact_gap"].max()),
                limits["exact_gap"])]
    if "brute_recall_gap" in limits:
        brute = res["recall"][route.to(res["recall"].device)]
        gap = 1.0 - float(brute.double().mean()) if len(brute) else 0.0
        numbers.append(("brute_recall_gap", gap, limits["brute_recall_gap"]))
    if "recall_gap" in limits:
        # the share of the true top-k that the sampled answers miss: where
        # the graph route answers, a traversal that stops early or wanders
        # returns passing rows at their true distances, and only this
        # number sees it
        numbers.append(("recall_gap", 1.0 - recall, limits["recall_gap"]))
    if names is not None and log is not None:
        scen = [names[p][q] for p, pos, _ in answers for q in pos]
        rec = res["recall"].float().cpu().numpy()
        by = {nm: float(rec[[i for i, x in enumerate(scen) if x == nm]].mean())
              for nm in dict.fromkeys(scen)}
        log("recall_by_scenario " + json.dumps(by))
    return numbers, recall, failed, len(rows)


def _correct(numbers) -> bool:
    return all(value <= limit for _, value, limit in numbers)


# -- the command --------------------------------------------------------------
def device_info(chips: int, dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def result_line(fields: dict, ctx: dict, bench: dict, workload: str,
                trace: bool, chips: int, dev, numbers, metric_dir=None) -> dict:
    metrics = read_metrics(metric_entries(bench, workload, trace), ctx,
                           metric_dir or BENCH_DIR / "metrics")
    device = device_info(chips, dev)
    device["memory_peak_bytes"] = fields["memory_peak_bytes"]
    out = {"correct": bool(fields["correct"]),
           "attempted": int(fields["attempted"]),
           "failed": int(fields["failed"]), "metrics": metrics,
           "device": device}
    if trace and ctx.get("trace"):
        tr = ctx["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in numbers}
    return out


def main(argv, t_start: float, root: Path) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, default=0,
                    help="run the control: the reference on TF32 in the "
                    "program's place, over this many batches' samples")
    ap.add_argument("--cut-waves", type=int, default=0,
                    help="plant a fault: cut every traversal to this many "
                    "waves (the recall check's upper reading)")
    args = ap.parse_args(argv)
    err = sys.stderr
    bench = load_json(root / "BENCHMARK.json")
    cell, cfg, trf = find_cell(bench, args.workload, root)
    chips = int(cell["chips"])
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card", file=err)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=err)
        return 2
    dev = torch.device("cuda", 0)
    print("card " + card_line(), file=err, flush=True)
    try:
        fields, ctx, numbers = run_cell(
            cfg, trf, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device=dev, t_start=t_start,
            control=args.control, cut_waves=args.cut_waves,
            log=lambda s: print(s, file=err, flush=True))
    except ForbiddenModules as e:
        print(str(e), file=err)
        return 3
    found = forbidden_modules()
    if found:
        print("modules loaded in the run: " + ", ".join(found), file=err)
        return 3
    line = result_line(fields, ctx, bench, args.workload, bool(args.trace),
                       chips, dev, numbers,
                       metric_dir=Path(root) / BENCH_DIR.name / "metrics")
    lat = sorted(1e3 * (r["t_finish"] - r["t_dispatch"]) for r in ctx["batches"])
    if lat:
        print("batch_ms min={:.1f} median={:.1f} max={:.1f}".format(
            lat[0], lat[len(lat) // 2], lat[-1]), file=err)
    print(f"window batches={len(ctx['batches'])} "
          f"window_s={ctx['window_s']:.3f} checked={fields.get('checked')} "
          f"recall={ctx['recall']:.6f}", file=err)
    for name, v, lim in numbers:
        print(f"check {name} {v!r} limit {lim!r}", file=err)
    err.flush()
    print(json.dumps(line), flush=True)
    return 0
