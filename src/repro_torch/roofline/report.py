"""Render the port's dryrun_results.json (``launch/dryrun.py``) into the
JAX package's roofline tables: the same columns, the terms on the H100's
constants, and the single-pod collective schedule (each record's
collectives by kind and its link bytes per device)."""
from __future__ import annotations

import json
import sys


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}EB"


def fmt_t(x) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1.0:
        return f"{x*1e3:.2f}ms"
    return f"{x:.3f}s"


def table(results: list[dict], mesh: str) -> str:
    rows = []
    head = ("| arch | shape | t_compute | t_memory | t_collective | bound | "
            "model TF | useful% | roofline% | mem/dev |")
    sep = "|" + "---|" * 10
    rows.append(head)
    rows.append(sep)
    for r in sorted(results, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh:
            continue
        if r.get("skipped"):
            rows.append(f"| {r['arch']} | {r['shape']} | skip | skip | skip | "
                        f"- | - | - | - | - |")
            continue
        if not r.get("ok"):
            rows.append(f"| {r['arch']} | {r['shape']} | FAIL | | | | | | | |")
            continue
        ro = r["roofline"]
        mem = r.get("memory", {})
        dev_mem = (mem.get("argument_size_in_bytes", 0) +
                   mem.get("temp_size_in_bytes", 0))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_t(ro['t_compute_s'])} | "
            f"{fmt_t(ro['t_memory_s'])} | {fmt_t(ro['t_collective_s'])} | "
            f"{ro['bottleneck']} | {ro['model_flops']/1e12:.1f} | "
            f"{100*ro['useful_flops_frac']:.1f} | "
            f"{100*ro['roofline_frac']:.2f} | {fmt_bytes(dev_mem)} |")
    return "\n".join(rows)


def collective_summary(results: list[dict], mesh: str) -> str:
    rows = ["| arch | shape | collectives (count) | link bytes/dev |",
            "|---|---|---|---|"]
    for r in sorted(results, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh or not r.get("ok") or r.get("skipped"):
            continue
        ro = r["roofline"]
        cc = ro["collectives"]["counts"]
        cs = " ".join(f"{k}:{v}" for k, v in sorted(cc.items())) or "none"
        rows.append(f"| {r['arch']} | {r['shape']} | {cs} | "
                    f"{fmt_bytes(ro['coll_link_bytes'])} |")
    return "\n".join(rows)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    with open(path) as f:
        results = json.load(f)
    for mesh in ("16x16", "2x16x16"):
        n_ok = sum(1 for r in results if r["mesh"] == mesh and r.get("ok"))
        n = sum(1 for r in results if r["mesh"] == mesh)
        print(f"\n## Roofline -- mesh {mesh} ({n_ok}/{n} cells ok)\n")
        print(table(results, mesh))
    print("\n## Collective schedule (single-pod)\n")
    print(collective_summary(results, "16x16"))


if __name__ == "__main__":
    main()
