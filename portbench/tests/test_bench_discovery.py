"""A configuration, a traffic mix and a metric added as files are found by
their names in BENCHMARK.json, with no file of the harness edited."""
import json
import shutil

import torch

from benchcell import ROOT, tiny
from portbench import harness


def test_new_files_are_found_by_name(tmp_path):
    cfg, trf = tiny()
    cfg["name"] = "tiny-new"
    bench_dir = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        (bench_dir / sub).mkdir(parents=True)
    (bench_dir / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    trf["mix"] = trf["mix"][:2]
    (bench_dir / "traffic" / "two-scenarios.json").write_text(json.dumps(trf))
    (bench_dir / "metrics" / "router.queries_per_batch.py").write_text(
        "def read(ctx):\n"
        "    rows = ctx['batches']\n"
        "    return sum(r['queries'] for r in rows) / len(rows)\n")
    for name in ("qps.py", "setup_s.py"):
        shutil.copy(ROOT / "portbench" / "metrics" / name,
                    bench_dir / "metrics" / name)
    bench = {
        "configs": [{"name": "tiny-new", "source": "a test",
                     "file": "portbench/configs/tiny-new.json",
                     "reduced": [], "why": "a test"}],
        "workloads": [{"name": "tiny-new.two", "config": "tiny-new",
                       "traffic": "two-scenarios", "chips": 1,
                       "why": "a test"}],
        "end_to_end": [
            {"name": "qps", "unit": "queries/s", "better": "higher",
             "bound": 0.05, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"},
            {"name": "router.queries_per_batch", "unit": "queries",
             "better": "higher", "bound": 0.01, "source": "host_clock",
             "workloads": ["tiny-new.two"]}],
        "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, got_cfg, got_trf = harness.find_cell(bench, "tiny-new.two",
                                               tmp_path)
    assert got_cfg == cfg and got_trf == trf and cell["chips"] == 1
    fields, ctx, numbers = harness.run_cell(
        got_cfg, got_trf, seed=4, seconds=0.3, trace=False, device="cpu",
        log=lambda s: None)
    line = harness.result_line(fields, ctx, bench, "tiny-new.two", False, 1,
                               torch.device("cpu"), numbers,
                               metric_dir=bench_dir / "metrics")
    assert line["metrics"]["router.queries_per_batch"]["value"] == 48
    assert set(line["metrics"]) == {"qps", "setup_s",
                                    "router.queries_per_batch"}


def test_the_repository_benchmark_names_existing_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        harness.find_cell(bench, w["name"], ROOT)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(harness.load_reader(
            m["name"], ROOT / "portbench" / "metrics"), "read")
