"""No run loads JAX or the JAX package; names are compared whole by their
top-level part, since the port's name ``repro_torch`` begins with the JAX
package's ``repro``.  A checkout without the port, or a machine without a
card, gets no result line."""
import os
import subprocess
import sys
import types

from benchcell import ROOT
from portbench import harness


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["repro"]


RUN = """
import sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
from benchcell import tiny
from portbench import harness
cfg, trf = tiny()
fields, ctx, numbers = harness.run_cell(cfg, trf, seed=3, seconds=0.3,
                                        trace=False, device="cpu",
                                        log=lambda s: None)
assert fields["correct"]
print(sorted({{n.split(".")[0] for n in sys.modules}}))
"""


def test_a_run_loads_no_jax_module():
    code = RUN.format(src=str(ROOT / "src"), root=str(ROOT),
                      tests=str(ROOT / "portbench" / "tests"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def _cli(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sift1m-f32.paper-graph.b10000", "--seed", "2147483700",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=cwd,
        env=dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES=""))


def test_no_result_without_a_card():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_the_port(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
