"""The port's examples run on the CPU at a small size:
``examples/quickstart_torch.py`` and ``examples/serve_anns_torch.py`` (one
ServeEngine over LocalBackend and over a 4-shard ShardedBackend), each with
``--device cpu``.  Recall bars: the graph and brute routes at the sizes
here, well below the exact 1.0 only where the graph route runs."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_on_cpu(capsys):
    recall = _example("quickstart_torch").main(
        ["--device", "cpu", "--n", "1200", "--dim", "16", "--queries", "8"])
    assert len(recall) == 6
    assert min(recall.values()) >= 0.8, recall
    assert "custom filter results" in capsys.readouterr().out


def test_serve_anns_torch_runs_on_cpu(capsys):
    recall = _example("serve_anns_torch").main(
        ["--device", "cpu", "--n", "1200", "--dim", "16", "--requests", "48",
         "--shards", "4"])
    assert set(recall) == {"local", "sharded"}
    assert recall["sharded"] >= recall["local"] - 0.1, recall
    out = capsys.readouterr().out
    assert "sharding DB 4-way" in out and "[sharded x4] done: 48" in out
