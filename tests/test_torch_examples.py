"""The port's examples run on the CPU at a small size:
``examples/quickstart_torch.py``, ``examples/serve_anns_torch.py`` (one
ServeEngine over LocalBackend and over a 4-shard ShardedBackend),
``examples/recsys_retrieval_torch.py`` (the retrieval layer's two paths and
a graph index), ``examples/rag_retrieval_torch.py`` (LM embeddings into a
filtered index) and ``examples/train_lm_torch.py`` (a reduced LM through
the fault-tolerant loop, then resumed from its checkpoint), each with
``--device cpu``.  Recall bars: the graph and
brute routes at the sizes here, well below the exact 1.0 only where the
graph route runs."""
import importlib.util
from pathlib import Path

import numpy as np
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


def test_recsys_retrieval_torch_runs_on_cpu(capsys):
    out = _example("recsys_retrieval_torch").main(
        ["--device", "cpu", "--n", "3000", "--dim", "16", "--k", "20"])
    assert out["identical_ids"]
    assert out["kernel_launches"] == 0        # CPU tensors: plain version
    assert out["graph_recall"] >= 0.8, out
    assert "FAVOR graph retrieval" in capsys.readouterr().out


def test_rag_retrieval_torch_runs_on_cpu(capsys):
    out = _example("rag_retrieval_torch").main(["--device", "cpu",
                                                "--n", "1000"])
    assert out["found"] > 0
    assert "satisfy the metadata filter" in capsys.readouterr().out


def test_train_lm_torch_runs_and_resumes_on_cpu(tmp_path, capsys):
    ex = _example("train_lm_torch")
    args = ["--device", "cpu", "--batch", "2", "--seq", "8", "--ckpt",
            str(tmp_path / "ck")]
    first = ex.main(args + ["--steps", "51"])     # saves at step 50
    assert first == {"loss": first["loss"], "step": 51, "resumed": False,
                     "opt_step": 51}
    assert np.isfinite(first["loss"])
    second = ex.main(args + ["--steps", "53"])    # resumes at step 50
    assert second["resumed"] and second["step"] == 53
    assert second["opt_step"] == 53                # the optimizer state too
    out = capsys.readouterr().out
    assert "resumed from step 50" in out and "final loss" in out
