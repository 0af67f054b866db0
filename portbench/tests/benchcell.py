"""Shared pieces of the benchmark's tests: the repository's ``src`` and root
on the path, and a tiny cell that runs on the CPU in seconds.  Imported by
name (pytest puts this directory on the path), as ``conftest`` is the
name ``tests/`` uses."""
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny(config: str = "sift1m-f32", traffic: str = "paper-graph.b10000",
         small_graph: bool = True, **sizes):
    """A configuration and traffic of the repository, cut to a CPU test's
    size: 3,000 rows x 32 dims, 2 pool batches of 48 queries, and (with
    ``small_graph``) HNSW M 8, M0 16, efc 40."""
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{config}.json").read_text())
    trf = json.loads((ROOT / "portbench" / "traffic"
                      / f"{traffic}.json").read_text())
    cfg.update(n=3000, dim=32, n_clusters=8)
    if small_graph:
        cfg["hnsw"] = dict(cfg["hnsw"], M=8, M0=16, efc=40)
    trf.update(batch=48, pool=2, check_per_batch=16, trace_batches=1)
    cfg.update(sizes)
    return copy.deepcopy(cfg), copy.deepcopy(trf)
