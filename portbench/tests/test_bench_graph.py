"""The device graph builder, on the CPU at a small size."""
import numpy as np
import torch

from benchcell import tiny
from portbench import data, graph, program, reference, traffic
from repro_torch.core import HnswParams, build_hnsw
from repro_torch.convert import from_reference_arrays


def _build(cfg, seed):
    dev = torch.device("cpu")
    base = data.make_base(cfg, seed, dev)
    h = cfg["hnsw"]
    g = graph.build(base["vectors"], M=h["M"], M0=h["M0"], efc=h["efc"],
                    alpha=h["alpha"], gen=data.generator(seed, dev, 2))
    return base, g


def test_graph_layout():
    """The JAX package's HnswIndex layout: every level's rows hold at most
    M_l distinct ids of nodes on that level, never the node itself; rows of
    nodes below a level are empty; the entry point is on the top level."""
    cfg, _ = tiny()
    base, g = _build(cfg, 3)
    n = cfg["n"]
    lvl = g["node_level"].astype(np.int64)
    assert lvl.max() == g["max_level"] == len(g["levels"]) - 1
    assert lvl[g["entry_point"]] == g["max_level"]
    assert g["entry_point"] == int(np.nonzero(lvl == g["max_level"])[0][0])
    for lv, arr in enumerate(g["levels"]):
        m = cfg["hnsw"]["M0"] if lv == 0 else cfg["hnsw"]["M"]
        assert arr.shape == (n, m) and arr.dtype == np.int32
        on = lvl >= lv
        assert (arr[~on] == -1).all()
        for v in np.nonzero(on)[0]:
            row = arr[v][arr[v] >= 0]
            assert len(set(row.tolist())) == len(row)
            assert v not in row
            assert (lvl[row] >= lv).all()
        if on.sum() > m:
            assert (arr[on] >= 0).sum(1).min() > 0
    assert g["delta_d"] > 0


def test_candidates_are_earlier_rows_nearest_first():
    """A node's candidates are the nearest of the rows before it."""
    g = torch.Generator().manual_seed(0)
    v = torch.randn((300, 8), generator=g)
    ids, dist = graph.knn(v, (v * v).sum(1), 20)
    d = torch.cdist(v.double(), v.double())
    for i in (0, 1, 7, 150, 299):
        want = torch.argsort(d[i, :i])[:20] if i else torch.empty(0)
        got = ids[i][ids[i] >= 0]
        assert got.tolist() == want.tolist()
        assert torch.allclose(dist[i][:len(got)].double(), d[i, got],
                              rtol=1e-4, atol=1e-4)


def test_recall_against_the_port_host_build():
    """Served through the port, the device-built graph reaches the recall
    of the port's own sequential build (``build_hnsw``) on the same rows
    with the same parameters, within 0.02: both are HNSW graphs whose
    candidates are the rows inserted before a node, the device's exactly,
    the host's by a beam search, so neither should be the worse graph."""
    cfg, trf = tiny(n=2500, dim=64, n_clusters=16)
    cfg["hnsw"] = dict(cfg["hnsw"], M=8, M0=16, efc=48)
    seed = 9
    base, g = _build(cfg, seed)
    vec = base["vectors"].numpy()
    cols = {"b0": base["ints"][:, 0], "i0": base["ints"][:, 1],
            "f0": base["floats"][:, 0]}
    specs, _ = traffic.draw_batch(trf, 200, np.random.default_rng(1))
    q = data.make_queries(cfg, base["centers"], 200, seed,
                          torch.device("cpu"))
    ref = reference.topk(base["vectors"], q, specs, cols, 10)
    flts = [program.to_filter(s) for s in specs]
    h = cfg["hnsw"]
    params = HnswParams(M=h["M"], M0=h["M0"], efc=h["efc"], seed=seed)
    schema = [("b0", "bool", 2), ("i0", "int", 10), ("f0", "float", 0)]

    def recall(levels, node_level, entry, top, dd):
        fi = from_reference_arrays(
            vectors=vec, levels=levels, node_level=node_level,
            entry_point=entry, max_level=top, delta_d=dd, params=params,
            ints=base["ints"].numpy(), floats=base["floats"].numpy(),
            schema=schema, device="cpu")
        runner = program.Runner(fi, cfg)
        res = runner.query(q, flts)
        out = reference.compare(base["vectors"], q, specs, cols,
                                torch.as_tensor(res.ids),
                                torch.as_tensor(res.dists),
                                torch.as_tensor(res.routed_brute), 10,
                                ref=ref)
        return float(out["recall"].mean())

    ours = recall(g["levels"], g["node_level"], g["entry_point"],
                  g["max_level"], g["delta_d"])
    host = build_hnsw(vec, params)
    theirs = recall(host.levels, host.node_level, host.entry_point,
                    host.max_level, host.delta_d)
    assert ours >= theirs - 0.02, (ours, theirs)
    # Eq. 5 on the insertion-time curves: the host builder's estimate
    assert abs(g["delta_d"] - host.delta_d) <= 0.1 * host.delta_d
