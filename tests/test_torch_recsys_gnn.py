"""Port parity, the model zoo's recsys and graph side: ``repro_torch.models``
(recsys, gnn), the recsys retrieval layer on ``filtered_topk``, and the data
pipelines (``data/synthetic.py``'s token, recsys and graph generators,
``data/graphs.py``) against the JAX package's, on the reduced configs.

JAX parameters come from the JAX package's ``init_with_axes`` (its salted
scope hash pinned to ``zlib.crc32`` inside the reference module, as in
``tests/test_torch_models.py``) and cross with
``repro_torch.convert.params_from_reference``.  Bars: recsys forward and
loss 1e-5; retrieval ids identical and scores 1e-4 over 2,000 rows, both
packages' dot-scoring and fused paths (the JAX fused path in Pallas
interpret mode); GCN node and graph readout 1e-5; the data generators and
the neighbour sampler equal array for array."""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.models.module as rmodule  # noqa: E402
from repro.core import filters as RF  # noqa: E402
from repro.data import graphs as rgraphs  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.models import gnn as RG  # noqa: E402
from repro.models import recsys as RR  # noqa: E402
import repro_torch.configs as PC  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import filters as PF  # noqa: E402
from repro_torch.core.router import compile_programs  # noqa: E402
from repro_torch.data import graphs as pgraphs  # noqa: E402
from repro_torch.data import synthetic as psyn  # noqa: E402
from repro_torch.models import gnn as PG  # noqa: E402
from repro_torch.models import module as pmodule  # noqa: E402
from repro_torch.models import recsys as PR  # noqa: E402

TOL = 1e-5
SCORE_TOL = 1e-4
RS_ARCHS = ["fm", "wide-deep", "dien", "dlrm-rm2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _stable_reference_scopes(monkeypatch):
    monkeypatch.setattr(rmodule, "hash", lambda s: zlib.crc32(s.encode()),
                        raising=False)


def _ref_params(init_fn, cfg, seed=0):
    params, _ = rmodule.init_with_axes(init_fn, jax.random.key(seed), cfg)
    return params, params_from_reference(jax.tree.map(np.asarray, params),
                                         device="cpu")


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=tol, atol=tol)


def _same_arrays(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


# ---------------------------------------------------------------------------
# Data pipelines
# ---------------------------------------------------------------------------
def _pipes(mod, arch, cfg, batch=32):
    if arch == "dien":
        return mod.RecsysPipeline(n_sparse=0, vocab=cfg.vocab, batch=batch,
                                  seq_len=cfg.seq_len, seed=3)
    if arch == "dlrm-rm2":
        return mod.RecsysPipeline(n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                                  batch=batch, n_dense=cfg.n_dense, seed=3)
    return mod.RecsysPipeline(n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                              batch=batch, seed=3)


def test_pipelines_match_reference():
    for state in (0, 1, 7):
        a, sa = rsyn.TokenPipeline(vocab=512, seq_len=16, batch=4, seed=1)(state)
        b, sb = psyn.TokenPipeline(vocab=512, seq_len=16, batch=4, seed=1)(state)
        _same_arrays(a, b)
        assert sa == sb
    for arch in RS_ARCHS:
        cfg = RC.get_spec(arch).reduced
        for state in (0, 3):
            a, _ = _pipes(rsyn, arch, cfg)(state)
            b, _ = _pipes(psyn, arch, cfg)(state)
            _same_arrays(a, b)
    for power_law in (True, False):
        _same_arrays(rsyn.make_random_graph(300, 1200, 32, 7, seed=2,
                                            power_law=power_law),
                     psyn.make_random_graph(300, 1200, 32, 7, seed=2,
                                            power_law=power_law))
    _same_arrays(rsyn.make_molecule_batch(8, 30, 64, 32, seed=2),
                 psyn.make_molecule_batch(8, 30, 64, 32, seed=2))


def test_sample_subgraph_matches_reference():
    g = psyn.make_random_graph(2000, 12000, 32, 7, seed=1)
    rcsr = rgraphs.CSRGraph.from_edges(g["edges"], 2000)
    pcsr = pgraphs.CSRGraph.from_edges(g["edges"], 2000)
    assert np.array_equal(rcsr.indptr, pcsr.indptr)
    assert np.array_equal(rcsr.indices, pcsr.indices)
    seeds = np.random.default_rng(0).choice(2000, 64, replace=False)
    a = rgraphs.sample_subgraph(rcsr, g["x"], g["labels"], seeds, (5, 3),
                                np.random.default_rng(9))
    b = pgraphs.sample_subgraph(pcsr, g["x"], g["labels"], seeds, (5, 3),
                                np.random.default_rng(9))
    _same_arrays(a, b)
    assert rgraphs.minibatch_shapes(1024, (15, 10), 602) == \
        pgraphs.minibatch_shapes(1024, (15, 10), 602)


# ---------------------------------------------------------------------------
# RecSys models
# ---------------------------------------------------------------------------
_RS = {
    "fm": (RR.init_fm, RR.fm_forward, RR.fm_loss, PR.FM, ("ids",)),
    "wide-deep": (RR.init_wide_deep, RR.wide_deep_forward, RR.wide_deep_loss,
                  PR.WideDeep, ("ids",)),
    "dien": (RR.init_dien, RR.dien_forward, RR.dien_loss, PR.DIEN,
             ("hist", "target")),
    "dlrm-rm2": (RR.init_dlrm, RR.dlrm_forward, RR.dlrm_loss, PR.DLRM,
                 ("dense", "ids")),
}


@pytest.mark.parametrize("arch", RS_ARCHS)
def test_recsys_matches_reference(arch):
    init, fwd, loss, module, keys = _RS[arch]
    rcfg, pcfg = RC.get_spec(arch).reduced, PC.get_spec(arch).reduced
    jp, tp = _ref_params(init, rcfg, seed=4)
    batch, _ = _pipes(psyn, arch, pcfg, batch=64)(0)
    ins = [batch[k] for k in keys]
    tins = [torch.as_tensor(a) for a in ins]
    lj = jax.jit(lambda p, *a: fwd(p, rcfg, *a))(jp, *ins)
    lt = getattr(PR, fwd.__name__)(tp, pcfg, *tins)
    _close(lj, lt)
    (vj, mj) = jax.jit(lambda p, *a: loss(p, rcfg, *a))(
        jp, *ins, batch["labels"])
    vt, mt = getattr(PR, loss.__name__)(tp, pcfg, *tins,
                                        torch.as_tensor(batch["labels"]))
    _close(vj, vt)
    _close(mj["bce"], mt["bce"])
    # the nn.Module over the converted tree
    m = module(pcfg, device="cpu", seed=1)
    m.load_state_dict(pmodule.ParamModule(tp).state_dict())
    assert torch.equal(m(*tins), lt)


def test_recsys_modules_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in RS_ARCHS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _RS[arch][3](PC.get_spec(arch).reduced)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PG.GCN(PC.get_spec("gcn-cora").reduced)


# ---------------------------------------------------------------------------
# The retrieval layer: FAVOR's filtered_topk under the MIP -> L2 reduction
# ---------------------------------------------------------------------------
def _retrieval_case(n=2000, d=16, b=3):
    rng = np.random.default_rng(0)
    items = rng.normal(size=(n, d)).astype(np.float32)
    users = rng.normal(size=(b, d)).astype(np.float32)
    at = RF.random_attributes(RF.paper_schema(), n, seed=5)
    flts = [RF.Range("f0", 0.0, 60.0), RF.TrueFilter(),
            RF.And(RF.Equality("b0", True), RF.Inclusion("i0", [2, 5, 7]))]
    rprogs = {k: jnp.asarray(v) for k, v in RF.stack_programs(
        [RF.compile_filter(flts[i % 3], RF.paper_schema())
         for i in range(b)]).items()}
    pflts = [PF.Range("f0", 0.0, 60.0), PF.TrueFilter(),
             PF.And(PF.Equality("b0", True), PF.Inclusion("i0", [2, 5, 7]))]
    pprogs = compile_programs([pflts[i % 3] for i in range(b)],
                              PF.paper_schema(), b, device="cpu")
    return items, users, at, rprogs, pprogs


@pytest.mark.parametrize("k", [20, 100])
def test_retrieval_matches_reference(k):
    """Both packages' two paths agree: ids identical, scores 1e-4.  At
    k = 100 the fused path runs chained passes of the kernel's list length
    (``kernels._common.chain_topk``; the plain version on the CPU)."""
    items, users, at, rprogs, pprogs = _retrieval_case()
    args_j = (jnp.asarray(users), jnp.asarray(items), rprogs,
              jnp.asarray(at.ints), jnp.asarray(at.floats))
    args_t = (torch.as_tensor(users), torch.as_tensor(items),
              pprogs,
              torch.as_tensor(at.ints), torch.as_tensor(at.floats))
    ij, sj = RR.retrieval_topk_filtered(*args_j, k=k)
    ijp, sjp = RR.retrieval_topk_filtered(*args_j, k=k, use_pallas=True)
    it, st = PR.retrieval_topk_filtered(*args_t, k=k)
    before = dict(K.launch_counts)
    itk, stk = PR.retrieval_topk_filtered(*args_t, k=k, use_kernel=True)
    assert K.launch_counts == before          # CPU tensors: plain version
    assert it.dtype == itk.dtype == torch.int32
    for ids, sc in ((it, st), (itk, stk)):
        assert np.array_equal(np.asarray(ij), ids.numpy())
        assert np.array_equal(np.asarray(ijp), ids.numpy())
        _close(sj, sc, SCORE_TOL)
        _close(sjp, sc, SCORE_TOL)


def test_retrieval_screen_margin_holds_under_constant_norms():
    """The fused path hands the kernel norms = M^2 for every row, not |v|^2:
    the kernel's TF32 screen takes |v| for its margin from the row itself,
    so the margin ``screen_eps(d) |q| |v|`` bounds the screen's dot error
    whatever ``norms`` holds.  Here: items of very different lengths, and
    the plain version (the kernel's function) gives the exact dot-scoring
    answer."""
    rng = np.random.default_rng(3)
    items = (rng.normal(size=(1500, 24)) *
             rng.uniform(0.01, 10.0, size=(1500, 1))).astype(np.float32)
    users = rng.normal(size=(4, 24)).astype(np.float32)
    at = PF.random_attributes(PF.paper_schema(), 1500, seed=2)
    progs = compile_programs(PF.TrueFilter(), PF.paper_schema(), 4,
                             device="cpu")
    args = (torch.as_tensor(users), torch.as_tensor(items), progs,
            torch.as_tensor(at.ints), torch.as_tensor(at.floats))
    i0, s0 = PR.retrieval_topk_filtered(*args, k=50)
    i1, s1 = PR.retrieval_topk_filtered(*args, k=50, use_kernel=True)
    assert torch.equal(i0, i1)
    _close(s0, s1, SCORE_TOL)


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------
def test_gcn_node_readout_matches_reference():
    rcfg, pcfg = RC.get_spec("gcn-cora").reduced, PC.get_spec("gcn-cora").reduced
    g = psyn.make_random_graph(300, 1200, rcfg.d_feat, rcfg.n_classes, seed=0)
    # pad the edge list with (-1, -1) rows: weight 0
    edges = np.concatenate([g["edges"], np.full((2, 37), -1, np.int32)], 1)
    jp, tp = _ref_params(RG.init_gcn, rcfg, seed=1)
    oj = RG.gcn_forward(jp, rcfg, g["x"], edges, g["deg"])
    ot = PG.gcn_forward(tp, pcfg, torch.as_tensor(g["x"]),
                        torch.as_tensor(edges), torch.as_tensor(g["deg"]))
    _close(oj, ot)
    lj, mj = RG.gcn_loss(jp, rcfg, g["x"], edges, g["deg"], g["labels"],
                         g["mask"])
    lt, mt = PG.gcn_loss(tp, pcfg, *(torch.as_tensor(a) for a in (
        g["x"], edges, g["deg"], g["labels"], g["mask"])))
    _close(lj, lt)
    assert float(mj["acc"]) == float(mt["acc"])
    m = PG.GCN(pcfg, device="cpu")
    m.load_state_dict(pmodule.ParamModule(tp).state_dict())
    assert torch.equal(m(torch.as_tensor(g["x"]), torch.as_tensor(edges),
                         torch.as_tensor(g["deg"])), ot)


def test_gcn_graph_readout_matches_reference():
    rcfg = RG.GCNConfig(name="mol-red", n_layers=2, d_feat=32, d_hidden=16,
                        n_classes=2, readout="graph")
    pcfg = PG.GCNConfig(**dataclasses.asdict(rcfg))
    b = psyn.make_molecule_batch(8, 30, 64, 32, seed=2)
    jp, tp = _ref_params(RG.init_gcn, rcfg, seed=2)
    keys = ("x", "edges", "deg")
    oj = RG.gcn_forward(jp, rcfg, *(b[k] for k in keys),
                        graph_ids=b["graph_ids"], n_graphs=8)
    ot = PG.gcn_forward(tp, pcfg, *(torch.as_tensor(b[k]) for k in keys),
                        graph_ids=torch.as_tensor(b["graph_ids"]), n_graphs=8)
    assert ot.shape == (8, 2)
    _close(oj, ot)
    lj, _ = RG.gcn_loss(jp, rcfg, *(b[k] for k in keys), b["labels"],
                        b["mask"], graph_ids=b["graph_ids"], n_graphs=8)
    lt, _ = PG.gcn_loss(tp, pcfg, *(torch.as_tensor(b[k]) for k in keys),
                        torch.as_tensor(b["labels"]), torch.as_tensor(b["mask"]),
                        graph_ids=torch.as_tensor(b["graph_ids"]), n_graphs=8)
    _close(lj, lt)
