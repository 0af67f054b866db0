"""The port's counterparts of the train-step tests of
``tests/test_configs_smoke.py``: every architecture's reduced config takes
a train step on the CPU (finite loss and parameters, the step counted),
the LM and the GCN learn, the sampled and molecule GCN cells give a finite
loss, and microbatch accumulation equals the single batch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_spec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.graphs import CSRGraph, sample_subgraph  # noqa: E402
from repro_torch.models import gnn, recsys  # noqa: E402
from repro_torch.models.module import init_with_axes, param_count  # noqa: E402
from repro_torch.models.transformer import init_lm, lm_loss  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.step import make_train_step  # noqa: E402

LM_ARCHS = ["olmoe-1b-7b", "arctic-480b", "qwen1.5-32b",
            "command-r-plus-104b", "gemma2-2b"]
RS_ARCHS = ["fm", "wide-deep", "dien", "dlrm-rm2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _finite(tree):
    return all(bool(torch.isfinite(x).all()) for x in opt.tree_leaves(tree)
               if x.is_floating_point())


def _lm_loss_fn(cfg):
    def loss_fn(p, b):
        return lm_loss(p, cfg, torch.as_tensor(b["tokens"]),
                       torch.as_tensor(b["labels"]))
    return loss_fn


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step(arch):
    cfg = get_spec(arch).reduced
    params, _ = init_with_axes(init_lm, 0, cfg, device="cpu")
    assert param_count(params) > 0
    pipe = synthetic.TokenPipeline(vocab=cfg.vocab, seq_len=16, batch=4, seed=1)
    batch, _ = pipe(0)
    step = make_train_step(_lm_loss_fn(cfg),
                           opt.OptConfig(lr=1e-3, total_steps=10))
    st = opt.init_opt_state(params, opt.OptConfig())
    params2, st2, metrics = step(params, st, batch)
    assert torch.isfinite(metrics["loss"])
    assert _finite(params2), f"{arch}: NaN params after update"
    assert int(st2.step) == 1


def test_lm_loss_decreases():
    cfg = get_spec("gemma2-2b").reduced
    params, _ = init_with_axes(init_lm, 3, cfg, device="cpu")
    pipe = synthetic.TokenPipeline(vocab=cfg.vocab, seq_len=32, batch=16, seed=2)
    ocfg = opt.OptConfig(lr=1e-2, total_steps=80, warmup_steps=5)
    step = make_train_step(_lm_loss_fn(cfg), ocfg)
    st = opt.init_opt_state(params, ocfg)
    state, losses = 0, []
    for _ in range(60):
        batch, state = pipe(state)
        params, st, m = step(params, st, batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses


def _gcn_loss_fn(cfg, **kw):
    keys = ("x", "edges", "deg", "labels", "mask")

    def loss_fn(p, b):
        extra = {k: torch.as_tensor(b[k]) for k in ("graph_ids",) if k in b}
        return gnn.gcn_loss(p, cfg, *[torch.as_tensor(b[k]) for k in keys],
                            **extra, **kw)
    return loss_fn


def test_gcn_full_graph():
    cfg = get_spec("gcn-cora").reduced
    g = synthetic.make_random_graph(300, 1200, cfg.d_feat, cfg.n_classes, seed=0)
    params, _ = init_with_axes(gnn.init_gcn, 0, cfg, device="cpu")
    step = make_train_step(_gcn_loss_fn(cfg),
                           opt.OptConfig(lr=1e-2, total_steps=20))
    st = opt.init_opt_state(params, opt.OptConfig())
    first = last = None
    for _ in range(20):
        params, st, m = step(params, st, g)
        first = first if first is not None else float(m["loss"])
        last = float(m["loss"])
    assert last < first  # learnable signal propagates through index_add_


def test_gcn_minibatch_sampler():
    cfg = get_spec("gcn-cora").reduced
    g = synthetic.make_random_graph(2000, 12000, cfg.d_feat, cfg.n_classes,
                                    seed=1)
    csr = CSRGraph.from_edges(g["edges"], 2000)
    rng = np.random.default_rng(0)
    seeds = rng.choice(2000, 64, replace=False)
    sub = sample_subgraph(csr, g["x"], g["labels"], seeds, (5, 3), rng)
    assert sub["x"].shape[0] == 64 + 64 * 5 + 64 * 5 * 3
    params, _ = init_with_axes(gnn.init_gcn, 1, cfg, device="cpu")
    step = make_train_step(_gcn_loss_fn(cfg), opt.OptConfig(lr=1e-2))
    params2, _, m = step(params, opt.init_opt_state(params, opt.OptConfig()),
                         sub)
    assert bool(torch.isfinite(m["loss"])) and _finite(params2)


def test_gcn_molecule_batch():
    cfg = gnn.GCNConfig(name="mol-red", n_layers=2, d_feat=32, d_hidden=16,
                        n_classes=2, readout="graph")
    b = synthetic.make_molecule_batch(8, 30, 64, 32, seed=2)
    params, _ = init_with_axes(gnn.init_gcn, 2, cfg, device="cpu")
    step = make_train_step(_gcn_loss_fn(cfg, n_graphs=8),
                           opt.OptConfig(lr=1e-2))
    params2, _, m = step(params, opt.init_opt_state(params, opt.OptConfig()),
                         b)
    assert bool(torch.isfinite(m["loss"])) and _finite(params2)
    assert params2["head"]["w"].shape == (2, 2)


def _rs_batch(arch, cfg, batch=32):
    if arch == "dien":
        pipe = synthetic.RecsysPipeline(n_sparse=0, vocab=cfg.vocab,
                                        batch=batch, seq_len=cfg.seq_len, seed=3)
    elif arch == "dlrm-rm2":
        pipe = synthetic.RecsysPipeline(n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                                        batch=batch, n_dense=cfg.n_dense, seed=3)
    else:
        pipe = synthetic.RecsysPipeline(n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                                        batch=batch, seed=3)
    return pipe(0)[0]


_RS = {"fm": (recsys.init_fm, recsys.fm_loss, ("ids",)),
       "wide-deep": (recsys.init_wide_deep, recsys.wide_deep_loss, ("ids",)),
       "dien": (recsys.init_dien, recsys.dien_loss, ("hist", "target")),
       "dlrm-rm2": (recsys.init_dlrm, recsys.dlrm_loss, ("dense", "ids"))}


def _rs_loss_fn(arch, cfg):
    _, loss, keys = _RS[arch]

    def lf(p, b):
        return loss(p, cfg, *[torch.as_tensor(b[k]) for k in keys],
                    torch.as_tensor(b["labels"]))
    return lf


@pytest.mark.parametrize("arch", RS_ARCHS)
def test_recsys_train_step(arch):
    cfg = get_spec(arch).reduced
    params, _ = init_with_axes(_RS[arch][0], 4, cfg, device="cpu")
    step = make_train_step(_rs_loss_fn(arch, cfg),
                           opt.OptConfig(lr=1e-3, total_steps=10))
    st = opt.init_opt_state(params, opt.OptConfig())
    params2, st2, m = step(params, st, _rs_batch(arch, cfg))
    assert torch.isfinite(m["loss"])
    assert _finite(params2), f"{arch}: NaN after update"
    assert int(st2.step) == 1


def test_microbatch_accumulation_equivalence():
    """grad-accum path == single-batch path (same loss, close params)."""
    cfg = get_spec("fm").reduced
    params, _ = init_with_axes(recsys.init_fm, 7, cfg, device="cpu")
    b = _rs_batch("fm", cfg, batch=32)
    ocfg = opt.OptConfig(lr=1e-3, total_steps=10)
    s1 = make_train_step(_rs_loss_fn("fm", cfg), ocfg, microbatches=1,
                         donate=False)
    s4 = make_train_step(_rs_loss_fn("fm", cfg), ocfg, microbatches=4,
                         donate=False)
    st = opt.init_opt_state(params, ocfg)
    p1, _, m1 = s1(params, st, b)
    p4, _, m4 = s4(params, st, b)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-5
    d = max(float((a - bb).abs().max())
            for a, bb in zip(opt.tree_leaves(p1), opt.tree_leaves(p4)))
    assert d < 1e-5
