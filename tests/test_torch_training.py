"""Port parity, training: ``repro_torch.training`` (optimizer, train step,
compression, checkpoint, fault-tolerant loop) and the model zoo's
gradients, against the JAX package on the CPU.

The JAX parameters come from the JAX package's ``init_with_axes`` and cross
with ``repro_torch.convert.params_from_reference``; batches are numpy from
the JAX package's pipelines.  Its scope seeds are pinned to
``zlib.crc32`` (as in ``tests/test_torch_models.py``) so every run sees the
same weights.  Bars, per gradient leaf: |g_port - g_jax| <= tol * max|g_jax|
with tol 1e-5 for the recsys models and the GCN, 1e-4 for the five LMs (the
MoE configs first route every token of every layer to the same experts in
both packages); optimizer updates 1e-6; three SGDM steps, parameters and
losses 1e-5; three AdamW steps, losses 1e-4 (Adam's first step is close to
sign(g), so its parameters are not held); ``quantize_dequantize`` bit for
bit.  The serving paths build no autograd graph: their outputs do not
require grad."""
import dataclasses
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.models.module as rmodule  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.models import gnn as RG  # noqa: E402
from repro.models import recsys as RR  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.training import checkpoint as rckpt  # noqa: E402
from repro.training import compression as rcomp  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro.training.step import make_train_step as r_make_step  # noqa: E402
import repro_torch.configs as PC  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import gnn as PG  # noqa: E402
from repro_torch.models import module as pmodule  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import recsys as PR  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.training import checkpoint as pckpt  # noqa: E402
from repro_torch.training import compression as pcomp  # noqa: E402
from repro_torch.training import fault_tolerance as pft  # noqa: E402
from repro_torch.training import optimizer as popt  # noqa: E402
from repro_torch.training import step as pstep  # noqa: E402

LM_ARCHS = ["olmoe-1b-7b", "arctic-480b", "qwen1.5-32b",
            "command-r-plus-104b", "gemma2-2b"]
RS_ARCHS = ["fm", "wide-deep", "dien", "dlrm-rm2"]
LM_TOL, RS_TOL, OPT_TOL = 1e-4, 1e-5, 1e-6


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
    """The reference's scope seed ``hash(name) % 2**31`` is salted per
    process: shadow the builtin in its module with a stable hash."""
    monkeypatch.setattr(rmodule, "hash", lambda s: zlib.crc32(s.encode()),
                        raising=False)


def _np(tree):
    """Host copies (``np.asarray`` of a JAX CPU array may share its buffer,
    which the port's in-place updates would then write)."""
    return jax.tree.map(np.array, tree)


def _port(tree):
    return params_from_reference(_np(tree), device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach().numpy()
                                    if torch.is_tensor(tree) else tree,
                                    np.float64)}


def _leaves_close(ref, port, tol, what=""):
    """Each leaf within ``tol`` of the reference leaf's max |value|."""
    r, p = _flat(_np(ref)), _flat(port)
    assert r.keys() == p.keys()
    for k in r:
        scale = max(float(np.abs(r[k]).max()), 1e-30)
        err = float(np.abs(p[k] - r[k]).max())
        assert err <= tol * scale, f"{what} {k}: {err} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# The architectures' losses: (init, JAX loss, port loss, batch) per arch
# ---------------------------------------------------------------------------
def _rs_batch(arch, cfg, batch=32):
    if arch == "dien":
        pipe = rsyn.RecsysPipeline(n_sparse=0, vocab=cfg.vocab, batch=batch,
                                   seq_len=cfg.seq_len, seed=3)
    elif arch == "dlrm-rm2":
        pipe = rsyn.RecsysPipeline(n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                                   batch=batch, n_dense=cfg.n_dense, seed=3)
    else:
        pipe = rsyn.RecsysPipeline(n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                                   batch=batch, seed=3)
    return pipe(0)[0]


def _rs_keys(arch):
    return {"dien": ("hist", "target"), "dlrm-rm2": ("dense", "ids")}.get(
        arch, ("ids",))


_RS = {"fm": ("init_fm", "fm_loss"),
       "wide-deep": ("init_wide_deep", "wide_deep_loss"),
       "dien": ("init_dien", "dien_loss"),
       "dlrm-rm2": ("init_dlrm", "dlrm_loss")}


def _case(arch, cfg=None, batch_rows=None):
    """(JAX init fn, cfg, JAX loss(p, b), port loss(p, b), numpy batch)."""
    if arch in LM_ARCHS:
        cfg = cfg or RC.get_spec(arch).reduced
        pcfg = PC.get_spec(arch).reduced if cfg == RC.get_spec(arch).reduced \
            else _port_cfg(cfg)
        pipe = rsyn.TokenPipeline(vocab=cfg.vocab, seq_len=16,
                                  batch=batch_rows or 4, seed=1)
        return (RT.init_lm, cfg,
                lambda p, b: RT.lm_loss(p, cfg, jnp.asarray(b["tokens"]),
                                        jnp.asarray(b["labels"])),
                lambda p, b: PT.lm_loss(p, pcfg, torch.as_tensor(b["tokens"]),
                                        torch.as_tensor(b["labels"])),
                pipe(0)[0])
    if arch in ("gcn-cora", "gcn-molecule"):
        if arch == "gcn-cora":
            cfg = RC.get_spec("gcn-cora").reduced
            g = rsyn.make_random_graph(300, 1200, cfg.d_feat, cfg.n_classes,
                                       seed=0)
            kw = {}
        else:
            cfg = RG.GCNConfig(name="mol-red", n_layers=2, d_feat=32,
                               d_hidden=16, n_classes=2, readout="graph")
            g = rsyn.make_molecule_batch(8, 30, 64, 32, seed=2)
            kw = {"n_graphs": 8}
        pcfg = PG.GCNConfig(**dataclasses.asdict(cfg))
        keys = ("x", "edges", "deg", "labels", "mask")

        def jl(p, b):
            extra = ({"graph_ids": jnp.asarray(b["graph_ids"]), **kw}
                     if kw else {})
            return RG.gcn_loss(p, cfg, *[jnp.asarray(b[k]) for k in keys],
                               **extra)

        def pl(p, b):
            extra = ({"graph_ids": torch.as_tensor(b["graph_ids"]), **kw}
                     if kw else {})
            return PG.gcn_loss(p, pcfg, *[torch.as_tensor(b[k]) for k in keys],
                               **extra)
        return RG.init_gcn, cfg, jl, pl, g
    init_name, loss_name = _RS[arch]
    cfg = RC.get_spec(arch).reduced
    pcfg = PC.get_spec(arch).reduced
    keys = _rs_keys(arch)
    rl, pl_ = getattr(RR, loss_name), getattr(PR, loss_name)
    return (getattr(RR, init_name), cfg,
            lambda p, b: rl(p, cfg, *[jnp.asarray(b[k]) for k in keys],
                            jnp.asarray(b["labels"])),
            lambda p, b: pl_(p, pcfg, *[torch.as_tensor(b[k]) for k in keys],
                             torch.as_tensor(b["labels"])),
            _rs_batch(arch, cfg, batch_rows or 32))


def _port_cfg(cfg):
    """The port's LMConfig of a (replaced) reference LMConfig."""
    d = dataclasses.asdict(cfg)
    if d["moe"] is not None:
        d["moe"] = PM.MoEConfig(**d["moe"])
    return PT.LMConfig(**d)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------
def _routing(monkeypatch, arch, cfg, jp, tp, batch):
    """Every layer's top-k expert ids, per package (the JAX forward runs
    eagerly under ``disable_jit`` so its scan's layers run one by one)."""
    ref, port = [], []
    top_k = jax.lax.top_k

    def rec_ref(x, k):
        v, i = top_k(x, k)
        ref.append(np.asarray(i))
        return v, i
    real = PM.stable_top_k

    def rec_port(x, k):
        v, i = real(x, k)
        port.append(i.numpy())
        return v, i
    monkeypatch.setattr(jax.lax, "top_k", rec_ref)
    monkeypatch.setattr(PM, "stable_top_k", rec_port)
    with jax.disable_jit():
        RT.forward_train(jp, cfg, jnp.asarray(batch["tokens"]))
    PT.forward_train(tp, _port_cfg(cfg), torch.as_tensor(batch["tokens"]))
    monkeypatch.undo()
    return ref, port


@pytest.mark.parametrize("arch", LM_ARCHS + RS_ARCHS +
                         ["gcn-cora", "gcn-molecule"])
def test_gradients_match_reference(arch, monkeypatch):
    init, cfg, jl, pl, batch = _case(arch)
    jp, _ = rmodule.init_with_axes(init, jax.random.key(5), cfg)
    tp = _port(jp)
    if arch in LM_ARCHS and cfg.moe:
        ref, port = _routing(monkeypatch, arch, cfg, jp, tp, batch)
        assert len(ref) == len(port) == cfg.n_layers
        for r, p in zip(ref, port):
            np.testing.assert_array_equal(p, r)
        monkeypatch.setattr(rmodule, "hash", lambda s: zlib.crc32(s.encode()),
                            raising=False)
    (jloss, _), jg = jax.value_and_grad(jl, has_aux=True)(jp, batch)
    ploss, _, pg = pstep.loss_and_grads(pl, tp, batch)
    tol = LM_TOL if arch in LM_ARCHS else RS_TOL
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=tol, atol=tol)
    _leaves_close(jg, pg, tol, arch)


def test_remat_gradients_match_reference():
    """``remat`` (``torch.utils.checkpoint`` around each layer) against the
    JAX package's ``jax.checkpoint``, and against no remat."""
    base = RC.get_spec("gemma2-2b").reduced
    cfg = dataclasses.replace(base, remat=True)
    init, _, jl, pl, batch = _case("gemma2-2b", cfg)
    jp, _ = rmodule.init_with_axes(init, jax.random.key(6), cfg)
    tp = _port(jp)
    (jloss, _), jg = jax.value_and_grad(jl, has_aux=True)(jp, batch)
    ploss, _, pg = pstep.loss_and_grads(pl, tp, batch)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=LM_TOL,
                               atol=LM_TOL)
    _leaves_close(jg, pg, LM_TOL, "remat")
    plain = _port_cfg(base)
    l2, _, g2 = pstep.loss_and_grads(
        lambda p, b: PT.lm_loss(p, plain, torch.as_tensor(b["tokens"]),
                                torch.as_tensor(b["labels"])), tp, batch)
    assert float(l2) == float(ploss)
    _leaves_close(popt.tree_map(lambda g: g.numpy(), g2), pg, 1e-6, "no remat")


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
@pytest.mark.parametrize("inplace", [False, True])
def test_apply_updates_matches_reference(kind, inplace):
    rng = np.random.default_rng(0)
    shapes = {"w": (7, 5), "b": (5,), "deep": {"e": (11, 3)}}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = ropt.OptConfig(lr=0.1, kind=kind, warmup_steps=2, total_steps=6,
                         clip_norm=2.0)
    pcfg = popt.OptConfig(**dataclasses.asdict(cfg))
    jp = jax.tree.map(jnp.asarray, params)
    js = ropt.init_opt_state(jp, cfg)
    tp = _port(params)
    ts = popt.init_opt_state(tp, pcfg)
    for i in range(4):
        g = jax.tree.map(lambda s: (3 * rng.normal(size=s)).astype(np.float32),
                         shapes, is_leaf=lambda x: isinstance(x, tuple))
        jp, js, jm = ropt.apply_updates(jp, jax.tree.map(jnp.asarray, g), js,
                                        cfg)
        tp2, ts2, tm = popt.apply_updates(tp, _port(g), ts, pcfg,
                                          inplace=inplace)
        if inplace:
            assert tp2["w"] is tp["w"] and ts2.mu["deep"]["e"] is \
                ts.mu["deep"]["e"] and ts2.step is ts.step
        tp, ts = tp2, ts2
        _leaves_close(jp, tp, OPT_TOL, f"params step {i}")
        _leaves_close(js.mu, ts.mu, OPT_TOL, f"mu step {i}")
        _leaves_close(js.nu, ts.nu, OPT_TOL, f"nu step {i}")
        assert int(ts.step) == int(js.step) == i + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=OPT_TOL, atol=0)
    if kind == "sgdm":
        assert all(float(x.abs().max()) == 0 for x in popt.tree_leaves(ts.nu))


@pytest.mark.parametrize("step", [0.0, 1.0, 5.0, 10.0, 11.0, 55.0, 100.0,
                                  150.0])
def test_schedule_matches_reference(step):
    """Warm-up, the peak, the cosine and the end."""
    cfg = ropt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_frac=0.1)
    pcfg = popt.OptConfig(**dataclasses.asdict(cfg))
    ref = float(ropt.schedule(cfg, jnp.asarray(step, jnp.float32)))
    got = float(popt.schedule(pcfg, torch.tensor(step)))
    assert got == pytest.approx(ref, rel=OPT_TOL, abs=1e-7)


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    ocfg = popt.OptConfig(lr=0.2, weight_decay=0.0, total_steps=200,
                          warmup_steps=0)
    st = popt.init_opt_state(params, ocfg)
    for _ in range(150):
        g = {"w": 2 * params["w"]}
        params, st, m = popt.apply_updates(params, g, st, ocfg)
    assert float(params["w"].abs().max()) < 0.1


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, gn = popt.clip_by_global_norm(g, 1.0)
    assert abs(float(popt.global_norm(clipped)) - 1.0) < 1e-5
    assert float(gn) > 1.0
    ref, rgn = ropt.clip_by_global_norm({"a": jnp.full((10,), 10.0)}, 1.0)
    np.testing.assert_array_equal(clipped["a"].numpy(), np.asarray(ref["a"]))
    assert float(gn) == float(rgn)


def test_bf16_params_update_like_reference():
    """bf16 parameters, f32 moments: the update in f32, rounded once."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=(64, 8)).astype(np.float32)
    g = (5 * rng.normal(size=(64, 8))).astype(np.float32)
    cfg = ropt.OptConfig(lr=0.05, warmup_steps=0, total_steps=10)
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    jg = {"w": jnp.asarray(g, jnp.bfloat16)}
    tp = {"w": torch.tensor(p).to(torch.bfloat16)}
    tg = {"w": torch.tensor(g).to(torch.bfloat16)}
    jp2, js, _ = ropt.apply_updates(jp, jg, ropt.init_opt_state(jp, cfg), cfg)
    tp2, ts, _ = popt.apply_updates(
        tp, tg, popt.init_opt_state(tp, popt.OptConfig(
            **dataclasses.asdict(cfg))), popt.OptConfig(
                **dataclasses.asdict(cfg)))
    assert tp2["w"].dtype == torch.bfloat16 and ts.mu["w"].dtype == \
        torch.float32
    ref = np.asarray(jp2["w"].astype(jnp.float32))
    got = tp2["w"].float().numpy()
    # within one bf16 ulp of the reference entry (an f32 value a hair from
    # a rounding boundary may round the other way)
    ulp = np.exp2(np.floor(np.log2(np.abs(ref))) - 7)
    assert (np.abs(got - ref) <= ulp).all()
    assert (got == ref).mean() >= 0.99


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def _run_steps(arch, kind, n=3):
    init, cfg, jl, pl, batch = _case(arch)
    # the JAX package's own smoke rates (tests/test_configs_smoke.py): an
    # LM's gradients agree to ~1e-5 of their scale (the reference init's
    # large attention logits), and a step moves a parameter by lr x that
    ocfg = ropt.OptConfig(lr={"sgdm": 1e-2, "adamw": 1e-3}[kind], kind=kind,
                          warmup_steps=1, total_steps=10)
    jp, _ = rmodule.init_with_axes(init, jax.random.key(7), cfg)
    tp = _port(jp)
    jstep = jax.jit(r_make_step(jl, ocfg))
    pstep_ = pstep.make_train_step(pl, popt.OptConfig(
        **dataclasses.asdict(ocfg)))
    js, ts = ropt.init_opt_state(jp, ocfg), popt.init_opt_state(
        tp, popt.OptConfig(**dataclasses.asdict(ocfg)))
    jl_, pl_ = [], []
    for _ in range(n):
        jp, js, jm = jstep(jp, js, batch)
        tp, ts, tm = pstep_(tp, ts, batch)
        jl_.append(float(jm["loss"]))
        pl_.append(float(tm["loss"]))
    return jp, tp, jl_, pl_


@pytest.mark.parametrize("arch", ["gemma2-2b", "dlrm-rm2", "gcn-cora"])
def test_sgdm_steps_match_reference(arch):
    jp, tp, jl, pl = _run_steps(arch, "sgdm")
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    for k, r in _flat(_np(jp)).items():
        np.testing.assert_allclose(_flat(tp)[k], r, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["gemma2-2b", "dlrm-rm2", "gcn-cora"])
def test_adamw_step_losses_match_reference(arch):
    _, _, jl, pl = _run_steps(arch, "adamw")
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["fm", "gemma2-2b"])
def test_microbatch_accumulation_matches_reference(arch):
    """microbatches=4 against 1 in the port, and against the JAX package's
    microbatched step."""
    init, cfg, jl, pl, batch = _case(arch, batch_rows=32 if arch == "fm"
                                     else 8)
    ocfg = ropt.OptConfig(lr=1e-3, total_steps=10)
    pcfg = popt.OptConfig(**dataclasses.asdict(ocfg))
    jp, _ = rmodule.init_with_axes(init, jax.random.key(8), cfg)
    tp = _port(jp)
    st = popt.init_opt_state(tp, pcfg)
    p1, _, m1 = pstep.make_train_step(pl, pcfg, donate=False)(tp, st, batch)
    p4, _, m4 = pstep.make_train_step(pl, pcfg, microbatches=4,
                                      donate=False)(tp, st, batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-5
    d = max(float((a - b).abs().max()) for a, b in
            zip(popt.tree_leaves(p1), popt.tree_leaves(p4)))
    assert d < 1e-5
    rp4, _, rm4 = jax.jit(r_make_step(jl, ocfg, microbatches=4))(
        jp, ropt.init_opt_state(jp, ocfg), batch)
    np.testing.assert_allclose(float(m4["loss"]), float(rm4["loss"]),
                               rtol=1e-5, atol=1e-5)
    for k, r in _flat(_np(rp4)).items():
        np.testing.assert_allclose(_flat(p4)[k], r, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_donate_updates_in_place_and_jit_refuses_shardings():
    init, cfg, jl, pl, batch = _case("fm")
    jp, _ = rmodule.init_with_axes(init, jax.random.key(9), cfg)
    tp = _port(jp)
    ocfg = popt.OptConfig(lr=1e-2, warmup_steps=0)
    st = popt.init_opt_state(tp, ocfg)
    w = tp["v"]
    before = w.clone()
    step = pstep.jit_train_step(pstep.make_train_step(pl, ocfg))
    p2, st2, _ = step(tp, st, batch)
    assert p2["v"] is w and not torch.equal(w, before)
    assert st2.step is st.step and int(st.step) == 1
    with pytest.raises(NotImplementedError, match="one device"):
        pstep.jit_train_step(step, in_shardings=({},))


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,block", [((1000,), 256), ((7, 33), 256),
                                         ((4, 64), 64), ((3,), 256)])
def test_quantize_dequantize_bits_match_reference(shape, block):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * rng.uniform(0.01, 100, size=shape)).astype(
        np.float32)
    x.reshape(-1)[:2] = 0.0           # an exact zero and a zero block's edge
    ry, re = rcomp.quantize_dequantize(jnp.asarray(x), block)
    py, pe = pcomp.quantize_dequantize(torch.as_tensor(x), block)
    np.testing.assert_array_equal(py.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(re))


def test_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = {"w": torch.as_tensor(rng.normal(size=(1000,)).astype(np.float32))}
    res = pcomp.init_residual(g)
    comp, res2 = pcomp.compress_tree(g, res)
    rel = float(torch.linalg.norm(g["w"] - comp["w"]) / torch.linalg.norm(
        g["w"]))
    assert rel < 0.02
    np.testing.assert_allclose((comp["w"] + res2["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-6, atol=1e-6)
    total_in, total_out = np.zeros(1000), np.zeros(1000)
    res = pcomp.init_residual(g)
    rres = rcomp.init_residual({"w": jnp.zeros(1000)})
    for _ in range(20):
        gi = rng.normal(size=(1000,)).astype(np.float32)
        comp, res = pcomp.compress_tree({"w": torch.as_tensor(gi)}, res)
        rcomp_, rres = rcomp.compress_tree({"w": jnp.asarray(gi)}, rres)
        np.testing.assert_array_equal(comp["w"].numpy(),
                                      np.asarray(rcomp_["w"]))
        total_in += gi
        total_out += comp["w"].numpy()
    err = np.linalg.norm(total_in - total_out) / np.linalg.norm(total_in)
    assert err < 0.05


def test_compress_hook_in_the_train_step():
    init, cfg, jl, pl, batch = _case("wide-deep")
    jp, _ = rmodule.init_with_axes(init, jax.random.key(10), cfg)
    ocfg = ropt.OptConfig(lr=0.05, kind="sgdm", warmup_steps=1)

    def rhook(g):
        return rcomp.compress_tree(g, rcomp.init_residual(g))[0]

    def phook(g):
        return pcomp.compress_tree(g, pcomp.init_residual(g))[0]
    rp, _, _ = jax.jit(r_make_step(jl, ocfg, compress=rhook))(
        jp, ropt.init_opt_state(jp, ocfg), batch)
    pcfg = popt.OptConfig(**dataclasses.asdict(ocfg))
    tp = _port(jp)
    pp, _, _ = pstep.make_train_step(pl, pcfg, compress=phook)(
        tp, popt.init_opt_state(tp, pcfg), batch)
    _leaves_close(rp, pp, 1e-5, "compressed step")


# ---------------------------------------------------------------------------
# Checkpoint
# ---------------------------------------------------------------------------
def _state_tree(rng):
    return {"params": {"w": rng.normal(size=(2, 3)).astype(np.float32),
                       "h": rng.normal(size=(4,)).astype(np.float32)},
            "opt": (np.asarray(3, np.int32),
                    {"w": np.ones((2, 3), np.float32)},
                    {"w": np.zeros((2, 3), np.float32)}),
            "step": 7}


def test_reference_checkpoint_restores_in_port(tmp_path):
    rng = np.random.default_rng(0)
    tree = _state_tree(rng)
    tree["params"]["bf"] = jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16)
    d = str(tmp_path / "ck")
    rckpt.save(d, 7, tree)
    out, meta = pckpt.restore(d)
    assert meta["step"] == 7
    ref, _ = rckpt.restore(d)
    for k, v in _flat_np(ref).items():
        assert _flat_np(out)[k].dtype == v.dtype
        np.testing.assert_array_equal(
            _flat_np(out)[k].reshape(-1).view(np.uint8),
            v.reshape(-1).view(np.uint8))
    # onto a device: OptState back as an OptState, bf16 by its bits
    template = {"params": {k: torch.zeros(1) for k in ("w", "h", "bf")},
                "opt": popt.OptState(torch.zeros(()), {"w": torch.zeros(1)},
                                     {"w": torch.zeros(1)}),
                "step": 0}
    on, _ = pckpt.restore(d, shardings=pckpt.device_tree(template))
    assert isinstance(on["opt"], popt.OptState) and int(on["opt"].step) == 3
    assert on["step"] == 7 and isinstance(on["step"], int)
    assert on["params"]["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        on["params"]["bf"].float().numpy(),
        np.asarray(tree["params"]["bf"].astype(jnp.float32)))
    np.testing.assert_array_equal(on["params"]["w"].numpy(),
                                  tree["params"]["w"])


def _flat_np(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_np(v, f"{prefix}#{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_port_checkpoint_restores_in_reference(tmp_path):
    rng = np.random.default_rng(1)
    tree = _state_tree(rng)
    tp = {"params": _port(tree["params"]),
          "opt": popt.OptState(torch.tensor(3, dtype=torch.int32),
                               {"w": torch.ones(2, 3)},
                               {"w": torch.zeros(2, 3)}),
          "step": 7}
    tp["params"]["bf"] = torch.tensor([1.5, -2.25, 3.0e-3]).to(torch.bfloat16)
    d = str(tmp_path / "ck")
    t = pckpt.save_async(d, 7, tp)
    t.join(timeout=60)
    assert not t.is_alive()
    out, meta = rckpt.restore(d)
    assert meta["step"] == 7 and int(out["step"]) == 7
    np.testing.assert_array_equal(out["params"]["w"], tree["params"]["w"])
    assert out["opt"][0].dtype == np.int32 and int(out["opt"][0]) == 3
    bf = jax.device_put(out["params"]["bf"].view(np.uint16)).view(
        jnp.bfloat16) if out["params"]["bf"].dtype.kind == "V" else None
    np.testing.assert_array_equal(
        np.asarray(bf.astype(jnp.float32)),
        tp["params"]["bf"].float().numpy())


def test_checkpoint_retention_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        pckpt.save(d, s, {"x": torch.tensor([s])}, keep=2)
    assert pckpt.latest_step(d) == 5
    assert sorted(pckpt._complete_steps(d)) == [4, 5]
    assert sorted(rckpt._complete_steps(d)) == [4, 5]


def test_checkpoint_atomic_no_partial(tmp_path):
    """A .tmp dir (a crash mid-save) is not a checkpoint."""
    d = str(tmp_path / "ck")
    pckpt.save(d, 1, {"x": np.asarray([1])})
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert pckpt.latest_step(d) == 1
    with pytest.raises(FileNotFoundError):
        pckpt.restore(str(tmp_path / "empty"))


def test_fault_tolerant_loop_resumes(tmp_path):
    d = str(tmp_path / "ck")

    def step_fn(state, batch):
        state["params"]["w"] = state["params"]["w"] + batch["x"].sum()
        return state, {"loss": torch.tensor(1.0)}

    def data_iter(s):
        return {"x": torch.tensor([1.0])}, s + 1

    def fresh():
        return {"params": {"w": torch.tensor(0.0)}, "opt": {},
                "data_state": 0, "step": 0}
    logs = []
    st, m, wd = pft.run_loop(step_fn, fresh(), data_iter, n_steps=10,
                             ckpt_dir=d, save_every=4, log=logs.append)
    assert float(st["params"]["w"]) == 10.0
    st2, _, _ = pft.run_loop(step_fn, fresh(), data_iter, n_steps=12,
                             ckpt_dir=d, save_every=4, log=logs.append)
    assert any("resumed" in line for line in logs)
    assert float(st2["params"]["w"]) == 12.0       # 8 from ckpt + 4 more
    assert torch.is_tensor(st2["params"]["w"]) and st2["data_state"] == 12


def test_straggler_watchdog():
    wd = pft.StragglerWatchdog(threshold=2.0)
    for _ in range(10):
        wd.record(0.1)
    assert wd.record(0.5) is True
    assert wd.slow_steps == 1
    assert wd.record(0.1) is False


def test_preemption_guard_saves_and_exits(tmp_path):
    d = str(tmp_path / "ck")
    guard = pft.PreemptionGuard(signals=())
    guard.requested = True
    state = {"params": {"w": torch.tensor(0.0)}, "data_state": 0, "step": 0}
    st, _, _ = pft.run_loop(lambda s, b: (s, {"loss": torch.tensor(0.0)}),
                            state, lambda s: ({}, s + 1), n_steps=5,
                            ckpt_dir=d, log=lambda line: None, guard=guard)
    assert st["step"] == 1 and pckpt.latest_step(d) == 1


# ---------------------------------------------------------------------------
# Serving builds no autograd graph
# ---------------------------------------------------------------------------
def test_serving_builds_no_autograd_graph():
    lm_cfg = PC.get_spec("olmoe-1b-7b").reduced
    lm = PT.LanguageModel(lm_cfg, device="cpu")
    toks = torch.randint(0, lm_cfg.vocab, (2, 8))
    logits, aux = lm(toks)
    assert not logits.requires_grad
    lg, caches = lm.prefill(toks, 12)
    lg2, _ = lm.decode_step(lg.argmax(-1)[:, None], caches, 8)
    assert not (lg.requires_grad or lg2.requires_grad or
                caches["k"].requires_grad)
    loss, _ = PT.lm_loss(lm.tree(), lm_cfg, toks, toks)
    assert not loss.requires_grad
    for arch in RS_ARCHS:
        cfg = PC.get_spec(arch).reduced
        model = {"fm": PR.FM, "wide-deep": PR.WideDeep, "dien": PR.DIEN,
                 "dlrm-rm2": PR.DLRM}[arch](cfg, device="cpu")
        b = _rs_batch(arch, RC.get_spec(arch).reduced, 8)
        out = model(*[torch.as_tensor(b[k]) for k in _rs_keys(arch)])
        assert out.shape == (8,) and not out.requires_grad
    gcfg = PC.get_spec("gcn-cora").reduced
    g = rsyn.make_random_graph(50, 120, gcfg.d_feat, gcfg.n_classes, seed=0)
    out = PG.GCN(gcfg, device="cpu")(*[torch.as_tensor(g[k]) for k in
                                      ("x", "edges", "deg")])
    assert not out.requires_grad
    # leaves that require grad (the train step's) build one; serving
    # stays off it
    served = PT.LanguageModel(lm_cfg, params=lm.tree(), device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
    leaves = popt.tree_map(lambda p: p.detach().requires_grad_(),
                            lm.tree())
    logits, _ = PT.forward_train(leaves, lm_cfg, toks)
    assert logits.requires_grad
    lg, _ = PT.prefill(leaves, lm_cfg, toks, 12)
    assert not lg.requires_grad


@pytest.mark.parametrize("module,names", [
    ("checkpoint", ["_flatten", "_unflatten", "_retain", "_complete_steps",
                    "latest_step"]),
    ("fault_tolerance", ["PreemptionGuard", "StragglerWatchdog"]),
    ("optimizer", ["OptConfig"]),
])
def test_host_code_is_a_copy_of_the_reference(module, names):
    """The numpy-only pieces of ``training/`` are the JAX package's code."""
    import importlib
    import inspect
    ref = importlib.import_module(f"repro.training.{module}")
    port = importlib.import_module(f"repro_torch.training.{module}")
    for name in names:
        assert inspect.getsource(getattr(port, name)) == \
            inspect.getsource(getattr(ref, name)), name
