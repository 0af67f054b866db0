"""Port parity, the model zoo's transformer side: ``repro_torch.models``
(module, layers, attention, moe, transformer) and the config registry
against the JAX package's, on the reduced configs.

The JAX parameters come from the JAX package's ``init_with_axes`` and cross
with ``repro_torch.convert.params_from_reference``; the inputs are numpy
from a seed.  The JAX package's ``Ctx.scope`` seeds each scope with the
per-process salted ``hash(name)``, so its weights change from run to run;
the tests pin it to ``zlib.crc32`` inside the reference module (its code is
untouched) so every run sees the same weights.  Bars: f32 logits, losses
and metrics rtol = atol = 1e-4; the bf16 KV caches within 1e-5 plus one
bf16 ulp (an f32 key 1e-6 from a rounding boundary of bf16 may round the
other way; >= 99 % of entries are bit-equal); chunked attention
1e-5; MoE routing ``top_i`` identical wherever the router probabilities
are apart by more than 1e-6, ``dropped_frac`` identical, the aux losses and
the block's output 1e-5; every registry spec equal field by field."""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.models.module as rmodule  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
import repro_torch.configs as PC  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import module as pmodule  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

LM_ARCHS = ["olmoe-1b-7b", "arctic-480b", "qwen1.5-32b",
            "command-r-plus-104b", "gemma2-2b"]
TOL = 1e-4
TIGHT = 1e-5
BF16_MANTISSA = 7      # explicit mantissa bits of bfloat16
FOLD_3_LAYERS = 5917109122498752240   # fold(3, crc32(b"layers")), pinned


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


def _ref_params(init_fn, cfg, seed=0):
    params, _ = rmodule.init_with_axes(init_fn, jax.random.key(seed), cfg)
    return params, params_from_reference(jax.tree.map(np.asarray, params),
                                         device="cpu")


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=tol, atol=tol)


def _cache_close(ref, port):
    """bf16 caches: within 1e-5 plus one bf16 ulp of the reference entry."""
    ref = np.asarray(ref.astype(jnp.float32), np.float64)
    port = port.float().numpy().astype(np.float64)
    with np.errstate(divide="ignore"):
        ulp = np.exp2(np.floor(np.log2(np.abs(ref))) - BF16_MANTISSA)
    assert (np.abs(port - ref) <= TIGHT + ulp).all()
    assert (ref == port).mean() >= 0.99


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(RC.all_specs()))
def test_spec_equals_reference(arch):
    ref, port = RC.get_spec(arch), PC.get_spec(arch)
    for field in ("arch_id", "family", "source", "notes"):
        assert getattr(port, field) == getattr(ref, field)
    for field in ("config", "reduced"):
        r, p = getattr(ref, field), getattr(port, field)
        assert type(p).__name__ == type(r).__name__
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert [dataclasses.asdict(c) for c in port.cells] == \
        [dataclasses.asdict(c) for c in ref.cells]
    if port.family == "lm":
        assert port.config.param_count() == ref.config.param_count()
        assert (port.config.active_param_count()
                == ref.config.active_param_count())
        assert port.reduced.windows().tolist() == \
            np.asarray(ref.reduced.windows()).tolist()
    assert PC.ASSIGNED == RC.ASSIGNED


def test_module_helpers_match_reference():
    cfg = PC.get_spec("olmoe-1b-7b").reduced
    params, axes = pmodule.init_with_axes(PT.init_lm, 3, cfg, device="cpu")
    rparams, raxes = rmodule.init_with_axes(
        RT.init_lm, jax.random.key(3), RC.get_spec("olmoe-1b-7b").reduced)
    assert jax.tree.map(lambda a: a.shape, rparams) == \
        _tree_map(lambda t: tuple(t.shape), params)
    assert raxes == axes
    assert pmodule.param_count(params) == rmodule.param_count(rparams)
    assert pmodule.param_bytes(params) == rmodule.param_bytes(rparams)
    for a in ("embed", "vocab", "batch", "experts", None, "nope"):
        ref = rmodule.spec_for_axes((a,), rmodule.DEFAULT_RULES)
        assert pmodule.spec_for_axes((a,), pmodule.DEFAULT_RULES) \
            == tuple(ref)
    x = torch.ones(2)
    assert pmodule.constrain(x, None, "batch") is x
    # the same seed gives the same weights, in every process (the scope
    # seeds come from a stable hash, not the salted ``hash(name)``)
    again, _ = pmodule.init_with_axes(PT.init_lm, 3, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(_leaves(params), _leaves(again)))
    assert pmodule.fold(3, zlib.crc32(b"layers")) == FOLD_3_LAYERS


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PC.get_spec("qwen1.5-32b").reduced
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmodule.init_with_axes(PT.init_lm, 0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.LanguageModel(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference({"w": np.ones(3, np.float32)})
    lm = PT.LanguageModel(cfg, device="cpu")
    assert next(lm.parameters()).device.type == "cpu"


def test_params_from_reference_keeps_bf16_bits():
    """A bf16 tree (the full configs' ``param_dtype``) crosses by its bits;
    ``dtype=`` casts every leaf."""
    ref = {"a": {"w": jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)
                                  .reshape(3, 4), jnp.bfloat16)},
           "b": np.arange(5, dtype=np.int32)}
    got = params_from_reference(jax.tree.map(np.asarray, ref), device="cpu")
    assert got["a"]["w"].dtype == torch.bfloat16
    assert np.array_equal(got["a"]["w"].float().numpy(),
                          np.asarray(ref["a"]["w"].astype(jnp.float32)))
    assert got["b"].dtype == torch.int32
    cast = params_from_reference(ref, device="cpu", dtype=torch.float32)
    assert cast["a"]["w"].dtype == cast["b"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The five LM architectures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_matches_reference(arch):
    rcfg = RC.get_spec(arch).reduced
    pcfg = PC.get_spec(arch).reduced
    jp, tp = _ref_params(RT.init_lm, rcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, rcfg.vocab, size=(2, 12)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    tt, tl = torch.as_tensor(toks), torch.as_tensor(labels)

    lj, auxj = jax.jit(lambda p, t: RT.forward_train(p, rcfg, t))(jp, toks)
    lt, auxt = PT.forward_train(tp, pcfg, tt)
    _close(lj, lt)
    assert set(auxt) == set(auxj)
    for k in auxj:
        if k == "dropped_frac":
            assert float(auxt[k]) == float(auxj[k])
        else:
            _close(auxj[k], auxt[k])

    (loss_j, mj) = jax.jit(lambda p, t, y: RT.lm_loss(p, rcfg, t, y))(
        jp, toks, labels)
    loss_t, mt = PT.lm_loss(tp, pcfg, tt, tl)
    _close(loss_j, loss_t)
    assert set(mt) == set(mj)
    for k in mj:
        _close(mj[k], mt[k])

    pj, cj = jax.jit(lambda p, t: RT.prefill(p, rcfg, t, 16))(jp, toks)
    pt, ct = PT.prefill(tp, pcfg, tt, 16)
    _close(pj, pt)
    assert {k: v.shape for k, v in cj.items()} == \
        {k: tuple(v.shape) for k, v in ct.items()}
    spec = PT.make_cache_specs(pcfg, 2, 16)
    ref_spec = RT.make_cache_specs(rcfg, 2, 16)
    assert {k: (s.shape, str(s.dtype)) for k, s in ref_spec.items()} == \
        {k: (shape, str(dt).removeprefix("torch.")) for k, (shape, dt)
         in spec.items()}
    for k in ("k", "v"):
        assert ct[k].dtype == torch.bfloat16
        _cache_close(cj[k], ct[k])

    nxt = np.asarray(jnp.argmax(pj, -1))[:, None].astype(np.int32)
    dj, cj2 = jax.jit(lambda p, t, c: RT.decode_step(
        p, rcfg, t, c, jnp.asarray(12)))(jp, nxt, cj)
    k_before = ct["k"]
    dt, ct2 = PT.decode_step(tp, pcfg, torch.as_tensor(nxt), ct, 12)
    assert ct2["k"] is k_before                 # written in place
    _close(dj, dt)
    for k in ("k", "v"):
        _cache_close(cj2[k], ct2[k])

    # the nn.Module carries the same tree: named_parameters are its paths
    lm = PT.LanguageModel(pcfg, device="cpu", seed=5)
    lm.load_state_dict(pmodule.ParamModule(tp).state_dict())
    names = {n for n, _ in lm.named_parameters()}
    assert "layers.attn.wq" in names and "embed" in names
    assert torch.equal(lm(tt)[0], lt)
    assert torch.equal(lm.prefill(tt, 16)[0], pt)


def test_chunked_attention_matches_reference():
    """The flash-style chunked path (a loop over KV chunks carrying f32
    running statistics) against the JAX package's ``lax.scan`` on the same
    q / k / v, with a sliding window and a softcap, at 1e-5, and against
    the port's unchunked ``attend``; through the projections and RoPE
    (``attention_train``, whose einsums round on their own) at the LM's
    1e-4."""
    rcfg = RA.AttnConfig(d_model=32, n_heads=4, n_kv=2, head_dim=16,
                         qkv_bias=True, attn_softcap=50.0)
    pcfg = PA.AttnConfig(**dataclasses.asdict(rcfg))
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    pos = torch.arange(24, dtype=torch.int32)
    jp, tp = _ref_params(RA.init_attention, rcfg, seed=2)
    x = rng.normal(size=(2, 24, 32)).astype(np.float32)
    for window in (0, 5):
        oj = jax.jit(lambda q, k, v: RA.attend_chunked(
            q, k, v, jnp.asarray(window, jnp.int32), rcfg, 8))(q, k, v)
        ot = PA.attend_chunked(tq, tk, tv, window, pcfg, 8)
        _close(oj, ot, TIGHT)
        full = PA.attend(tq, tk, tv, PA._scores_mask(pos, pos, window), pcfg)
        _close(full, ot, TIGHT)

        aj, (kj, _) = jax.jit(lambda p, x: RA.attention_train(
            p, x, rcfg, jnp.asarray(window, jnp.int32), chunk=8))(jp, x)
        at, (kt, _) = PA.attention_train(tp, torch.as_tensor(x), pcfg, window,
                                         chunk=8)
        _close(aj, at)
        _close(kj, kt, TIGHT)

    # through the LM: attn_chunk > 0 in forward_train
    rl = dataclasses.replace(RC.get_spec("gemma2-2b").reduced, attn_chunk=4)
    pl = dataclasses.replace(PC.get_spec("gemma2-2b").reduced, attn_chunk=4)
    jp, tp = _ref_params(RT.init_lm, rl, seed=6)
    toks = np.random.default_rng(7).integers(0, rl.vocab, size=(2, 16))
    lj, _ = jax.jit(lambda p, t: RT.forward_train(p, rl, t))(
        jp, toks.astype(np.int32))
    lt, _ = PT.forward_train(tp, pl, torch.as_tensor(toks))
    _close(lj, lt)


def test_fully_masked_rows_match_reference():
    """NEG (not -inf) keeps a fully masked row finite and uniform, as in
    the reference."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((1, 3, 4, 8), (1, 5, 2, 8), (1, 5, 2, 8)))
    mask = np.zeros((3, 5), bool)
    mask[1, :2] = True
    rcfg = RA.AttnConfig(d_model=32, n_heads=4, n_kv=2, head_dim=8)
    pcfg = PA.AttnConfig(**dataclasses.asdict(rcfg))
    oj = RA.attend(q, k, v, mask, rcfg)
    ot = PA.attend(*(torch.as_tensor(a) for a in (q, k, v, mask)), pcfg)
    assert torch.isfinite(ot).all()
    _close(oj, ot, TIGHT)


# ---------------------------------------------------------------------------
# MoE routing and dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,k,t,cf", [(4, 2, 24, 1.25), (8, 2, 100, 0.5),
                                      (64, 8, 40, 1.25), (16, 4, 333, 1.0)])
def test_moe_matches_reference(e, k, t, cf):
    rcfg = RM.MoEConfig(n_experts=e, top_k=k, d_model=32, d_ff=24,
                        capacity_factor=cf, dense_residual=e == 4)
    pcfg = PM.MoEConfig(**dataclasses.asdict(rcfg))
    assert PM.moe_capacity(t, pcfg) == RM.moe_capacity(t, rcfg)
    jp, tp = _ref_params(RM.init_moe, rcfg, seed=e)
    x = np.random.default_rng(t).normal(size=(t, 32)).astype(np.float32)
    yj, auxj = jax.jit(lambda p, x: RM.apply_moe(p, x, rcfg))(jp, x)
    yt, auxt = PM.apply_moe(tp, torch.as_tensor(x), pcfg)
    _close(yj, yt, TIGHT)
    assert float(auxt["dropped_frac"]) == float(auxj["dropped_frac"])
    for name in ("lb_loss", "z_loss"):
        _close(auxj[name], auxt[name], TIGHT)

    # routing: top_i identical wherever the probabilities are apart
    pj = jax.nn.softmax((x @ np.asarray(jp["router"])).astype(np.float32), -1)
    _, ij = jax.lax.top_k(pj, k)
    pt = torch.softmax(torch.as_tensor(x) @ tp["router"], -1)
    _, it = PM.stable_top_k(pt, k)
    srt = np.sort(np.asarray(pj), axis=-1)[:, ::-1]
    apart = np.abs(np.diff(srt[:, :k + 1], axis=-1)).min(-1) > 1e-6
    assert apart.mean() > 0.5
    assert np.array_equal(np.asarray(ij)[apart], it.numpy()[apart])


def test_moe_ties_break_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    _, idx = PM.stable_top_k(probs, 2)
    _, ref = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ref).tolist() == [[0, 1], [1, 2]]
