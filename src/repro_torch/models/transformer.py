"""Decoder-only LM covering the five assigned transformer architectures.

Config-driven features: GQA (any n_kv), QKV bias (qwen1.5), attention/final
logit softcaps + post-norms + embedding scaling + local/global alternating
sliding windows (gemma2), MoE with top-k routing (olmoe) and dense-residual
MoE (arctic), tied/untied embeddings.

Layer weights are stacked (L, ...) tensors, as in the JAX package, so its
parameter tree carries across one to one; the layers run as a Python loop
that indexes the stacks.  ``remat`` and ``unroll_layers`` stay fields of
the config (specs compare equal across the packages) and do nothing here:
the port serves, it does not train.

Two quirks of the reference are kept: ``forward_train`` casts the embedded
activations to the param dtype and ``prefill`` does not, and the KV caches
are stored as bf16 whatever the activations' dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .attention import AttnConfig, attention_decode, attention_train
from .layers import apply_mlp, apply_norm, softcap
from .module import (Ctx, ParamModule, constrain, fan_in_init, init_with_axes,
                     normal_init, ones_init, zeros_init)
from .moe import MoEConfig, apply_moe

CACHE_DTYPE = torch.bfloat16


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    local_window: int = 0             # sliding window for local layers
    layer_pattern: str = "global"     # "global" | "local_global"
    post_norms: bool = False          # gemma2 post-attn/post-mlp norms
    gemma_norm: bool = False          # (1 + scale) RMSNorm
    embed_scale: bool = False         # x *= sqrt(d_model)
    tie_embeddings: bool = True
    moe: MoEConfig | None = None
    remat: bool = True                # training only (not ported)
    param_dtype: str = "float32"
    unroll_layers: bool = False       # dry-run only (not ported)
    attn_chunk: int = 0               # >0: flash-style chunked attention

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv, self.hd,
                          self.qkv_bias, self.attn_softcap, self.rope_theta)

    def windows(self) -> torch.Tensor:
        if self.layer_pattern == "local_global":
            w = [self.local_window if i % 2 == 0 else 0
                 for i in range(self.n_layers)]
        else:
            w = [self.local_window] * self.n_layers
        return torch.tensor(w, dtype=torch.int32)

    def param_count(self) -> int:
        d, ff, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        h, kv, hd = self.n_heads, self.n_kv, self.hd
        attn = d * h * hd * 2 + d * kv * hd * 2
        if self.moe:
            m = self.moe
            mlp = d * m.n_experts + m.n_experts * 3 * d * m.d_ff
            if m.dense_residual:
                mlp += 3 * d * (m.d_ff_dense or m.d_ff)
        else:
            mlp = 3 * d * ff
        emb = v * d * (1 if self.tie_embeddings else 2)
        return L * (attn + mlp) + emb

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        h, kv, hd = self.n_heads, self.n_kv, self.hd
        m = self.moe
        attn = d * h * hd * 2 + d * kv * hd * 2
        mlp = d * m.n_experts + m.top_k * 3 * d * m.d_ff
        if m.dense_residual:
            mlp += 3 * d * (m.d_ff_dense or m.d_ff)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return L * (attn + mlp) + emb


# ---------------------------------------------------------------------------
# Init (stacked layers: every layer weight carries a leading (L,) axis)
# ---------------------------------------------------------------------------
def init_lm(ctx: Ctx, cfg: LMConfig):
    L, d = cfg.n_layers, cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    norm_init = zeros_init() if cfg.gemma_norm else ones_init()
    zeros = zeros_init()
    ctx.param("embed", (cfg.vocab, d), ("vocab", "embed"), normal_init(0.02))
    if not cfg.tie_embeddings:
        ctx.param("lm_head", (d, cfg.vocab), ("embed", "vocab"), normal_init(0.02))

    lyr = ctx.scope("layers")
    lyr.param("pre_attn_norm", (L, d), ("layers", "embed"), norm_init)
    lyr.param("pre_mlp_norm", (L, d), ("layers", "embed"), norm_init)
    if cfg.post_norms:
        lyr.param("post_attn_norm", (L, d), ("layers", "embed"), norm_init)
        lyr.param("post_mlp_norm", (L, d), ("layers", "embed"), norm_init)
    if cfg.norm == "layernorm":
        lyr.param("pre_attn_bias", (L, d), ("layers", "embed"), zeros)
        lyr.param("pre_mlp_bias", (L, d), ("layers", "embed"), zeros)

    att = lyr.scope("attn")
    att.param("wq", (L, d, h, hd), ("layers", "embed", "heads", "head_dim"), fan_in_init())
    att.param("wk", (L, d, kv, hd), ("layers", "embed", "kv_heads", "head_dim"), fan_in_init())
    att.param("wv", (L, d, kv, hd), ("layers", "embed", "kv_heads", "head_dim"), fan_in_init())
    att.param("wo", (L, h, hd, d), ("layers", "heads", "head_dim", "embed"), fan_in_init())
    if cfg.qkv_bias:
        att.param("bq", (L, h, hd), ("layers", "heads", "head_dim"), zeros)
        att.param("bk", (L, kv, hd), ("layers", "kv_heads", "head_dim"), zeros)
        att.param("bv", (L, kv, hd), ("layers", "kv_heads", "head_dim"), zeros)

    if cfg.moe:
        m = cfg.moe
        mo = lyr.scope("moe")
        mo.param("router", (L, d, m.n_experts), ("layers", "embed", "experts"),
                 normal_init(0.02))
        mo.param("wi_gate", (L, m.n_experts, d, m.d_ff),
                 ("layers", "experts", "embed", "expert_mlp"), fan_in_init())
        mo.param("wi_up", (L, m.n_experts, d, m.d_ff),
                 ("layers", "experts", "embed", "expert_mlp"), fan_in_init())
        mo.param("wo", (L, m.n_experts, m.d_ff, d),
                 ("layers", "experts", "expert_mlp", "embed"), fan_in_init())
        if m.dense_residual:
            dff = m.d_ff_dense or m.d_ff
            mo.param("dense_gate", (L, d, dff), ("layers", "embed", "mlp"), fan_in_init())
            mo.param("dense_up", (L, d, dff), ("layers", "embed", "mlp"), fan_in_init())
            mo.param("dense_down", (L, dff, d), ("layers", "mlp", "embed"), fan_in_init())
    else:
        ml = lyr.scope("mlp")
        ml.param("gate", (L, d, cfg.d_ff), ("layers", "embed", "mlp"), fan_in_init())
        ml.param("up", (L, d, cfg.d_ff), ("layers", "embed", "mlp"), fan_in_init())
        ml.param("down", (L, cfg.d_ff, d), ("layers", "mlp", "embed"), fan_in_init())

    ctx.param("final_norm", (d,), ("embed",), norm_init)


def _norm(cfg, scale, bias, x):
    p = {"scale": scale}
    if bias is not None:
        p["bias"] = bias
    return apply_norm(p, x, cfg.norm, cfg.norm_eps, gemma_style=cfg.gemma_norm)


def _layer_params(tree, i: int):
    """Layer ``i``'s slice of the stacked (L, ...) layer tree (views)."""
    return {k: (_layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _layers(params, cfg: LMConfig):
    """(layer params, window) for each layer in order."""
    return [(_layer_params(params["layers"], i), w)
            for i, w in enumerate(cfg.windows().tolist())]


# ---------------------------------------------------------------------------
# Layer body (used by train/prefill/decode)
# ---------------------------------------------------------------------------
def _layer(cfg: LMConfig, lp: dict, h, window: int, mesh, decode_state=None):
    """One transformer layer.  decode_state = (cache_k, cache_v, pos) or None.
    Returns (h, aux, new_caches_or_kv)."""
    bias_a = lp.get("pre_attn_bias")
    bias_m = lp.get("pre_mlp_bias")
    x = _norm(cfg, lp["pre_attn_norm"], bias_a, h)
    if decode_state is None:
        attn_out, kvs = attention_train(lp["attn"], x, cfg.attn_cfg, window,
                                        chunk=cfg.attn_chunk)
        new_cache = kvs
    else:
        ck, cv, pos = decode_state
        attn_out, ck, cv = attention_decode(lp["attn"], x, ck, cv, pos,
                                            cfg.attn_cfg, window)
        new_cache = (ck, cv)
    if cfg.post_norms:
        attn_out = _norm(cfg, lp["post_attn_norm"], None, attn_out)
    h = h + attn_out
    h = constrain(h, mesh, "batch", "seq", "embed")

    x = _norm(cfg, lp["pre_mlp_norm"], bias_m, h)
    aux = {}
    if cfg.moe:
        mlp_out, aux = apply_moe(lp["moe"], x, cfg.moe)
    else:
        mlp_out = apply_mlp(lp["mlp"], x)
    if cfg.post_norms:
        mlp_out = _norm(cfg, lp["post_mlp_norm"], None, mlp_out)
    h = h + mlp_out
    h = constrain(h, mesh, "batch", "seq", "embed")
    return h, aux, new_cache


def _embed(params, cfg: LMConfig, tokens):
    h = params["embed"][tokens]
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    return h


def _logits(params, cfg: LMConfig, h):
    h = _norm(cfg, params["final_norm"], None, h)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", h, params["embed"])
    else:
        logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"])
    return softcap(logits.float(), cfg.final_softcap)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
@torch.no_grad()
def forward_train(params, cfg: LMConfig, tokens, mesh=None):
    """tokens (B, S) -> logits (B, S, V) f32 + moe aux dict."""
    h = _embed(params, cfg, tokens).to(
        torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32)
    h = constrain(h, mesh, "batch", "seq", "embed")
    aux = ({"lb_loss": 0.0, "z_loss": 0.0, "dropped_frac": 0.0}
           if cfg.moe else {})
    for lp, window in _layers(params, cfg):
        h, a, _ = _layer(cfg, lp, h, window, mesh)
        if a:
            aux = {k: aux[k] + a[k] for k in aux}
    if cfg.moe:
        aux = {k: v / cfg.n_layers for k, v in aux.items()}
    return _logits(params, cfg, h), aux


@torch.no_grad()
def lm_loss(params, cfg: LMConfig, tokens, labels, mesh=None,
            lb_coef: float = 0.01, z_coef: float = 1e-3):
    """Next-token cross entropy (labels = tokens shifted by caller; -1 pads)."""
    logits, aux = forward_train(params, cfg, tokens, mesh)
    valid = labels >= 0
    lbl = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, lbl[..., None])[..., 0]
    loss = torch.sum(nll * valid) / torch.clamp(valid.sum(), min=1)
    metrics = {"ce_loss": loss}
    if cfg.moe:
        loss = loss + lb_coef * aux["lb_loss"] + z_coef * aux["z_loss"]
        metrics.update(aux)
    return loss, metrics


@torch.no_grad()
def prefill(params, cfg: LMConfig, tokens, cache_len: int, mesh=None):
    """tokens (B, S) -> (logits (B, V) f32 last position, caches
    {k, v} (L, B, cache_len, kv, hd) bf16, zero past S)."""
    b, s = tokens.shape
    h = _embed(params, cfg, tokens)
    h = constrain(h, mesh, "batch", "seq", "embed")
    specs = make_cache_specs(cfg, b, cache_len)
    caches = {name: torch.zeros(shape, dtype=dtype, device=h.device)
              for name, (shape, dtype) in specs.items()}
    for i, (lp, window) in enumerate(_layers(params, cfg)):
        h, _, (k, v) = _layer(cfg, lp, h, window, mesh)
        caches["k"][i, :, :s] = k.to(CACHE_DTYPE)
        caches["v"][i, :, :s] = v.to(CACHE_DTYPE)
    logits = _logits(params, cfg, h[:, -1:, :])[:, 0]
    return logits, caches


@torch.no_grad()
def decode_step(params, cfg: LMConfig, token, caches, pos: int, mesh=None):
    """One-token decode.  token (B, 1); caches {k,v} (L, B, S, kv, hd), written
    in place at ``pos`` (an int).  Returns (logits (B, V) f32, caches)."""
    pos = int(pos)
    h = _embed(params, cfg, token)
    for i, (lp, window) in enumerate(_layers(params, cfg)):
        h, _, _ = _layer(cfg, lp, h, window, mesh,
                         decode_state=(caches["k"][i], caches["v"][i], pos))
    logits = _logits(params, cfg, h)[:, 0]
    return logits, caches


def make_cache_specs(cfg: LMConfig, batch: int, cache_len: int) -> dict:
    """{name: (shape, dtype)} of the KV caches."""
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv, cfg.hd)
    return {"k": (shape, CACHE_DTYPE), "v": (shape, CACHE_DTYPE)}


class LanguageModel(ParamModule):
    """The LM as an ``nn.Module``: its parameters are the param tree's paths
    (``layers.attn.wq``, ...).  Without ``params`` it initializes them from
    ``seed`` on ``device`` (None = the CUDA device) in ``dtype``."""

    def __init__(self, cfg: LMConfig, params: dict | None = None, *,
                 seed: int = 0, dtype=torch.float32, device=None):
        if params is None:
            params, _ = init_with_axes(init_lm, seed, cfg, dtype=dtype,
                                       device=device)
        super().__init__(params)
        self.cfg = cfg

    def forward(self, tokens):
        return forward_train(self.tree(), self.cfg, tokens)

    def prefill(self, tokens, cache_len: int):
        return prefill(self.tree(), self.cfg, tokens, cache_len)

    def decode_step(self, token, caches, pos: int):
        return decode_step(self.tree(), self.cfg, token, caches, pos)
