"""GQA attention with RoPE, QKV-bias, logit softcap, sliding windows, and a
KV-cache decode path, in plain torch.

Layer-type selection (gemma2 local/global alternation) is arithmetic: each
layer carries a scalar ``window`` (0 = global).  Masked logits take
``NEG = -2e38``, not -inf, so a fully masked row softmaxes to a uniform row
as in the reference; the softmax runs in f32 and casts back to the query's
dtype.

Decode attends one query token against a (B, S_cache, kv, h) cache that is
written in place at ``pos`` (the cache is preallocated by ``prefill``;
nothing is reallocated per step).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .layers import apply_rope, softcap
from .module import Ctx, fan_in_init, zeros_init

NEG = -2.0e38


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    attn_softcap: float = 0.0
    rope_theta: float = 10000.0
    query_scale: float | None = None  # default 1/sqrt(head_dim)


def init_attention(ctx: Ctx, cfg: AttnConfig):
    h, kv, hd, d = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_model
    ctx.param("wq", (d, h, hd), ("embed", "heads", "head_dim"), fan_in_init())
    ctx.param("wk", (d, kv, hd), ("embed", "kv_heads", "head_dim"), fan_in_init())
    ctx.param("wv", (d, kv, hd), ("embed", "kv_heads", "head_dim"), fan_in_init())
    ctx.param("wo", (h, hd, d), ("heads", "head_dim", "embed"), fan_in_init())
    if cfg.qkv_bias:
        ctx.param("bq", (h, hd), ("heads", "head_dim"), zeros_init())
        ctx.param("bk", (kv, hd), ("kv_heads", "head_dim"), zeros_init())
        ctx.param("bv", (kv, hd), ("kv_heads", "head_dim"), zeros_init())


def _qkv(params, x, cfg: AttnConfig, positions):
    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, params["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores_mask(q_pos, k_pos, window: int):
    """causal + optional sliding window (window 0 = off)."""
    causal = k_pos[None, :] <= q_pos[:, None]
    in_win = (q_pos[:, None] - k_pos[None, :]) < max(window, 1)
    return causal & (in_win | (window <= 0))


def attend(q, k, v, mask, cfg: AttnConfig):
    """q (B,S,nq,h); k/v (B,T,kv,h); mask (S,T) or (B,S,T) bool."""
    b, s, nq, hd = q.shape
    kvh = k.shape[2]
    group = nq // kvh
    scale = cfg.query_scale or (hd ** -0.5)
    qg = q.reshape(b, s, kvh, group, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    logits = softcap(logits, cfg.attn_softcap)
    while mask.dim() < logits.dim():
        mask = mask[None]
    logits = torch.where(mask, logits, NEG)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(b, s, nq, hd)


def attend_chunked(q, k, v, window: int, cfg: AttnConfig, chunk: int):
    """Flash-style online-softmax attention over KV chunks.

    Never materializes the (S, S) score tensor: a loop over KV chunks
    carries running (max, sum, acc) statistics in f32, so the peak
    intermediate is (..., chunk)."""
    b, s, nq, hd = q.shape
    kvh = k.shape[2]
    group = nq // kvh
    scale = cfg.query_scale or (hd ** -0.5)
    qg = q.reshape(b, s, kvh, group, hd)
    q_pos = torch.arange(s, dtype=torch.int32, device=q.device)
    m = torch.full((b, kvh, group, s), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, group, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, group, s, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(s // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        k_pos = j * chunk + torch.arange(chunk, dtype=torch.int32,
                                         device=q.device)
        logits = torch.einsum("bskgh,btkh->bkgst", qg, kj).float()
        logits = softcap(logits * scale, cfg.attn_softcap)
        mask = _scores_mask(q_pos, k_pos, window)
        logits = torch.where(mask[None, None, None], logits, NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        # accumulate in f32 (flash-attention convention)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkh->bkgsh", p.to(q.dtype), vj).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.movedim(out, 3, 1).reshape(b, s, nq, hd)
    return out.to(q.dtype)


def attention_train(params, x, cfg: AttnConfig, window: int, positions=None,
                    chunk: int = 0):
    """Full (pre-fill / training) self-attention.  chunk > 0 routes through
    the flash-style chunked path.  Returns (out, (k, v))."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    q, k, v = _qkv(params, x, cfg, positions)
    if chunk and s % chunk == 0 and s > chunk:
        out = attend_chunked(q, k, v, window, cfg, chunk)
    else:
        pos = torch.arange(s, dtype=torch.int32, device=x.device)
        out = attend(q, k, v, _scores_mask(pos, pos, window), cfg)
    return torch.einsum("bsnh,nhd->bsd", out, params["wo"]), (k, v)


def attention_decode(params, x, cache_k, cache_v, pos: int, cfg: AttnConfig,
                     window: int):
    """One-token decode.  x (B,1,d); cache_k/v (B,S,kv,h), written in place
    at ``pos``.  Returns (out (B,1,d), cache_k, cache_v)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)
    k_pos = torch.arange(cache_k.shape[1], dtype=torch.int32, device=x.device)
    valid = k_pos <= pos
    in_win = (pos - k_pos) < max(window, 1)
    mask = (valid & (in_win | (window <= 0)))[None, :]       # (1, T)
    out = attend(q, cache_k.to(q.dtype), cache_v.to(q.dtype), mask, cfg)
    return torch.einsum("bsnh,nhd->bsd", out, params["wo"]), cache_k, cache_v
