"""Shared layers: norms, gated MLP, RoPE, softcap."""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from .module import Ctx, fan_in_init, ones_init, zeros_init


# ---------------------------------------------------------------------------
# Norms (f32 inside, cast back to the input's dtype)
# ---------------------------------------------------------------------------
def init_norm(ctx: Ctx, name: str, dim: int, kind: str):
    sc = ctx.scope(name)
    sc.param("scale", (dim,), ("embed",), ones_init())
    if kind == "layernorm":
        sc.param("bias", (dim,), ("embed",), zeros_init())


def apply_norm(params, x, kind: str, eps: float = 1e-6,
               gemma_style: bool = False):
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"]
        if params.get("bias") is not None:
            y = y + params["bias"]
    else:  # rmsnorm
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        scale = (1.0 + params["scale"]) if gemma_style else params["scale"]
        y = y * scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------
def init_mlp(ctx: Ctx, name: str, d_model: int, d_ff: int):
    sc = ctx.scope(name)
    sc.param("gate", (d_model, d_ff), ("embed", "mlp"), fan_in_init())
    sc.param("up", (d_model, d_ff), ("embed", "mlp"), fan_in_init())
    sc.param("down", (d_ff, d_model), ("mlp", "embed"), fan_in_init())


def apply_mlp(params, x):
    h = Fn.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x (..., S, n, h); positions (..., S) int32."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (half,)
    ang = positions[..., None].float() * freqs                # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap and cap > 0 else x
