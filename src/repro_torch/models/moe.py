"""Mixture-of-Experts block: top-k routing + sort-based static-capacity
dispatch + grouped expert matmuls.

Dispatch is the sort-based static-shape formulation (no (T, E, C) one-hot
tensors): flatten (token, choice) pairs, sort them stably by expert id,
compute each pair's position inside its expert group via an exclusive
cumsum of expert counts, drop pairs beyond the static capacity
C = ceil(T*k/E * cf), scatter the survivors into (E, C) slots, run the
per-expert SwiGLU as batched matmuls over the expert axis, and add the
weighted outputs back to token order (``index_add_``: atomics on the card,
so the sum's order -- and its last bits -- may differ from run to run).

Ties break to the lower index, as ``lax.top_k`` and ``jnp.argsort`` do:
both selections are stable sorts.  Aux losses: the Switch load-balancing
loss + router z-loss.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as Fn

from .module import Ctx, fan_in_init, normal_init


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                 # per-expert hidden
    capacity_factor: float = 1.25
    renormalize: bool = True
    dense_residual: bool = False  # arctic-style parallel dense FFN
    d_ff_dense: int = 0


def init_moe(ctx: Ctx, cfg: MoEConfig):
    ctx.param("router", (cfg.d_model, cfg.n_experts), ("embed", "experts"),
              normal_init(0.02))
    ctx.param("wi_gate", (cfg.n_experts, cfg.d_model, cfg.d_ff),
              ("experts", "embed", "expert_mlp"), fan_in_init())
    ctx.param("wi_up", (cfg.n_experts, cfg.d_model, cfg.d_ff),
              ("experts", "embed", "expert_mlp"), fan_in_init())
    ctx.param("wo", (cfg.n_experts, cfg.d_ff, cfg.d_model),
              ("experts", "expert_mlp", "embed"), fan_in_init())
    if cfg.dense_residual:
        dff = cfg.d_ff_dense or cfg.d_ff
        ctx.param("dense_gate", (cfg.d_model, dff), ("embed", "mlp"), fan_in_init())
        ctx.param("dense_up", (cfg.d_model, dff), ("embed", "mlp"), fan_in_init())
        ctx.param("dense_down", (dff, cfg.d_model), ("mlp", "embed"), fan_in_init())


def moe_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def stable_top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``lax.top_k``'s order)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, order), order


def apply_moe(params, x, cfg: MoEConfig):
    """x (..., T, d) flattened internally.  Returns (y, aux) where aux carries
    the load-balance and z losses and the dropped fraction."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    c = moe_capacity(t, cfg)
    dev = x.device

    logits = (xf @ params["router"]).float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = stable_top_k(probs, k)                    # (T, k)
    if cfg.renormalize:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # aux losses (Switch load balance + z-loss)
    me = probs.mean(dim=0)                                   # (E,)
    ce = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
        0, top_i.reshape(-1),
        torch.ones((t * k,), dtype=torch.float32, device=dev)) / (t * k)
    lb_loss = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # ---- sort-based dispatch -------------------------------------------------
    flat_e = top_i.reshape(-1)                               # (T*k,)
    flat_t = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    flat_p = top_p.reshape(-1).to(x.dtype)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sp = flat_e[order], flat_t[order], flat_p[order]
    # counts by scatter-add, not bincount: the dry run's meta tensors have
    # no bincount (its output length depends on the data)
    counts = torch.zeros((e,), dtype=torch.int64, device=dev).index_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts                # exclusive
    pos = torch.arange(t * k, device=dev) - starts[se]
    keep = pos < c
    slot = torch.where(keep, se * c + pos, e * c)            # drop -> sentinel

    # one spare row takes every dropped pair's write; it is cut after
    disp_tok = torch.zeros((e * c + 1,), dtype=torch.int64, device=dev)
    disp_tok[slot] = st
    disp_p = torch.zeros((e * c + 1,), dtype=x.dtype, device=dev)
    disp_p[slot] = sp
    disp_ok = torch.zeros((e * c + 1,), dtype=torch.bool, device=dev)
    disp_ok[slot] = keep
    disp_tok, disp_p, disp_ok = disp_tok[:e * c], disp_p[:e * c], disp_ok[:e * c]

    x_e = xf[disp_tok].reshape(e, c, d)
    x_e = torch.where(disp_ok.reshape(e, c, 1), x_e, 0)

    # ---- expert SwiGLU (batched over the expert axis) ------------------------
    g = torch.bmm(x_e, params["wi_gate"])
    u = torch.bmm(x_e, params["wi_up"])
    h = Fn.silu(g) * u
    y_e = torch.bmm(h, params["wo"])                         # (E, C, d)

    # ---- combine -------------------------------------------------------------
    w = (disp_p * disp_ok).reshape(e * c, 1)
    y = torch.zeros_like(xf).index_add_(0, disp_tok, y_e.reshape(e * c, d) * w)

    if cfg.dense_residual:
        dg = Fn.silu(xf @ params["dense_gate"]) * (xf @ params["dense_up"])
        y = y + dg @ params["dense_down"]

    # 1 - mean(keep) as XLA evaluates it: one rounding of
    # fma(-sum, f32(1/n), 1) (the f64 product of two f32 factors is exact)
    inv_n = float(np.float32(1.0 / keep.numel()))
    dropped = (1.0 - keep.sum().double() * inv_n).float()
    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "dropped_frac": dropped}
    return y.reshape(orig_shape), aux
