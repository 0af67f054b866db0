"""Optimizers from scratch: AdamW + SGD-momentum, global-norm clipping and
the warmup-cosine schedule, term by term as the JAX package computes them
(f32 moments and step, ``(p.float() - lr * u).to(p.dtype)``), over param
trees (nested dicts of tensors).

The moments live on the parameters' device, and the step counter and the
learning rate stay 0-d tensors there: an update never waits for the
device.  ``apply_updates(..., inplace=True)`` writes the new parameters
and moments into the given tensors, one leaf at a time, so an update of a
large model holds one leaf's temporaries, not a second copy of its state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    kind: str = "adamw"  # adamw | sgdm


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: dict
    nu: dict  # unused for sgdm (zeros, kept for a uniform tree)


# ---------------------------------------------------------------------------
# Param trees
# ---------------------------------------------------------------------------
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in sorted-key order (``jax.tree.leaves``' order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def init_opt_state(params, cfg: OptConfig) -> OptState:
    # moments are f32 regardless of (possibly bf16) param dtype
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    # two trees for either kind (the JAX package shares one zeros tree for
    # SGDM's unused nu): an in-place update of mu must leave nu at zero
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(f32, params), nu=tree_map(f32, params))


def schedule(cfg: OptConfig, step):
    """Linear warmup -> cosine decay to min_lr_frac * lr; ``step`` an f32
    tensor, the result an f32 tensor on its device."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree):
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_scale(gn, max_norm: float):
    # full_like(...) / x: torch takes ``scalar / tensor`` as a reciprocal
    # multiply, XLA as a division
    return torch.clamp(torch.full_like(gn, max_norm) /
                       torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: _scaled(g, scale), grads), gn


def _scaled(g, scale):
    # in f32 and rounded once, as the JAX package's bf16 x f32 promotes
    return (g.float() * scale).to(g.dtype)


def apply_updates(params, grads, state: OptState, cfg: OptConfig, *,
                  inplace: bool = False):
    """One optimizer step.  Returns (new_params, new_state, metrics).

    ``inplace``: the new values are copied into ``params`` and ``state``'s
    tensors, leaf by leaf, and those trees are returned (the port's
    buffer donation); the values are the same either way."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.clip_norm)
    step = state.step + 1
    stepf = step.float()
    lr = schedule(cfg, stepf)
    b1, b2 = cfg.betas
    if cfg.kind == "adamw":
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf

    def settle(old, new):
        # in place: the new value goes into the old tensor at once, so a
        # leaf's temporaries never hold two copies of its moments
        return old.copy_(new) if inplace else new

    def leaf(p, g, m, v):
        g = _scaled(g, scale)
        if cfg.kind == "adamw":
            m2 = settle(m, b1 * m + (1 - b1) * g.to(m.dtype))
            v2 = settle(v, b2 * v + (1 - b2) * torch.square(g.to(v.dtype)))
            del g
            u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps) + \
                cfg.weight_decay * p.to(m.dtype)
            p2 = settle(p, (p.float() - lr * u).to(p.dtype))
        else:  # sgd + momentum
            m2, v2 = settle(m, b1 * m + g.to(m.dtype)), v
            del g
            p2 = settle(p, (p.float() - lr * m2).to(p.dtype))
        return p2, m2, v2

    out = tree_map(leaf, params, grads, state.mu, state.nu)
    new_params, mu, nu = (_pick(out, i) for i in range(3))
    if inplace:
        state.step.copy_(step)
        step = state.step
    return new_params, OptState(step=step, mu=mu, nu=nu), {
        "lr": lr, "grad_norm": gn}


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
