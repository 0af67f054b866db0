"""Gradient compression for a data-parallel all-reduce: int8 blockwise
quantization with error feedback (1-bit-Adam family, arXiv:2102.02888-style),
as in the JAX package.

int8 with per-block scales cuts the all-reduce's bytes 4x against f32 (2x
against bf16) at little cost in quality *when error feedback carries the
residual*.  ``quantize_dequantize`` gives the wire format's values (the
JAX package's bits: ``torch.round`` rounds half to even, as ``jnp.round``
does), and ``compress_tree`` folds each leaf's quantization error into a
residual added to the next step's gradients.  The port trains on one
device, so nothing is all-reduced: the hook runs for its numerics.
"""
from __future__ import annotations

import torch

from .optimizer import tree_map


def quantize_dequantize(x, block: int = 256):
    """Blockwise symmetric int8 quantize -> dequantize.  Returns (y, err)."""
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % block
    fp = torch.nn.functional.pad(flat, (0, pad))
    blocks = fp.reshape(-1, block)
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    # a true division (the card takes ``tensor / scalar`` as a multiply by
    # the reciprocal): the JAX package's bits
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127)
    deq = (q * scale).reshape(-1)[: flat.shape[0]].reshape(x.shape)
    return deq.to(x.dtype), (x - deq).to(x.dtype)


def compress_tree(grads, residual):
    """Error-feedback compression over a gradient tree.
    Returns (compressed_grads, new_residual)."""
    pairs = tree_map(lambda g, r: quantize_dequantize(g + r), grads, residual)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def init_residual(params):
    return tree_map(torch.zeros_like, params)
