"""Selectivity-driven search selector (paper Section 4).

Routes each query by its sampled selectivity estimate: ``p_hat < lambda``
(= 1%, paper section 4.1) goes to the pre-filtering brute-force scan, the rest
to the exclusion-distance graph search.  The middle band (1% < p < 3%) is
deliberately biased toward the graph path -- its QPS response is flat there
(< 8% variation, Fig. 7) so estimator error is cheap, whereas the brute-force
path swings > 50%.

The estimate itself is one vectorized filter-program evaluation over the
fixed sample block (selectivity.py), run on the device that holds the sample.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import filters as F


@dataclass(frozen=True)
class SelectorConfig:
    lam: float = 0.01          # lambda threshold (section 4.1)
    sample_rate: float = 0.01  # section 4.2: 1% sampling
    min_sample: int = 256
    max_sample: int = 65536
    p_min: float = 1e-4        # clamp for D computation off-route


def estimate_batched(programs, sample_ints, sample_floats) -> torch.Tensor:
    """(B,) float32 p_hat over the pre-drawn sample rows (runs every batch).

    The count of 0/1 values is exact below 2**24 rows; it is scaled by the
    float32 reciprocal of the sample size, the form XLA gives ``jnp.mean``,
    so p_hat is the JAX package's float32 bit for bit.  The reciprocal is
    filled on the device (a copy up of a host scalar would wait for the
    work queued on the card)."""
    mask = F.eval_program_batched(programs, sample_ints, sample_floats)
    count = mask.sum(dim=1, dtype=torch.float32)
    return count * torch.full((), 1.0 / max(mask.shape[1], 1),
                              dtype=torch.float32, device=count.device)


def route(p_hat, lam: float) -> np.ndarray:
    """True -> PreFBF (brute force); False -> FAVOR graph search."""
    if isinstance(p_hat, torch.Tensor):
        p_hat = p_hat.cpu().numpy()
    return np.asarray(p_hat) < lam
