"""Selectivity estimation by random sampling (paper Section 4.2).

The estimator draws a fixed random subset of the dataset once at index-build
time (so the sampled attribute rows are a small dense block that stays hot in
cache) and, per query, evaluates the compiled filter program over the
sample: ``p_hat = mean(mask)``.

Because the number of target points in a sample without replacement follows a
hyper-geometric distribution, the relative error of ``p_hat`` is (Eq. 1)

    rel_err = sqrt((1-p) / (n p) * (1 - n/N))

which stays around 1% for million-scale datasets at a 1% sampling rate down to
p ~ 1%; below that the selector routes to PreFBF anyway (whose execution does
not consume ``p_hat``), so estimator error there is inconsequential.
"""
from __future__ import annotations

import numpy as np
import torch

from . import filters as F


def sample_indices(n: int, rate: float = 0.01, min_size: int = 256,
                   max_size: int = 65536, seed: int = 0) -> np.ndarray:
    """Fixed sample drawn once at build time (without replacement)."""
    size = int(np.clip(int(round(n * rate)), min(min_size, n), min(max_size, n)))
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=size, replace=False)).astype(np.int32)


def relative_error(n: int, p: float, total: int) -> float:
    """Eq. 1: hyper-geometric relative error of the sampled estimate."""
    if p <= 0.0:
        return float("inf")
    return float(np.sqrt((1.0 - p) / (n * p) * max(0.0, 1.0 - n / total)))


def exact_selectivity(program, attrs: "F.AttributeTable") -> float:
    """Ground-truth p by full scan (tests / benchmarks only)."""
    mask = F.eval_program(program, attrs.ints, attrs.floats)
    return float(mask.to(torch.float64).mean())
