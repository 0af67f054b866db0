"""The bars the port is held to against a reference top-k (the JAX package
on the CPU, or a kernel's plain version on the card).

Distances agree within ``atol + rtol * |d|``; ids agree wherever the
reference's distance is apart from both of its neighbours in the row by more
than that tolerance (ties may legitimately swap).  Missing entries (+inf)
must agree exactly.
"""
from __future__ import annotations

import numpy as np


def tie_free(dists, rtol: float = 1e-5, atol: float = 1e-5) -> np.ndarray:
    """(B, k) bool: entries whose distance is apart from both neighbours in
    its row by more than the tolerance; +inf (missing) entries count as
    tie-free."""
    d = np.asarray(dists, np.float64)
    tol = atol + rtol * np.abs(np.where(np.isfinite(d), d, 0.0))
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(d, axis=1))
    gap = np.where(np.isnan(gap), np.inf, gap)
    prev = np.full(d.shape, np.inf)
    nxt = np.full(d.shape, np.inf)
    prev[:, 1:] = gap
    nxt[:, :-1] = gap
    return ~np.isfinite(d) | ((prev > tol) & (nxt > tol))


def topk_mismatch(ref_ids, ref_d, ids, dists, rtol: float = 1e-5,
                  atol: float = 1e-5) -> dict:
    """Compare a top-k against a reference.  Returns the counts of distance
    mismatches and of tie-free id mismatches (both 0 when the bar holds), the
    largest finite distance difference and the share of identical rows."""
    ref_ids, ids = np.asarray(ref_ids), np.asarray(ids)
    ref_d = np.asarray(ref_d, np.float64)
    d = np.asarray(dists, np.float64)
    fin = np.isfinite(ref_d) & np.isfinite(d)
    same_inf = np.isfinite(ref_d) == np.isfinite(d)
    close = np.zeros(d.shape, bool)
    close[fin] = np.abs(d[fin] - ref_d[fin]) <= atol + rtol * np.abs(ref_d[fin])
    close |= ~np.isfinite(ref_d) & ~np.isfinite(d)
    free = tie_free(ref_d, rtol, atol)
    return {
        "dist_mismatch": int((~close | ~same_inf).sum()),
        "id_mismatch": int((free & (ref_ids != ids)).sum()),
        "max_abs_diff": float(np.abs(d[fin] - ref_d[fin]).max()) if fin.any()
        else 0.0,
        "identical_rows": float((ref_ids == ids).all(axis=1).mean()),
    }
