"""Exclusion-distance determination (paper Sections 5.1 and 5.3).

Equation (2):   Dis_bar(q, v) = Dis(q, v) + D * [attributes violate F]

Equation (5):   global linear-model slope of the m-th-NN distance curve,
                Delta_d = (d_alpha - d_beta) / (alpha - beta),
                with d_m the dataset-average distance to the m-th nearest
                neighbor; alpha = 10 and beta = efc in the paper's setup.
                Recorded offline during index construction from each inserted
                node's efc-candidate list (paper section 6.3.1).

Equation (14):  D = (1-p) (ef - p) Delta_d / (2 p), then normalized by ef
                ("Empirically, normalizing this value by ef is found to
                further enhance robustness"), i.e.

                    D = (1 - p) (ef - p) Delta_d / (2 p ef)

                This is the midpoint of the admissible band (Ineq. 13)
                    (1-p)(k/p - 1) Dd  <  D  <  (1-p)(ef-k)/p Dd
                by the minimax argument of section 5.3.2.

``p`` is the estimated selectivity; the selector guarantees p >= lambda when
the graph path runs, but benchmarks may force the graph path at tiny p, so we
clamp to ``p_min`` to keep D finite.
"""
from __future__ import annotations

import numpy as np


def delta_d_from_curve(dists_sorted, alpha: int = 10, beta: int = 100):
    """Eq. 5 from one node's sorted neighbor-distance curve.

    dists_sorted: (m,) ascending distances to the 1st..m-th nearest neighbor.
    Uses the last entry when the curve is shorter than beta (paper 6.3.1
    uses the efc-range candidates as approximate alpha/beta-th neighbors).
    """
    m = len(dists_sorted)
    if m < 2:
        return 0.0
    a = min(alpha, m) - 1
    b = min(beta, m) - 1
    if b <= a:
        a, b = 0, m - 1
    return float((dists_sorted[b] - dists_sorted[a]) / (b - a))


def delta_d_global(per_node_alpha, per_node_beta, alpha: int, beta: int) -> float:
    """Eq. 5 with dataset-average d_alpha / d_beta accumulated during build."""
    d_a = float(np.mean(per_node_alpha))
    d_b = float(np.mean(per_node_beta))
    return (d_b - d_a) / float(beta - alpha)


def exclusion_distance(p, ef: int, delta_d: float, *, k: int = 10,
                       strategy: str = "lo", normalize: bool | None = None,
                       p_min: float = 1e-4, xp=np):
    """Selectivity-aware exclusion distance; per-query ``p``.

    ``xp`` is the array namespace: numpy (host) or torch (``p`` a tensor).

    strategy:
      "lo"   (default) -- the LOWER edge of the admissible band (Ineq. 13):
             D = (1-p)(k/p - 1) Delta_d.  *Minimal sufficient exclusion*:
             NTD are pushed just beyond the target-set radius R(q, S) -- the
             exclusion guarantee of Fig. 3c with maximal connectivity margin.
             Measured across both data regimes (EXPERIMENTS.md section Perf
             fidelity iterations 0-1) this wins or ties everywhere the
             paper's midpoint or its ef-normalized variant degrade.
      "mid"  -- the paper's Eq. 14 midpoint, (1-p)(ef-p) Delta_d / (2p).
             Optimal under the minimax argument WHEN the linear model holds
             out to the ef/p-th neighbor; at small N or tight clusters it
             lands in the excessive-D regime (Fig. 3b) and recall drops.
      "mid_norm" -- Eq. 14 divided by ef (the other reading of the paper's
             "normalizing by ef" remark); ~ef x too small at low p.

    ``normalize`` (bool) is kept for backwards compatibility and maps to
    "mid" / "mid_norm".
    """
    if normalize is not None:
        strategy = "mid_norm" if normalize else "mid"
    p = xp.clip(p, p_min, 1.0)
    if strategy == "lo":
        # full_like(p, k) / p, not k / p: torch evaluates a scalar over a
        # tensor as k * reciprocal(p), which rounds differently
        return (1.0 - p) * (xp.full_like(p, k) / p - 1.0) * delta_d
    d = (1.0 - p) * (ef - p) * delta_d / (2.0 * p)
    if strategy == "mid_norm":
        d = d / ef
    return d


def exclusion_bounds(p: float, ef: int, k: int, delta_d: float) -> tuple[float, float]:
    """Ineq. 13 admissible band (diagnostics / property tests)."""
    lo = (1.0 - p) * (k / p - 1.0) * delta_d
    hi = (1.0 - p) * (ef - k) / p * delta_d
    return lo, hi


def d_max(query, vectors, mask) -> float:
    """Ablation strategy D_max (section 6.4.1): push every TD in front of every
    NTD:  max_T Dis(q, v^T) - min_N Dis(q, v^N).  Brute force; ablation only."""
    d = np.linalg.norm(vectors - query[None, :], axis=1)
    td = d[mask]
    ntd = d[~mask]
    if len(td) == 0 or len(ntd) == 0:
        return 0.0
    return max(0.0, float(td.max() - ntd.min()))
