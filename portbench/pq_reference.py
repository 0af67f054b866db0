"""The plain reference of the compressed brute route: product-quantization
codes, asymmetric distances (ADC) over them, and the exact re-rank.

Plain torch, float32, TF32 off; it imports nothing of the program.  The
deployment's weights are the trained centroids (M, K, dsub): the program
trains them, and the reference takes them as given, as a model's reference
takes its checkpoint.  Everything else it computes itself, in the direct
form, from the benchmark's rows:

* ``encode``: each row's code in subspace m is its nearest centroid by
  sum_j (x_j - c_j)^2, ties to the lower code;
* ``tables``: a query's (M, K) table of sum_j (q_j - c_j)^2;
* ``scan``: each passing row's ADC distance, its M table entries at its
  codes added in subspace order from 0, and the R smallest by (distance,
  id);
* ``rerank``: the exact f32 distance |q - x| of those R rows, and the k
  smallest by (distance, id).

``compare_codes`` and ``compare_answers`` hold the program to it: codes,
candidate lists and answers identical wherever the distances that order
them are apart by more than the rounding both sides may make.  The bounds
(u = 2^-24, the unit roundoff of f32; d the row width, M the subspaces):

* a code: the program ranks centroids by |x|^2 - 2 x.c + |c|^2, each term
  within (dsub + 2) u (|x|^2 + |c|^2) of its real value, the reference by
  the direct sum, within (dsub + 1) u of it; two codes may swap where their
  direct distances differ by at most 4 (dsub + 2) u (|x|^2 + |c_a|^2 +
  |c_b|^2).  A row whose codes differ that little is a tie row: its ADC
  distances differ by a table entry, so it is left out of the candidate
  comparison;
* an ADC distance: the program's table entries use the same expansion;
  the sum is the same chain of M adds on both sides.  So a query's ADC
  distances agree within 2 (dsub + M + 3) u S, S = sum_m (|q_m|^2 + max_c
  |c_mc|^2), and a candidate list may swap rows whose distances lie that
  close to its last entry;
* an exact distance: the program's re-rank takes sqrt(|x|^2 + |q|^2 -
  2 q.x); its square is within (d + 2) u (|q|^2 + |x|^2) of the real one,
  so the relative gap to the direct distance r is at most (d + 2) u
  (|q|^2 + |x|^2) / r^2.  ``rtol`` replaces that bound by a fixed one.

Dropping a subspace from the sum moves an ADC distance by a whole table
entry, a re-rank depth cut to k shortens every list, and TF32 operands in
the re-rank move a distance by ~2^-11 of |q|^2 + |x|^2: each is far outside
these bounds.
"""
from __future__ import annotations

import contextlib

import torch

U = 2.0 ** -24          # unit roundoff of float32
ROW_BLOCK = 65536       # rows per block of ``encode``
INF = float("inf")


@contextlib.contextmanager
def ieee_f32():
    """Matmuls and convolutions in IEEE float32 inside the block (TF32
    off); the reference's own sums are elementwise, this guards the rest."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def split(x: torch.Tensor, m: int, dsub: int) -> torch.Tensor:
    """(N, d) -> (N, m, dsub), the feature tail zero-padded."""
    pad = m * dsub - x.shape[1]
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad))], dim=1)
    return x.reshape(x.shape[0], m, dsub)


def _sq_dist(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(R, m, dsub), (m, K, dsub) -> (R, m, K): sum_j (a_j - c_j)^2, the
    terms added in coordinate order."""
    diff = a[:, :, None, 0] - c[None, :, :, 0]
    out = diff * diff
    for j in range(1, a.shape[2]):
        diff = a[:, :, None, j] - c[None, :, :, j]
        out = out + diff * diff
    return out


def encode(vectors: torch.Tensor, centroids: torch.Tensor,
           block: int = ROW_BLOCK) -> torch.Tensor:
    """(N, M) uint8: each row's nearest centroid per subspace, ties to the
    lower code."""
    m, _, dsub = centroids.shape
    out = torch.empty((vectors.shape[0], m), dtype=torch.uint8,
                      device=vectors.device)
    with ieee_f32():
        for s in range(0, vectors.shape[0], block):
            d2 = _sq_dist(split(vectors[s:s + block], m, dsub), centroids)
            out[s:s + block] = torch.argmin(d2, dim=2).to(torch.uint8)
    return out


def tables(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(B, M, K) f32: each query's squared distance to every centroid of
    every subspace."""
    m, _, dsub = centroids.shape
    with ieee_f32():
        return _sq_dist(split(queries, m, dsub), centroids)


def adc(luts: torch.Tensor, codes: torch.Tensor,
        rows: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N) ADC distances of every row (or (B, R) of ``rows`` (B, R), ids
    >= 0), the M table entries at the rows' codes added in subspace order
    from 0."""
    b, m, _ = luts.shape
    if rows is None:
        cc = codes.long()                                   # (N, M)
        out = luts[:, 0, :][:, cc[:, 0]]
        for mm in range(1, m):
            out = out + luts[:, mm, :][:, cc[:, mm]]
        return out
    cc = codes[rows.clamp(min=0)].long()                    # (B, R, M)
    out = luts[:, 0, :].gather(1, cc[:, :, 0])
    for mm in range(1, m):
        out = out + luts[:, mm, :].gather(1, cc[:, :, mm])
    return out


def _smallest(d: torch.Tensor, r: int):
    """The ``r`` smallest finite entries of each row of ``d`` by (value,
    column): (columns (B, r) int64, -1 padded; values (B, r), +inf
    padded)."""
    val, pos = torch.sort(d, dim=1, stable=True)
    val, pos = val[:, :r], pos[:, :r]
    found = torch.isfinite(val)
    return torch.where(found, pos, -1), torch.where(found, val, INF)


def scan(luts: torch.Tensor, codes: torch.Tensor, mask: torch.Tensor,
         r: int):
    """The R passing rows (``mask`` (B, N) bool) with the smallest ADC
    distance: (ids (B, R) int64, -1 padded; ADC distances, +inf padded)."""
    d = torch.where(mask, adc(luts, codes), INF)
    return _smallest(d, r)


def distances(vectors: torch.Tensor, queries: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """(B, R) exact f32 |q - x_id| (+inf where the id is -1), the squares
    added in coordinate order."""
    rows = vectors[ids.clamp(min=0)]                        # (B, R, d)
    diff = rows[:, :, 0] - queries[:, None, 0]
    acc = diff * diff
    for j in range(1, vectors.shape[1]):
        diff = rows[:, :, j] - queries[:, None, j]
        acc = acc + diff * diff
    return torch.where(ids >= 0, torch.sqrt(acc), INF)


def rerank(vectors: torch.Tensor, queries: torch.Tensor,
           cand: torch.Tensor, k: int):
    """The k candidates nearest by exact f32 distance, ties to the lower id:
    (ids (B, k) int64, -1 padded; distances (B, k), +inf padded)."""
    by_id = torch.sort(cand, dim=1).values          # -1 first, at +inf
    pos, val = _smallest(distances(vectors, queries, by_id), k)
    return torch.where(pos >= 0, by_id.gather(1, pos.clamp(min=0)), -1), val


def search(vectors: torch.Tensor, codes: torch.Tensor,
           centroids: torch.Tensor, queries: torch.Tensor,
           mask: torch.Tensor, k: int, r: int) -> dict:
    """The route's answer for ``queries`` (B, d) with passing rows ``mask``
    (B, N): ``cand_i`` / ``cand_d`` (the ADC scan's R), ``ids`` / ``dists``
    (the re-rank's k) and the ``luts``.  ``codes`` are ``encode``'s."""
    luts = tables(queries, centroids)
    cand_i, cand_d = scan(luts, codes, mask, r)
    ids, dists = rerank(vectors, queries, cand_i, k)
    return {"luts": luts, "cand_i": cand_i, "cand_d": cand_d, "ids": ids,
            "dists": dists}


# -- the comparison -------------------------------------------------------------
def compare_codes(vectors: torch.Tensor, centroids: torch.Tensor,
                  got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The program's codes ``got`` against ``encode``'s ``ref`` (both
    (N, M)): ``differ`` (entries not equal), ``mismatch`` (of those, the
    ones whose direct distances are apart by more than the bound of the
    module note) and ``tie_rows`` (the rows whose codes differ within it)."""
    rows = torch.nonzero((got != ref).any(1)).flatten()
    if not len(rows):
        empty = rows[:0]
        return {"differ": 0, "mismatch": 0, "tie_rows": empty}
    m, _, dsub = centroids.shape
    x = split(vectors[rows], m, dsub)                       # (T, M, dsub)
    ga, rb = got[rows].long(), ref[rows].long()
    sub = torch.arange(m, device=rows.device)
    ca, cb = centroids[sub, ga], centroids[sub, rb]         # (T, M, dsub)

    def direct(c):
        diff = x[:, :, 0] - c[:, :, 0]
        acc = diff * diff
        for j in range(1, dsub):
            diff = x[:, :, j] - c[:, :, j]
            acc = acc + diff * diff
        return acc
    gap = direct(ca) - direct(cb)
    bound = 4 * (dsub + 2) * U * ((x * x).sum(-1) + (ca * ca).sum(-1)
                                  + (cb * cb).sum(-1))
    off = ga != rb
    bad = off & (gap.abs() > bound)
    return {"differ": int(off.sum()), "mismatch": int(bad.sum()),
            "tie_rows": rows[~bad.any(1)]}


def adc_bound(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(B,) the bound of the module note on the gap between two ADC
    distances of one query: 2 (dsub + M + 3) u sum_m (|q_m|^2 + max_c
    |c_mc|^2)."""
    m, _, dsub = centroids.shape
    q = split(queries, m, dsub)
    s = (q * q).sum(-1) + (centroids * centroids).sum(-1).max(1).values
    return 2 * (dsub + m + 3) * U * s.sum(1)


def compare_answers(vectors: torch.Tensor, centroids: torch.Tensor,
                    codes: torch.Tensor, queries: torch.Tensor,
                    mask: torch.Tensor, ref: dict, got: dict, k: int, *,
                    tie_rows=None, rtol: float | None = None) -> dict:
    """The program's candidate lists and answers for ``queries`` against
    ``search``'s ``ref``; ``got`` holds ``cand_i`` / ``cand_d`` (the scan's
    ids and squared ADC distances) and ``ids`` / ``dists`` (the answers).
    Counts of the module note's breaches, each 0 when the program holds:

    * ``cand_count``: lists whose number of rows is not min(R, passing);
    * ``cand_ids``: rows in one list and not in the other whose ADC
      distance is not within the bound of the reference list's last;
    * ``cand_adc``: listed rows whose ADC distance is not within the bound
      of the reference's;
    * ``ans_count``, ``ans_ids``, ``ans_dist``: the same for the answers,
      with the exact distance's bound (``rtol`` replaces it);

    and, as plain counts, ``cand_differ`` / ``ans_differ`` (lists not
    equal as sets) and ``ans_max_rel`` (the largest relative gap of an
    answer's distance)."""
    dev = ref["cand_i"].device
    tie = torch.zeros(vectors.shape[0], dtype=torch.bool, device=dev)
    if tie_rows is not None and len(tie_rows):
        tie[tie_rows.to(dev)] = True
    gi = got["cand_i"].to(dev).long()
    gd = got["cand_d"].to(dev)
    gi = torch.where(gi >= 0, gi, -1)
    ri = ref["cand_i"]
    bound = adc_bound(queries, centroids)[:, None]
    out = {"cand_count": int(((gi >= 0).sum(1) != (ri >= 0).sum(1)).sum())}
    # the reference's ADC distance of every row the program listed
    g_ref = torch.where(gi >= 0, adc(ref["luts"], codes, gi), INF)
    g_pass = mask.gather(1, gi.clamp(min=0)) & (gi >= 0)
    last = torch.where(ri >= 0, ref["cand_d"], -INF).max(1).values[:, None]
    in_ref = ((gi[:, :, None] == ri[:, None, :]) & (ri[:, None, :] >= 0)).any(2)
    in_got = ((ri[:, :, None] == gi[:, None, :]) & (gi[:, None, :] >= 0)).any(2)
    g_tie = tie[gi.clamp(min=0)]
    r_tie = tie[ri.clamp(min=0)]
    extra = (gi >= 0) & ~in_ref & ~g_tie & (~g_pass | (g_ref > last + bound))
    missing = (ri >= 0) & ~in_got & ~r_tie & (ref["cand_d"] < last - bound)
    out["cand_ids"] = int(extra.sum() + missing.sum())
    out["cand_adc"] = int(((gi >= 0) & ~g_tie
                           & ((gd - g_ref).abs() > bound)).sum())
    out["cand_differ"] = int((((gi >= 0) & ~in_ref).any(1)
                              | ((ri >= 0) & ~in_got).any(1)).sum())

    ai, ad = got["ids"].to(dev).long(), got["dists"].to(dev)
    ai = torch.where(ai >= 0, ai, -1)
    bi, bd = ref["ids"], ref["dists"]
    have = ai >= 0
    out["ans_count"] = int((have.sum(1) != (bi >= 0).sum(1)).sum())
    a_true = distances(vectors, queries, ai)                # direct, f32
    b_true = distances(vectors, queries, bi)
    a_tol = _dist_bound(vectors, queries, ai, a_true, rtol)
    b_tol = _dist_bound(vectors, queries, bi, b_true, rtol)
    rel = torch.where(have, (ad - a_true).abs() / a_true.clamp(min=1e-30),
                      0.0)
    out["ans_dist"] = int((have & (rel > a_tol)).sum())
    out["ans_max_rel"] = float(rel.max()) if rel.numel() else 0.0
    kth = torch.where(bi >= 0, bd, -INF).max(1).values[:, None]
    a_in = ((ai[:, :, None] == bi[:, None, :]) & (bi[:, None, :] >= 0)).any(2)
    b_in = ((bi[:, :, None] == ai[:, None, :]) & have[:, None, :]).any(2)
    extra = have & ~a_in & (a_true > kth * (1 + a_tol))
    missing = (bi >= 0) & ~b_in & (b_true < kth * (1 - b_tol))
    out["ans_ids"] = int(extra.sum() + missing.sum())
    out["ans_differ"] = int(((have & ~a_in).any(1)
                             | ((bi >= 0) & ~b_in).any(1)).sum())
    return out


def _dist_bound(vectors, queries, ids, true, rtol):
    """(B, k) relative bound on an exact distance of ``ids``: ``rtol``, or
    the module note's (d + 2) u (|q|^2 + |x|^2) / r^2."""
    if rtol is not None:
        return torch.full_like(true, rtol)
    qn = (queries * queries).sum(1)[:, None]
    x = vectors[ids.clamp(min=0)]
    xn = (x * x).sum(-1)
    return (vectors.shape[1] + 2) * U * (qn + xn) / true.clamp(min=1e-30) ** 2


def breaches(counts: dict) -> int:
    """The sum of ``compare_codes`` / ``compare_answers``' breach counts."""
    return sum(v for key, v in counts.items()
               if key in ("mismatch", "cand_count", "cand_ids", "cand_adc",
                          "ans_count", "ans_ids", "ans_dist"))
