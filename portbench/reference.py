"""The plain reference: exact filtered top-k and the comparison that decides
``correct``.

Plain torch, float32 with TF32 off.  It evaluates the traffic's filter
specs itself, straight from the attribute columns, and computes every
distance from the benchmark's own vectors; it reads the program's answers
only to judge them.  It imports nothing of the program.

Numbers compared, each against the configuration's limit:

* ``bad_ids``: returned ids that are out of range, repeated within an
  answer, fail the query's filter, or break the answer's order (ids after
  a -1, distances not ascending, a finite distance without an id).  The
  filter is the system's guarantee: exact, limit 0.
* ``short``: answers with fewer ids than min(k, rows passing the filter).
* ``dist_gap``: the largest |returned distance - the reference's distance
  of that id| / the reference's distance, over every returned id.
* ``exact_gap``: over the answers the selector sent to the exact route
  (the brute scan), the largest |returned distance - the reference's
  top-k distance| / the latter, rank by rank: an exact route returns the
  k nearest passing rows, so its list of distances is the reference's,
  whichever id wins a tie.  A missing answer where the reference has one
  reads infinite.
"""
from __future__ import annotations

import contextlib

import torch

QUERY_BLOCK = 256      # queries per distance block of the reference


@contextlib.contextmanager
def ieee_f32():
    """matmuls in IEEE float32 inside the block (TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 explicit mantissa bits, nearest, ties
    away): the operand precision of the tensor cores' TF32 mode."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def eval_spec(spec, cols: dict) -> torch.Tensor:
    """(N,) bool: the rows whose attributes satisfy ``spec``; ``cols`` maps a
    column name to its (N,) tensor."""
    op = spec[0]
    if op == "and":
        out = eval_spec(spec[1], cols)
        for s in spec[2:]:
            out = out & eval_spec(s, cols)
        return out
    if op == "or":
        out = eval_spec(spec[1], cols)
        for s in spec[2:]:
            out = out | eval_spec(s, cols)
        return out
    if op == "not":
        return ~eval_spec(spec[1], cols)
    col = cols[spec[1]]
    if op == "eq":
        return col == spec[2]
    if op == "in":
        return torch.isin(col, torch.as_tensor(spec[2], dtype=col.dtype,
                                               device=col.device))
    if op == "range":
        return (col >= spec[2]) & (col <= spec[3])
    raise ValueError(f"unknown filter op {op!r}")


def topk(vectors: torch.Tensor, queries: torch.Tensor, specs: list,
         cols: dict, k: int, *, tf32: bool = False):
    """Exact filtered top-k of each query: (ids (Q, k) int64, -1 padded;
    distances (Q, k) f32, +inf padded; passing row counts (Q,)).  The
    distances of the ids are recomputed as the norm of the difference.
    ``tf32`` rounds the operands to TF32 first (the control)."""
    q_all = queries
    v = to_tf32(vectors) if tf32 else vectors
    vn = (v * v).sum(dim=1)
    ids, dists, passing = [], [], []
    with ieee_f32():
        for s in range(0, q_all.shape[0], QUERY_BLOCK):
            q = q_all[s:s + QUERY_BLOCK]
            qq = to_tf32(q) if tf32 else q
            d2 = vn[None, :] - 2.0 * (qq @ v.T) + (qq * qq).sum(1)[:, None]
            mask = torch.stack([eval_spec(sp, cols)
                                for sp in specs[s:s + QUERY_BLOCK]])
            d2 = torch.where(mask, d2, float("inf"))
            kk = min(k, d2.shape[1])
            val, pos = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
            found = torch.isfinite(val)
            pos = torch.where(found, pos, -1)
            if tf32:
                dist = torch.sqrt(torch.clamp(val, min=0.0))
            else:
                dist = pair_distances(vectors, q, pos)
            ids.append(pos)
            dists.append(torch.where(found, dist, float("inf")))
            passing.append(mask.sum(1))
            del d2, mask
    return torch.cat(ids), torch.cat(dists), torch.cat(passing)


def pair_distances(vectors: torch.Tensor, queries: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """(Q, k) f32 |q - v_id| for the ids >= 0 (+inf for -1)."""
    rows = vectors[ids.clamp(min=0)]
    d = torch.sqrt(((rows - queries[:, None, :]) ** 2).sum(-1))
    return torch.where(ids >= 0, d, float("inf"))


def compare(vectors: torch.Tensor, queries: torch.Tensor, specs: list,
            cols: dict, got_ids: torch.Tensor, got_d: torch.Tensor,
            exact_route: torch.Tensor, k: int, *, ref=None) -> dict:
    """The numbers of the module note, for answers (Q, k) of the queries
    (Q, d); ``exact_route`` (Q,) bool marks the answers of the exact route.
    ``ref`` is ``topk``'s output for these queries when already computed.
    Also returns per-query ``recall`` (Q,) and ``failed`` (Q,) bool."""
    n = vectors.shape[0]
    ref_i, ref_d, passing = ref if ref is not None else topk(
        vectors, queries, specs, cols, k)
    dev = vectors.device
    got_ids = got_ids.to(dev)
    got_d = got_d.to(dev)
    have = got_ids >= 0
    in_range = (got_ids >= -1) & (got_ids < n)
    # order: ids then -1s, ascending finite distances, distance iff id
    after_pad = torch.cumsum((~have).to(torch.int32), 1) > 0
    order_bad = (have & after_pad).sum(1)
    order_bad += (have != torch.isfinite(got_d)).sum(1)
    fin = torch.where(have, got_d, float("inf"))
    order_bad += (fin[:, 1:] < fin[:, :-1]).sum(1)
    safe = torch.where(have & in_range, got_ids, 0)
    dup = ((safe[:, :, None] == safe[:, None, :]) & have[:, :, None]
           & have[:, None, :]
           & ~torch.eye(k, dtype=torch.bool, device=dev)[None]).any(2)
    passes = torch.stack([eval_spec(sp, cols)[row]
                          for sp, row in zip(specs, safe)])
    bad = ((have & ~in_range) | (have & ~passes) | dup).sum(1) + order_bad
    want = torch.clamp(passing, max=k)
    short = have.sum(1) < want
    with ieee_f32():
        true_d = pair_distances(vectors, queries.to(dev), safe)
    rel = torch.where(have & in_range,
                      (got_d - true_d).abs() / true_d.clamp(min=1e-30), 0.0)
    dist_gap = rel.max(1).values
    rank_ok = torch.isfinite(ref_d)
    gap = torch.where(rank_ok, (fin - ref_d).abs() / ref_d.clamp(min=1e-30),
                      torch.where(have, float("inf"), 0.0))
    exact_gap = torch.where(exact_route.to(dev), gap.max(1).values, 0.0)
    hit = ((got_ids[:, :, None] == ref_i[:, None, :]) & have[:, :, None]
           & (ref_i[:, None, :] >= 0)).any(2).sum(1)
    recall = hit / want.clamp(min=1)
    recall = torch.where(want > 0, recall, 1.0)
    return {"bad_ids": bad, "short": short, "dist_gap": dist_gap,
            "exact_gap": exact_gap, "recall": recall, "passing": passing}
