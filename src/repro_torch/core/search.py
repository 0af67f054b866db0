"""Batched FAVOR graph traversal on the device (Algorithms 2 + 3).

The counterpart of the JAX package's ``core/search.py``:

 * the query batch runs as ONE loop whose state carries a lane per query;
   finished lanes are masked, the loop ends when all lanes do.  The JAX
   package's ``lax.while_loop`` becomes a Python loop over device tensors
   that reads one scalar back per wave (``any(active)``), one host sync per
   traversal step;
 * the candidate set C and result set R are fixed-capacity distance-sorted
   pools updated by a stable sort of (pool || new-neighbor-block) -- no
   dynamic heaps.  C capacity = ``cand_cap`` (default ef) is the
   bounded-memory approximation of the paper's unbounded heap;
 * neighbor-block scoring is pluggable (``core.scoring``, picked by
   ``SearchConfig.graph_quant``): f32 rows (``ExactScorer``, the
   ``gather_distance`` kernel), PQ codes (``PqAdcScorer``, the
   ``pq_adc_gather`` kernel) or SQ codes (``SqScorer``, plain torch).  One
   ``score_block`` call per block returns the exclusion distance (Eq. 2)
   and the TD bit of every gathered row.  The candidate pool C carries
   each entry's TD bit, so the expanded node's needs no second evaluation;
 * a live index's tombstones (``g["alive"]``) make dead rows non-target:
   they stay routable but are never returned;
 * quantized scorers get an exact f32 re-rank of the final top
   ``min(ef, max(k, graph_rerank * k))`` TD candidates
   (``quant.adc._exact_rerank``, the brute route's pass);
 * termination implements section 5.4: the usual adjusted-distance condition
   AND the TD-fraction guard ``pbar > pbar_min`` (0 disables);
 * the visited set is a packed per-query bitfield ``(B, ceil(N/32))`` of
   int64 words holding 32 bits each (torch has no uint32 arithmetic and no
   scatter-OR: bits are deduplicated within a block, then scatter-added);
 * the loop is *lane-compacted* (``SearchConfig.lane_compact``): a ladder of
   stage widths B, B/2, ... -- each stage exits once the active-lane
   population fits the next, survivors are packed into a half-width batch
   (every per-query leaf of the scorer state is sliced with them, the
   scorer's ``shared_state`` is not).  Results are identical to the
   single-stage loop because every per-lane op is row-wise and every scorer
   is bit-stable across batch widths; it sets the ``waves`` diagnostic;
 * inside a sampled trace's open span (``obs.trace.open_span``: the
   router's ``search`` span under ``graph``) the loop adds its counters to
   that span's attributes, summed over traversals: ``waves``, ``sync_ms``
   (the time blocked in each wave's sync, each inside a
   ``favor/graph/sync`` range under annotations), ``lanes_active`` /
   ``lanes_launched`` (active lanes and stage width, summed over waves),
   ``ids_launched`` (stage width x M0, the ids handed to ``score_block``)
   and ``ids_useful`` (of those, the valid ids not yet visited: a device
   scalar, read when the trace finishes).  Without one the loop tests a
   local for None twice a wave and runs no other op.

``favor_graph_search`` (exclusion distances) and ``rsf_graph_search``
(result-set-filtering baseline: D = 0, R admits TD only) are two thin entry
points over ONE traversal body.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import filters as F
from .hnsw import HnswIndex
from .scoring import scorer_for
from ..obs.trace import open_span

INF = float("inf")


@dataclass(frozen=True)
class SearchConfig:
    k: int = 10
    ef: int = 100
    cand_cap: int = 0          # 0 -> ef
    max_steps: int = 0         # 0 -> 8 * ef safety bound
    pbar_min: float = 0.5      # section 5.4 threshold (0 disables)
    gamma: float = 1.0         # Algorithm 3 line 8 slack
    graph_quant: str | None = None  # None (f32) | "pq" | "sq" scorer
    graph_rerank: int = 4      # exact-re-rank depth: top max(k, rr*k) TD
                               # candidates, capped at ef (quantized only)
    lane_compact: int = 2      # halve the wave width whenever the active-lane
                               # population fits the next stage, down to this
                               # floor (0 disables; results are identical)

    @property
    def ccap(self) -> int:
        return self.cand_cap or self.ef

    @property
    def steps(self) -> int:
        return self.max_steps or 8 * self.ef

    def stage_sizes(self, b: int) -> tuple[int, ...]:
        """The lane-count ladder the traversal runs through for a batch of
        ``b`` queries: full width first, then repeated halvings while the
        next stage still holds >= ``lane_compact`` lanes."""
        sizes = [b]
        if self.lane_compact > 0:
            while sizes[-1] // 2 >= self.lane_compact:
                sizes.append(sizes[-1] // 2)
        return tuple(sizes)


# ---------------------------------------------------------------------------
# Graph array preparation
# ---------------------------------------------------------------------------
def graph_topology(index: HnswIndex, device) -> dict:
    """The neighbor arrays and the entry point on ``device``."""
    upper = (np.stack(index.levels[1:], axis=0) if index.max_level >= 1
             else np.zeros((0, index.n, index.params.M), np.int32))
    return {
        "neighbors0": torch.as_tensor(index.levels[0], device=device),
        "upper": torch.as_tensor(upper, device=device),
        "entry": int(index.entry_point),
    }


def graph_arrays(index: HnswIndex, attrs: F.AttributeTable, device) -> dict:
    """Flatten an HnswIndex + attribute table to the device tensor dict the
    traversal consumes."""
    g = graph_topology(index, device)
    g.update({
        "vectors": torch.as_tensor(index.vectors, device=device),
        "norms": torch.as_tensor(index.norms.astype(np.float32),
                                 device=device),
        "attrs_int": torch.as_tensor(attrs.ints, device=device),
        "attrs_float": torch.as_tensor(attrs.floats, device=device),
    })
    return g


# ---------------------------------------------------------------------------
# Packed visited set: (B, ceil(N/32)) int64 words, 32 bits used per word
# ---------------------------------------------------------------------------
def _visited_words(n: int) -> int:
    return (n + 31) // 32


def _seen_bits(visited, rows, safe):
    """(B, W) words, (B, M) clamped ids -> (B, M) bool already-visited."""
    word = visited[rows[:, None], safe >> 5]
    return ((word >> (safe & 31)) & 1) > 0


def _visit_bits(visited, rows, safe, mark):
    """Set the bits for ``mark``-ed entries of ``safe``, in place.

    The scatter is an *add* (torch has no scatter-or), which is exact only if
    every bit lands at most once -- so duplicates of an id **within one
    block** are dropped from the scatter first.  ``mark`` itself is left
    untouched for pool admission.
    """
    m = safe.shape[1]
    col = torch.arange(m, device=safe.device)
    dup = ((safe[:, :, None] == safe[:, None, :])
           & mark[:, :, None] & mark[:, None, :]
           & (col[None, None, :] < col[None, :, None]))
    first = mark & ~dup.any(dim=2)
    bits = torch.where(first, torch.ones_like(safe) << (safe & 31),
                       torch.zeros_like(safe))
    visited.index_put_((rows[:, None].expand_as(safe), safe >> 5), bits,
                       accumulate=True)
    return visited


# ---------------------------------------------------------------------------
# Traversal building blocks
# ---------------------------------------------------------------------------
def _take_lanes(state: dict, sel, shared=()) -> dict:
    """Slice every per-query leaf of a scorer state (tensors and dicts of
    tensors, leading batch axis) to the lanes ``sel``; keys in ``shared``
    are query-independent and stay as they are."""
    out = {}
    for key, v in state.items():
        if key in shared:
            out[key] = v
        elif isinstance(v, dict):
            out[key] = {k: x[sel] for k, x in v.items()}
        else:
            out[key] = v[sel]
    return out


def _descend(g: dict, queries: torch.Tensor, scorer, sstate: dict):
    """Upper-layer greedy descent (no filtering), returns entry ids (B,)."""
    b = queries.shape[0]
    dev = queries.device
    zero = torch.zeros((b,), dtype=torch.float32, device=dev)  # plain d
    cur = torch.full((b,), g["entry"], dtype=torch.int64, device=dev)
    curd = scorer.score_block(g, sstate, cur[:, None], zero)[0][:, 0]
    for li in range(g["upper"].shape[0] - 1, -1, -1):
        level = g["upper"][li]
        moved = torch.ones((b,), dtype=torch.bool, device=dev)
        while bool(moved.any()):                  # one host sync per step
            nbrs = level[cur].long()              # (B, M)
            ok = nbrs >= 0
            safe = nbrs.clamp(min=0)
            d = torch.where(ok, scorer.score_block(g, sstate, safe, zero)[0],
                            INF)
            j = torch.argmin(d, dim=1, keepdim=True)   # first on ties
            best = d.gather(1, j)[:, 0]
            better = moved & (best < curd)
            cur = torch.where(better, safe.gather(1, j)[:, 0], cur)
            curd = torch.where(better, best, curd)
            moved = better
    return cur


def _gate_alive(key, td, alive, D):
    """Tombstones as non-target rows: ``td &= alive``, and ``key + D`` where
    the TD bit was set on a dead row.  A scorer returns dbar = d exactly for
    TD rows, so this gives the bits of ``exclusion_compose(d, td & alive,
    D)`` (the JAX package's gate)."""
    dead = td & ~alive
    return torch.where(dead, key + D, key), td & ~dead


def _merge_pool(pool_d, pool_i, pool_t, new_d, new_i, new_t, cap: int):
    """Merge (B, cap) pools with (B, M) new entries, keep best ``cap``
    (stable: pool entries and lower columns win ties).  Ineligible new
    entries must carry d=+inf."""
    d = torch.cat([pool_d, new_d], dim=1)
    i = torch.cat([pool_i, new_i], dim=1)
    t = torch.cat([pool_t, new_t], dim=1)
    order = torch.sort(d, dim=1, stable=True).indices[:, :cap]
    return d.gather(1, order), i.gather(1, order), t.gather(1, order)


def _graph_traverse(g: dict, queries: torch.Tensor, programs: dict,
                    D: torch.Tensor, cfg: SearchConfig, scorer, valid,
                    *, rsf: bool) -> dict:
    """The ONE traversal body behind favor_graph_search / rsf_graph_search.

    ``rsf=True`` is the Result-Set-Filtering baseline: callers pass D = 0,
    R admits only TD rows, and the section-5.4 pbar guard is off.
    """
    b = queries.shape[0]
    dev = queries.device
    n = g["vectors"].shape[0]
    ef, ccap = cfg.ef, cfg.ccap
    rows = torch.arange(b, device=dev)

    # optional live-index tombstone mask (N,) bool: dead nodes stay routable
    # (their edges still carry the walk) but are never target rows, so never
    # admitted to R as results -- the key is absent until the first delete,
    # so a static index runs exactly the ops it ran before
    alive = g.get("alive")

    traced = open_span()                             # (trace, span) or None
    count = (None if traced is None else
             dict(sync_ms=0.0, lanes_active=0, lanes_launched=0, ids_useful=0))
    sstate = scorer.prepare(g, queries, programs)
    ep = _descend(g, queries, scorer, sstate)        # (B,)

    # --- init pools with the entry point -----------------------------------
    ep_key, ep_td = scorer.score_block(g, sstate, ep[:, None], D)
    ep_key, ep_td = ep_key[:, 0], ep_td[:, 0]        # rsf: D = 0 -> plain d
    if alive is not None:
        ep_key, ep_td = _gate_alive(ep_key, ep_td, alive[ep], D)
    seed_ok = ep_td if rsf else torch.ones_like(ep_td)

    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    cand_d = torch.full((b, ccap), INF, **f32)
    cand_d[:, 0] = ep_key
    cand_i = torch.full((b, ccap), -1, **i64)
    cand_i[:, 0] = ep
    cand_t = torch.zeros((b, ccap), dtype=torch.bool, device=dev)
    cand_t[:, 0] = ep_td
    res_d = torch.full((b, ef), INF, **f32)
    res_d[:, 0] = torch.where(seed_ok, ep_key, INF)
    res_i = torch.full((b, ef), -1, **i64)
    res_i[:, 0] = torch.where(seed_ok, ep, -1)
    res_t = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    res_t[:, 0] = ep_td
    visited = torch.zeros((b, _visited_words(n)), **i64)
    visited[rows, ep >> 5] += torch.ones_like(ep) << (ep & 31)
    active = (torch.ones((b,), dtype=torch.bool, device=dev) if valid is None
              else torch.as_tensor(valid, dtype=torch.bool, device=dev).clone())

    def stage_loop(s, D, sstate, limit: int):
        """One loop over the (possibly compacted) lane set; ``limit > 0``
        also stops it once the active population fits the next stage."""
        width = s["active"].shape[0]
        lanes = torch.arange(width, device=dev)
        while s["step"] < cfg.steps:
            if count is None:
                n_active = int(s["active"].sum())     # one host sync a wave
            else:
                t = time.perf_counter()
                with traced[0].range("favor/graph/sync"):
                    n_active = int(s["active"].sum())
                count["sync_ms"] += (time.perf_counter() - t) * 1e3
            if n_active == 0 or (limit > 0 and n_active <= limit):
                break
            cand_d, cand_i, cand_t = s["cand_d"], s["cand_i"], s["cand_t"]
            res_d, res_i, res_t = s["res_d"], s["res_i"], s["res_t"]
            active = s["active"]

            # -- extract argmin of C (Algorithm 3 line 6) --------------------
            j = torch.argmin(cand_d, dim=1)
            da = cand_d[lanes, j]
            va = cand_i[lanes, j]
            va_td = cand_t[lanes, j]
            cand_d = cand_d.clone()
            cand_d[lanes, j] = torch.where(active, INF, da)

            # -- termination (line 8, with section 5.4 guard) ----------------
            worst = res_d.max(dim=1).values          # +inf while R not full
            full = torch.isfinite(worst)
            plain_term = (da > cfg.gamma * worst) & full
            if rsf or cfg.pbar_min <= 0.0:
                terminate = plain_term
            else:
                fin = torch.isfinite(res_d)
                n_valid = fin.sum(dim=1)
                n_td = (res_t & fin).sum(dim=1)
                pbar = n_td / n_valid.clamp(min=1)
                terminate = plain_term & (pbar > cfg.pbar_min)
            exhausted = ~torch.isfinite(da)
            new_active = active & ~terminate & ~exhausted
            expand = new_active                      # lanes that expand v_a

            # -- gather + score the neighbor block ---------------------------
            va_safe = va.clamp(min=0)
            nbrs = torch.where(expand[:, None],
                               g["neighbors0"][va_safe].long(), -1)  # (S, M0)
            ok = nbrs >= 0
            safe = nbrs.clamp(min=0)
            new = ok & ~_seen_bits(s["visited"], lanes, safe)
            visited = _visit_bits(s["visited"], lanes, safe, new)

            if count is not None:
                count["lanes_active"] += n_active
                count["lanes_launched"] += width
                count["ids_useful"] = count["ids_useful"] + new.sum()
            key, td = scorer.score_block(g, sstate, safe, D)  # Eq. 2
            if alive is not None:
                key, td = _gate_alive(key, td, alive[safe], D[:, None])

            # -- pool insertion (lines 15-24) --------------------------------
            worst_now = res_d.max(dim=1).values      # +inf when R not full
            eligible = new & (key < worst_now[:, None])
            res_ok = (eligible & td) if rsf else eligible
            res_d, res_i, res_t = _merge_pool(
                res_d, res_i, res_t,
                torch.where(res_ok, key, INF), torch.where(res_ok, nbrs, -1),
                td & res_ok, ef)
            cand_d, cand_i, cand_t = _merge_pool(
                cand_d, cand_i, cand_t, torch.where(eligible, key, INF),
                torch.where(eligible, nbrs, -1), td & eligible, ccap)

            s = {
                "cand_d": cand_d, "cand_i": cand_i, "cand_t": cand_t,
                "res_d": res_d, "res_i": res_i, "res_t": res_t,
                "visited": visited, "active": new_active,
                "step": s["step"] + 1,
                "hops": s["hops"] + expand.to(torch.int32),
                "path_td": s["path_td"] + (expand & va_td).to(torch.int32),
            }
        return s

    state = {
        "cand_d": cand_d, "cand_i": cand_i, "cand_t": cand_t,
        "res_d": res_d, "res_i": res_i, "res_t": res_t,
        "visited": visited, "active": active, "step": 0,
        "hops": torch.zeros((b,), dtype=torch.int32, device=dev),
        "path_td": torch.zeros((b,), dtype=torch.int32, device=dev),
    }

    # --- lane-compacted traversal: a ladder of stage widths -----------------
    # Each stage exits once the active population fits half its width; the
    # survivors are packed (active first, original order -- a stable sort on
    # the inactive flag) into the next stage and the finished lanes' pools
    # are scattered back into the full-width buffers.
    sizes = cfg.stage_sizes(b)
    out_keys = ("res_d", "res_i", "res_t", "hops", "path_td")
    final = {k: state[k] for k in out_keys}
    perm = torch.arange(b, device=dev)
    D_s, sstate_s = D, sstate
    for si in range(len(sizes)):
        limit = sizes[si + 1] if si + 1 < len(sizes) else 0
        state = stage_loop(state, D_s, sstate_s, limit)
        if len(sizes) == 1:
            final = {k: state[k] for k in out_keys}
            break
        for k in out_keys:
            final[k] = final[k].clone()
            final[k][perm] = state[k]
        if si + 1 < len(sizes):
            inactive = (~state["active"]).to(torch.uint8)
            sel = torch.sort(inactive, stable=True).indices[:sizes[si + 1]]
            perm = perm[sel]
            state = {k: (v if k == "step" else v[sel])
                     for k, v in state.items()}
            D_s = D_s[sel]
            sstate_s = _take_lanes(sstate_s, sel, scorer.shared_state)
    waves = state["step"]
    if count is not None:
        count.update(waves=waves, ids_launched=count["lanes_launched"]
                     * g["neighbors0"].shape[1])
        attrs = traced[1].attrs
        for key, v in count.items():
            attrs[key] = attrs.get(key, 0) + v

    # --- final S: k nearest TD in R (Algorithm 2 line 9) --------------------
    sd = torch.where(final["res_t"], final["res_d"], INF)  # TD: dbar == d
    if scorer.exact:
        order = torch.sort(sd, dim=1, stable=True).indices[:, :cfg.k]
        out_d = sd.gather(1, order)
        out_i = final["res_i"].gather(1, order)
    else:
        # quantized scorer: the pool holds approximate distances -- exact
        # f32 re-rank of the top-R TD candidates, as the brute route's
        # compressed scan does; R caps at ef (the pool size)
        from ..quant.adc import _exact_rerank
        r = min(ef, max(cfg.k, cfg.graph_rerank * cfg.k))
        order = torch.sort(sd, dim=1, stable=True).indices[:, :r]
        cand = torch.where(torch.isfinite(sd.gather(1, order)),
                           final["res_i"].gather(1, order), -1)
        out_i, out_d = _exact_rerank(g["vectors"], g["norms"], queries, cand,
                                     k=cfg.k)
    if valid is not None:
        vmask = torch.as_tensor(valid, dtype=torch.bool, device=dev)[:, None]
        out_d = torch.where(vmask, out_d, INF)
    out_i = torch.where(torch.isfinite(out_d), out_i, -1)
    return {"ids": out_i, "dists": out_d,
            "hops": final["hops"], "path_td": final["path_td"],
            # a wave is a batch-wide event (every co-resident lane pays it),
            # so each query reports the ladder's total wave count
            "waves": torch.full((b,), waves, dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# Public entry points (thin wrappers over the shared body)
# ---------------------------------------------------------------------------
def favor_graph_search(g: dict, queries: torch.Tensor, programs: dict,
                       D: torch.Tensor, cfg: SearchConfig,
                       valid=None) -> dict:
    """Batched OptiGreedySearch (Algorithm 3) with exclusion distances.

    g         : graph_arrays dict (tensors on the queries' device); for
                ``cfg.graph_quant`` it also carries the scorer's arrays
                (codes + centroids | sq_lo / sq_scale)
    queries   : (B, d) float32
    programs  : batched filter programs {valid (B,W), imask, flo, fhi}
    D         : (B,) per-query exclusion distance (Eq. 14, from p_hat)
    valid     : optional (B,) bool lane mask: False lanes start inactive and
                return ids=-1 / dists=+inf / hops=0
    returns   : {"ids": (B,k) int64 (-1 pad), "dists": (B,k) f32 (+inf pad),
                 "hops": (B,), "path_td": (B,), "waves": (B,) int32 -- total
                 loop iterations across the compaction ladder}
    """
    return _graph_traverse(g, queries, programs, D, cfg, scorer_for(cfg),
                           valid, rsf=False)


def rsf_graph_search(g: dict, queries: torch.Tensor, programs: dict,
                     cfg: SearchConfig, valid=None) -> dict:
    """Result-Set-Filtering baseline on the same machinery: D = 0 and R only
    admits TD (C takes everything)."""
    b = queries.shape[0]
    D = torch.zeros((b,), dtype=torch.float32, device=queries.device)
    return _graph_traverse(g, queries, programs, D, cfg, scorer_for(cfg),
                           valid, rsf=True)
