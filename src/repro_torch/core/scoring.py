"""Distance scorers for the graph traversal: one contract, three memory
formats (f32 rows, PQ codes, SQ codes).

FAVOR's exclusion-distance mechanism (Eq. 2) is scorer-agnostic: it reshapes
*whatever* distance distribution the traversal sees.  A scorer scores one
gathered neighbour block per call and returns, for every row, the adjusted
distance ``dbar = d + (1 - td) * D`` and the TD bit under the query's filter
program:

    prepare(g, queries, programs) -> state       # per-query device state
    score_block(g, state, ids, D) -> (dbar, td)  # (B, M) f32, (B, M) bool

``ExactScorer`` is one ``gather_distance`` call and ``PqAdcScorer`` one
``pq_adc_gather`` call: the hand-written kernels on CUDA tensors, their plain
versions on CPU tensors.  Both take the traversal's int64 ids as they are
(contiguous (B, M) blocks), so a CUDA call is two output allocations and
one launch.  ``SqScorer`` has no kernel in the JAX package
either and stays plain torch.  Every scorer reduces each (query, row) pair
on its own, so results do not depend on the batch width (the lane-compaction
ladder relies on that).

Scorers return *distance-scale* values (sqrt of the squared forms) so the
exclusion distance D composes identically whichever scorer runs.  The
quantized scorers are approximate (``exact = False``): the traversal
re-ranks their final TD candidates exactly.  State keys named in
``shared_state`` are query-independent: the ladder leaves them alone and
slices every other state leaf per lane.

``bytes_per_row`` is what one gathered neighbour row streams from device
memory -- 4*d for f32, M codes for PQ, d codes for SQ; ``required_keys``
names the ``g`` arrays a scorer reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import torch

from . import filters as F
from ..kernels.gather_distance import ops as gd_ops
from ..kernels.pq_adc import ops as pq_ops


def exclusion_compose(d, td, D):
    """Eq. 2: adjusted distance ``d + D`` for non-target rows, ``d`` for TD
    rows (``D`` broadcasts against ``d``).  Order-preserving within each
    class: two TD rows (or two non-TD rows) get the same constant added."""
    return d + torch.where(td, 0.0, D)


@runtime_checkable
class Scorer(Protocol):
    """Distance scorer contract consumed by the traversal."""

    kind: str    # "exact" | "pq" | "sq" -- the SearchOptions.graph_quant name
    exact: bool  # True -> score_block returns true f32 distances (no re-rank)

    def required_keys(self) -> tuple[str, ...]:
        """``g`` arrays this scorer reads."""
        ...

    def prepare(self, g: dict, queries, programs: dict) -> dict:
        """Per-query device state built once before the traversal loop."""
        ...

    def score_block(self, g: dict, state: dict, ids, D):
        """(dbar (B, M) f32, td (B, M) bool) for the gathered DB rows
        ``ids`` (>= 0) under the per-query exclusion distance D (B,)."""
        ...

    def bytes_per_row(self, g: dict) -> int:
        """Bytes one gathered neighbour row streams from device memory."""
        ...


@dataclass(frozen=True)
class ExactScorer:
    """Full-precision float32 scoring."""
    kind = "exact"
    exact = True
    shared_state = ()

    def required_keys(self) -> tuple[str, ...]:
        return ("vectors", "norms")

    def prepare(self, g: dict, queries, programs: dict) -> dict:
        return {"q": queries, "programs": programs}

    def score_block(self, g: dict, state: dict, ids, D):
        """ids (B, M) contiguous int32 / int64 row ids >= 0, D (B,) f32 ->
        (dbar (B, M) f32, td (B, M) bool); D = 0 gives plain distances."""
        return gd_ops.gather_distance(
            g["vectors"], g["norms"], g["attrs_int"], g["attrs_float"],
            state["q"], ids, state["programs"], D)

    def bytes_per_row(self, g: dict) -> int:
        return 4 * int(g["vectors"].shape[1])


@dataclass(frozen=True)
class PqAdcScorer:
    """Compressed scoring: per-query ADC LUTs + gathered uint8 codes.

    ``prepare`` builds the (B, M, K) squared-subdistance tables once
    (``quant.adc.build_luts``) and stores them bfloat16 by default (torch's
    f32 -> bf16 cast rounds to nearest even, as XLA's does); every lookup
    widens back to float32 before the subspace sum.
    """
    lut_bf16: bool = True
    kind = "pq"
    exact = False
    shared_state = ()

    def required_keys(self) -> tuple[str, ...]:
        return ("codes", "centroids")

    def prepare(self, g: dict, queries, programs: dict) -> dict:
        from ..quant.adc import build_luts
        luts = build_luts(g["centroids"], queries)
        if self.lut_bf16:
            luts = luts.to(torch.bfloat16)
        return {"luts": luts, "programs": programs}

    def score_block(self, g: dict, state: dict, ids, D):
        return pq_ops.pq_adc_gather(
            g["codes"], state["luts"], ids, ints=g["attrs_int"],
            floats=g["attrs_float"], programs=state["programs"], dvec=D)

    def bytes_per_row(self, g: dict) -> int:
        return int(g["codes"].shape[1])

    def lut_bytes(self, g: dict, batch: int) -> int:
        """Bytes of the (batch, M, K) LUT state ``prepare`` builds."""
        m, k = int(g["centroids"].shape[0]), int(g["centroids"].shape[1])
        return (2 if self.lut_bf16 else 4) * batch * m * k


@dataclass(frozen=True)
class SqScorer:
    """Scalar-quantization scoring: gathered int8 codes contracted against
    folded affine weights.  With x = c*s + lo (per-dim scale/offset) the
    squared distance folds to

        d2 = sum_j c_j^2 s_j^2                      (query-independent)
           + sum_j c_j * (2 s_j lo_j - 2 q_j s_j)   (per-query linear)
           + ||lo||^2 + ||q||^2 - 2 q.lo            (per-query constant)

    so ``prepare`` bakes the three weight groups once per batch and
    ``score_block`` touches the gathered codes once.  Both contractions are
    multiply + last-axis reduce, so a lane's distances do not depend on the
    batch width.
    """
    kind = "sq"
    exact = False
    shared_state = ("w2",)      # (d,), query-independent

    def required_keys(self) -> tuple[str, ...]:
        return ("codes", "sq_lo", "sq_scale")

    def prepare(self, g: dict, queries, programs: dict) -> dict:
        s, lo = g["sq_scale"], g["sq_lo"]
        qn = (queries * queries).sum(dim=-1)
        return {
            "w2": s * s,
            "w_lin": 2.0 * s[None, :] * (lo[None, :] - queries),
            "const": ((lo * lo).sum() + qn
                      - 2.0 * (queries * lo[None, :]).sum(dim=-1)),
            "programs": programs,
        }

    def score_block(self, g: dict, state: dict, ids, D):
        safe = ids.long()
        c = g["codes"][safe].to(torch.float32)                # (B, M, d)
        quad = (c * c * state["w2"]).sum(dim=-1)
        lin = (c * state["w_lin"][:, None, :]).sum(dim=-1)
        d = torch.sqrt(torch.clamp(quad + lin + state["const"][:, None],
                                   min=0.0))
        td = F.eval_program_gathered(state["programs"], g["attrs_int"][safe],
                                     g["attrs_float"][safe])
        return exclusion_compose(d, td, D[:, None]), td

    def bytes_per_row(self, g: dict) -> int:
        return int(g["codes"].shape[1])


def scorer_for(cfg) -> Scorer:
    """The scorer a SearchConfig asks for (``cfg.graph_quant``, validated
    by ``SearchOptions``)."""
    return {None: ExactScorer, "pq": PqAdcScorer,
            "sq": SqScorer}[cfg.graph_quant]()
