"""Distance scoring for the graph traversal (exact f32 only in this port).

FAVOR's exclusion-distance mechanism (Eq. 2) is scorer-agnostic: it reshapes
*whatever* distance distribution the traversal sees.  ``ExactScorer`` scores
one gathered neighbor block per call and returns, for every row, the
adjusted distance ``dbar = d + (1 - td) * D`` and the TD bit under the
query's filter program -- one ``gather_distance`` call, which launches the
hand-written kernel on CUDA tensors and runs its plain version (gather +
multiply-reduce, each (b, m) pair reduced on its own so results do not
depend on the batch width) on CPU tensors.  The JAX package's compressed
scorers (PQ-ADC, SQ) come with the compressed routes in slice 2 of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.gather_distance import ops as gd_ops


@dataclass(frozen=True)
class ExactScorer:
    """Full-precision float32 scoring."""

    def prepare(self, g: dict, queries, programs: dict) -> dict:
        return {"q": queries, "programs": programs}

    def score_block(self, g: dict, state: dict, ids, D):
        """ids (B, M) row ids >= 0, D (B,) f32 -> (dbar (B, M) f32,
        td (B, M) bool); D = 0 gives plain distances."""
        return gd_ops.gather_distance(
            g["vectors"], g["norms"], g["attrs_int"], g["attrs_float"],
            state["q"], ids.to(torch.int32).contiguous(), state["programs"],
            D)
