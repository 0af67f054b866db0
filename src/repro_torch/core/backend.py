"""Execution backend behind the search API: the paper's Figure-1 seam.

    estimate(programs)                           -> (B,) selectivity p_hat
    search_graph(queries, programs, p_hat, opts) -> {"ids","dists",...}
    search_brute(queries, programs, opts)        -> (ids, dists)

``LocalBackend`` runs both routes on one device over a built FavorIndex's
tensors.  The JAX package's live delta segment (its compose branch) and the
sharded backend come in later slices of the port.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from . import exclusion, prefbf, selector
from . import filters as F
from .options import SearchOptions
from .search import favor_graph_search

if TYPE_CHECKING:
    from .favor import FavorIndex


class LocalBackend:
    """Single-device execution over a built FavorIndex's tensors."""

    def __init__(self, index: "FavorIndex"):
        self.index = index

    @property
    def schema(self) -> F.Schema:
        return self.index.schema

    @property
    def sel_cfg(self) -> selector.SelectorConfig:
        return self.index.sel_cfg

    @property
    def device(self) -> torch.device:
        return self.index.device

    def estimate(self, programs: dict) -> torch.Tensor:
        return selector.estimate_batched(programs, self.index.sample_ints,
                                         self.index.sample_floats)

    def search_graph(self, queries, programs: dict, p_hat,
                     opts: SearchOptions) -> dict:
        idx = self.index
        D = exclusion.exclusion_distance(p_hat, opts.ef, idx.delta_d,
                                         k=opts.k, p_min=idx.sel_cfg.p_min,
                                         xp=torch)
        return favor_graph_search(idx.g, queries, programs, D,
                                  opts.search_config())

    def search_brute(self, queries, programs: dict, opts: SearchOptions):
        pv, pn, pi, pf = self.index._pf
        return prefbf.prefbf_topk(pv, pn, pi, pf, queries, programs,
                                  k=opts.k, chunk=self.index.prefbf_chunk)
