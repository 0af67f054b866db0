"""Execution backend behind the search API: the paper's Figure-1 seam.

    estimate(programs)                           -> (B,) selectivity p_hat
    search_graph(queries, programs, p_hat, opts) -> {"ids","dists",...}
    search_brute(queries, programs, opts)        -> (ids, dists)
    validate(opts)                               -> raises on options the
                                                    index cannot serve

``LocalBackend`` runs both routes on one device over a built FavorIndex's
tensors: the brute route as the f32 scan (``filtered_topk``) or, under
``use_pq``, the compressed scan of the index's codes plus an exact re-rank;
the graph route with the scorer ``graph_quant`` names.  The JAX package's
live delta segment (its compose branch) and the sharded backend come in
later slices of the port.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from . import exclusion, prefbf, selector
from . import filters as F
from .options import SearchOptions
from .scoring import scorer_for
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

    def validate(self, opts: SearchOptions) -> None:
        if opts.use_pq and self.index.codebook is None:
            raise ValueError("use_pq=True needs an index built with "
                             "quantize='pq' or 'sq' (BuildSpec.quant)")
        if (opts.graph_quant is not None
                and self.index.quantize != opts.graph_quant):
            raise ValueError(
                f"graph_quant={opts.graph_quant!r} needs an index built "
                f"with quantize={opts.graph_quant!r} codes "
                f"(this one has {self.index.quantize!r})")

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
        idx = self.index
        pv, pn, pi, pf = idx._pf
        if not opts.use_pq:
            return prefbf.prefbf_topk(pv, pn, pi, pf, queries, programs,
                                      k=opts.k, chunk=idx.prefbf_chunk)
        from ..quant import adc
        rr = opts.rerank if opts.rerank is not None else idx.rerank
        if idx.quantize == "pq":
            return adc.pq_prefbf_topk(idx._codes, pn, pi, pf, queries,
                                      programs, idx._cb_dev[0], pv, k=opts.k,
                                      rerank=rr, chunk=idx.prefbf_chunk)
        return adc.sq_prefbf_topk(idx._codes, *idx._cb_dev, pn, pi, pf,
                                  queries, programs, pv, k=opts.k, rerank=rr,
                                  chunk=idx.prefbf_chunk)

    def bytes_per_hop(self, opts: SearchOptions) -> int:
        """Bytes one gathered neighbour row streams under ``opts``' graph
        scorer."""
        return int(scorer_for(opts.search_config())
                   .bytes_per_row(self.index.g))
