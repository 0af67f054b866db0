"""Execution backend behind the search API: the paper's Figure-1 seam.

    estimate(programs, valid)                    -> (B,) selectivity p_hat
    search_graph(queries, programs, p_hat, opts, valid) -> {"ids","dists",...}
    search_brute(queries, programs, opts, valid) -> (ids, dists)
    validate(opts)                               -> raises on options the
                                                    index cannot serve
    version() / versions()                       -> data epochs (aggregate /
                                                    per component)

``valid`` is the bucket-padding contract (core.batching): rows with
``valid=False`` are pad rows -- they carry always-false filter programs,
return ids=-1 / dists=+inf and never influence real rows; ``None`` means
every row is real.

``LocalBackend`` runs both routes on one device over a built FavorIndex's
tensors: the brute route as the f32 scan (``filtered_topk``) or, under
``use_pq``, the compressed scan of the index's codes plus an exact re-rank;
the graph route with the scorer ``graph_quant`` names.  A live index's
delta segment is scanned exactly and composed into both routes' results
on the device; tombstones are +inf norms on the brute scans and the
``alive`` gate of the traversal.  The mutation API (``upsert`` / ``delete``
/ ``merge`` and the background merge's ``merge_prepare`` / ``merge_commit``)
passes through to the FavorIndex.  The scans and the traversal run inside
``obs.profiling.annotate`` ranges (named as in the JAX package) when kernel
annotations are on.  The sharded backend comes in a later slice of the
port.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from . import exclusion, prefbf, selector
from . import filters as F
from .options import SearchOptions
from .scoring import scorer_for
from .search import favor_graph_search
from ..index.delta import compose_topk_dev
# gated host-side profiler ranges (nullcontext unless ObsSpec enables
# kernel annotations); obs.profiling imports nothing from core
from ..obs.profiling import annotate as _annotate

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

    @property
    def dim(self) -> int:
        """Query vector dimensionality (warmup builds its batches off it)."""
        return int(self.index.index.dim)

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

    def version(self) -> int:
        """Data epoch of the underlying FavorIndex: bumped whenever the
        served rows change."""
        return self.index.version()

    def versions(self) -> dict:
        """Scoped epochs (index subsystem): vectors / attributes / graph."""
        return self.index.versions()

    # -- live mutation passthrough (index subsystem) --------------------------
    def upsert(self, vectors, ints=None, floats=None, *, replace=None):
        return self.index.upsert(vectors, ints, floats, replace=replace)

    def delete(self, ids):
        return self.index.delete(ids)

    def merge(self, *, wave: int = 512) -> dict:
        return self.index.merge(wave=wave)

    def merge_prepare(self, *, wave: int = 512, on_wave=None):
        """Background-merge phase 1 (no served-state mutation); see
        FavorIndex.merge_prepare."""
        return self.index.merge_prepare(wave=wave, on_wave=on_wave)

    def merge_commit(self, prep):
        """Background-merge phase 2 (cheap atomic swap); see
        FavorIndex.merge_commit."""
        return self.index.merge_commit(prep)

    def live_view(self):
        return self.index.live_view()

    def live_stats(self) -> dict:
        return self.index.live_stats()

    def _delta(self):
        """The live delta segment when it has rows to serve, else None."""
        live = self.index.live
        if live is None or live.delta.live_count == 0:
            return None
        return live.delta

    # -- routes ---------------------------------------------------------------
    def estimate(self, programs: dict, valid=None) -> torch.Tensor:
        # pad rows carry always-false programs (p_hat 0): no mask needed
        if self.index.sample_ints.shape[0] == 0:
            # empty base (delta-only index): no sample to estimate over --
            # p_hat = 1 keeps everything on the graph/compose path
            b = int(programs["valid"].shape[0])
            return torch.ones((b,), dtype=torch.float32, device=self.device)
        return selector.estimate_batched(programs, self.index.sample_ints,
                                         self.index.sample_floats)

    def search_graph(self, queries, programs: dict, p_hat,
                     opts: SearchOptions, valid=None) -> dict:
        idx = self.index
        if idx.index.n > 0:
            p_hat = torch.as_tensor(p_hat, dtype=torch.float32,
                                    device=self.device)
            D = exclusion.exclusion_distance(p_hat, opts.ef, idx.delta_d,
                                             k=opts.k,
                                             p_min=idx.sel_cfg.p_min,
                                             xp=torch)
            with _annotate("favor/local/graph_search"):
                base = favor_graph_search(idx.g, queries, programs, D,
                                          opts.search_config(), valid=valid)
        else:
            b, dev = int(queries.shape[0]), self.device
            zero = torch.zeros((b,), dtype=torch.int32, device=dev)
            base = {"ids": torch.full((b, opts.k), -1, dtype=torch.int64,
                                      device=dev),
                    "dists": torch.full((b, opts.k), float("inf"),
                                        dtype=torch.float32, device=dev),
                    "hops": zero, "path_td": zero, "waves": zero}
        delta = self._delta()
        if delta is None:
            return base
        gi, gd = delta.scan_dev(queries, programs, k=opts.k, valid=valid)
        out = dict(base)
        out["ids"], out["dists"] = compose_topk_dev(base["ids"],
                                                    base["dists"], gi, gd,
                                                    opts.k)
        return out

    def search_brute(self, queries, programs: dict, opts: SearchOptions,
                     valid=None):
        idx = self.index
        pv, pn, pi, pf = idx._pf
        if idx.index.n == 0:
            # empty base (delta-only index): nothing to scan
            b, dev = int(queries.shape[0]), self.device
            ids = torch.full((b, opts.k), -1, dtype=torch.int64, device=dev)
            dists = torch.full((b, opts.k), float("inf"), dtype=torch.float32,
                               device=dev)
        elif not opts.use_pq:
            with _annotate("favor/local/prefbf_scan"):
                ids, dists = prefbf.prefbf_topk(pv, pn, pi, pf, queries,
                                                programs, k=opts.k,
                                                chunk=idx.prefbf_chunk,
                                                valid=valid)
        else:
            from ..quant import adc
            rr = opts.rerank if opts.rerank is not None else idx.rerank
            if idx.quantize == "pq":
                with _annotate("favor/local/pq_adc_scan"):
                    ids, dists = adc.pq_prefbf_topk(
                        idx._codes, pn, pi, pf, queries, programs,
                        idx._cb_dev[0], pv, k=opts.k, rerank=rr,
                        chunk=idx.prefbf_chunk, valid=valid)
            else:
                with _annotate("favor/local/sq_adc_scan"):
                    ids, dists = adc.sq_prefbf_topk(
                        idx._codes, *idx._cb_dev, pn, pi, pf, queries,
                        programs, pv, k=opts.k, rerank=rr,
                        chunk=idx.prefbf_chunk, valid=valid)
        delta = self._delta()
        if delta is None:
            return ids, dists
        # delta rows are scanned exact f32 even under use_pq: the buffer is
        # small, so exactness is free and only sharpens the compressed route
        gi, gd = delta.scan_dev(queries, programs, k=opts.k, valid=valid)
        return compose_topk_dev(ids, dists, gi, gd, opts.k)

    def bytes_per_hop(self, opts: SearchOptions) -> int:
        """Bytes one gathered neighbour row streams under ``opts``' graph
        scorer."""
        return int(scorer_for(opts.search_config())
                   .bytes_per_row(self.index.g))
