"""Pluggable execution backends behind the search API: the paper's
Figure-1 seam.  ``router.execute`` owns the host-side pipeline (compile ->
estimate -> route -> partition); a ``Backend`` owns the device-side
execution of each route:

    estimate(programs, valid)                    -> (B,) selectivity p_hat
    search_graph(queries, programs, p_hat, opts, valid) -> {"ids","dists",...}
    search_brute(queries, programs, opts, valid) -> (ids, dists)
    validate(opts)                               -> raises on options the
                                                    backend cannot serve
    version() / versions()                       -> data epochs (aggregate /
                                                    per component)

``valid`` is the bucket-padding contract (core.batching): rows with
``valid=False`` are pad rows -- they carry always-false filter programs,
return ids=-1 / dists=+inf and never influence real rows; ``None`` means
every row is real.

Two implementations ship here:

  LocalBackend   -- one device, over a built FavorIndex's tensors: the brute
                    route as the f32 scan (``filtered_topk``) or, under
                    ``use_pq``, the compressed scan of the index's codes
                    plus an exact re-rank; the graph route with the scorer
                    ``graph_quant`` names.  The mutation API passes through
                    to the FavorIndex.
  ShardedBackend -- a mesh of devices over ``distributed.make_serve_fns``
                    (DB rows and their codes sharded on "model", queries on
                    "data"): every shard runs the same scans and traversal
                    on its rows, then the per-shard top-k are merged on the
                    mesh's first device.  One process drives every cell; a
                    mesh may put several shards on one card.  Its live index
                    keeps the delta segment host-replicated and the
                    tombstones per shard; a merge rebuilds every shard with
                    headroom in the last one, or grows only the last shard
                    into that headroom (``merge_prepare``).

Both expose ``schema`` / ``sel_cfg`` so the router takes identical routing
decisions wherever execution lands, and ``device``, where queries, programs
and results live.  A live index's delta segment is scanned exactly and
composed into both routes' results on the device; tombstones are +inf
norms on the brute scans and the ``alive`` gate of the traversal.  Their
host ranges are the router's spans (``favor/graph/search``,
``favor/brute/search``: ``obs.trace``), under kernel annotations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Protocol, runtime_checkable

import numpy as np
import torch

from . import distributed as dist
from . import exclusion, prefbf, selector
from . import filters as F
from .options import BuildSpec, SearchOptions
from .scoring import scorer_for
from .search import favor_graph_search
from ..device import to_host
from ..index.delta import compose_topk_dev
from ..index.epochs import ComponentEpochs
from ..index.live import LiveState

if TYPE_CHECKING:
    from .favor import FavorIndex


@dataclass
class _ShardMergePrep:
    """Off-thread-prepared sharded merge, ready for an atomic commit.
    ``kind`` is "incr" (grow the last shard in place) or "full" (fresh
    build_sharded with headroom); ``graph_epoch`` guards staleness."""
    kind: str
    from_slot: int
    n_live: int
    graph_epoch: int
    base_n: int
    shard: int = -1
    index: object = None       # incr: the grown last-shard HnswIndex
    vectors: object = None     # incr: snapshot delta rows
    ints: object = None
    floats: object = None
    codes: object = None
    sharded: object = None     # full: the rebuilt ShardedFavorArrays
    parts: object = None       # full: per-shard index handles
    n_tot: int = -1


@runtime_checkable
class Backend(Protocol):
    """Execution backend contract consumed by router.execute / ServeEngine.

    The search methods take an optional ``valid`` (B,) bool mask (the
    bucket-padding contract, core.batching): rows with ``valid=False`` are
    pad rows -- they carry always-false filter programs, must return
    ids=-1 / dists=+inf, and must never influence real rows.  ``valid=None``
    means every row is real."""

    schema: F.Schema
    sel_cfg: selector.SelectorConfig

    def validate(self, opts: SearchOptions) -> None:
        """Raise ValueError when ``opts`` cannot run on this backend."""
        ...

    def version(self) -> int:
        """Monotonic data epoch: bumped whenever the served rows change, so
        layered caches (cache.CachingBackend) can drop stale entries."""
        ...

    def estimate(self, programs: dict, valid=None):
        """(B,) estimated selectivity over the backend's sample.  Device
        backends may ignore ``valid`` (always-false pad programs estimate
        to 0); host-side layers use it to keep pad rows out of their
        caches."""
        ...

    def search_graph(self, queries, programs: dict, p_hat,
                     opts: SearchOptions, valid=None) -> dict:
        """Exclusion-distance graph route; returns at least ids/dists."""
        ...

    def search_brute(self, queries, programs: dict, opts: SearchOptions,
                     valid=None):
        """PreFBF brute route (float32 or compressed); returns (ids, dists)."""
        ...

    def bytes_per_hop(self, opts: SearchOptions) -> int:
        """Bytes one gathered neighbour row streams from device memory under
        ``opts``' graph scorer (4*d for f32, M codes for PQ, d for SQ)."""
        ...


# ---------------------------------------------------------------------------
# Local (single-device) backend
# ---------------------------------------------------------------------------
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
            ids, dists = prefbf.prefbf_topk(pv, pn, pi, pf, queries,
                                            programs, k=opts.k,
                                            chunk=idx.prefbf_chunk,
                                            valid=valid)
        else:
            from ..quant import adc
            rr = opts.rerank if opts.rerank is not None else idx.rerank
            if idx.quantize == "pq":
                ids, dists = adc.pq_prefbf_topk(
                    idx._codes, pn, pi, pf, queries, programs,
                    idx._cb_dev[0], pv, k=opts.k, rerank=rr,
                    chunk=idx.prefbf_chunk, valid=valid)
            else:
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


# ---------------------------------------------------------------------------
# Sharded (mesh) backend
# ---------------------------------------------------------------------------
class ShardedBackend:
    """Mesh serve path: DB rows (and their codes) sharded on ``model_axis``,
    query batches split on ``query_axes``.

    Serve-step sets are built lazily from ``distributed.make_serve_fns`` and
    cached on the SearchConfig, as the JAX package caches its compiled
    executables.  Queries, programs, p_hat and merged results live on
    ``device``, the mesh's first device.
    """

    def __init__(self, mesh: dist.Mesh, sharded: dist.ShardedFavorArrays,
                 schema: F.Schema, *, sel_cfg=None, codebook=None,
                 rerank: int = 4, prefbf_chunk: int = 65536,
                 query_axes=("data",), model_axis: str = "model",
                 hnsw_params=None, seed: int = 0,
                 merge_headroom: float = 1.0):
        self.mesh = mesh
        self.schema = schema
        self.sel_cfg = sel_cfg or selector.SelectorConfig()
        self.rerank = rerank
        self.prefbf_chunk = prefbf_chunk
        self.query_axes = tuple(query_axes)
        self.model_axis = model_axis
        self.codebook = codebook
        self.hnsw_params = hnsw_params   # needed by merge() to rebuild shards
        self.seed = seed
        if codebook is not None and sharded.quant is None:
            sharded = dist.attach_quant(sharded, codebook, device=self.device)
        self.sharded = sharded
        self.quant = sharded.quant
        self._fns_cache: dict = {}
        self.db = dist.place_sharded_db(
            sharded.arrays, mesh, dist.db_specs(model_axis, self.quant))
        self._qmult = 1
        for ax in self.query_axes:
            self._qmult *= mesh.shape[ax]
        # live mutation state (index subsystem): the delta segment is
        # replicated host-side (it is small) and scanned unsharded after the
        # cross-shard merge; only the tombstone mask is sharded
        self.epochs = ComponentEpochs()
        self.shard_epochs = [0] * sharded.n_shards
        self._live: LiveState | None = None
        self._live_active = False   # db carries an "alive" array
        # incremental-merge state: the per-shard HnswIndex handles (kept by
        # build()/full merges) and the headroom fraction -- a full-rebuild
        # merge reserves ~merge_headroom x the merged delta as dead tail rows
        # in the LAST shard, which later merges fill in place by growing just
        # that shard's graph instead of rebuilding every shard
        self.merge_headroom = float(merge_headroom)
        self._shard_indexes: list | None = None

    @property
    def device(self) -> torch.device:
        """The mesh's first device: queries, programs and results live
        there."""
        return self.mesh.first_device

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, vectors: np.ndarray, attrs: F.AttributeTable, mesh,
              spec: BuildSpec | None = None, *, codebook=None,
              query_axes=("data",), model_axis: str = "model",
              seed: int = 0) -> "ShardedBackend":
        """Build per-shard HNSWs on the host (+ optional codebook, trained on
        the mesh's first device) straight from the raw vectors and attach
        them to ``mesh``."""
        spec = spec or BuildSpec()
        if spec.quant is not None and codebook is not None:
            from .. import quant
            q = spec.quant
            cb_kind = ("pq" if isinstance(codebook, quant.PQCodebook)
                       else "sq")
            if cb_kind != q.kind:
                raise ValueError(f"spec.quant.kind={q.kind!r} does not match "
                                 f"the supplied {cb_kind!r} codebook")
            if cb_kind == "pq" and ((codebook.m, codebook.nbits)
                                    != (q.m, q.nbits)):
                raise ValueError(
                    f"spec.quant geometry (m={q.m}, nbits={q.nbits}) does not "
                    f"match the supplied codebook (m={codebook.m}, "
                    f"nbits={codebook.nbits})")
        n_shards = mesh.shape[model_axis]
        sharded, parts = dist.build_sharded(
            vectors, attrs, n_shards, spec.hnsw,
            sample_rate=spec.selector.sample_rate, seed=seed,
            min_sample=spec.selector.min_sample,
            max_sample=spec.selector.max_sample, keep_parts=True)
        rerank = 4
        if codebook is None and spec.quant is not None:
            from .. import quant
            q = spec.quant
            if q.kind == "pq":
                codebook = quant.train_pq(vectors, m=q.m, nbits=q.nbits,
                                          iters=q.train_iters,
                                          sample=q.train_sample, seed=seed,
                                          device=mesh.first_device)
            else:
                codebook = quant.train_sq(vectors)
        if spec.quant is not None:
            rerank = spec.quant.rerank
        be = cls(mesh, sharded, attrs.schema, sel_cfg=spec.selector,
                 codebook=codebook, rerank=rerank,
                 prefbf_chunk=max(spec.prefbf_chunk, 1),
                 query_axes=query_axes, model_axis=model_axis,
                 hnsw_params=spec.hnsw, seed=seed)
        be._shard_indexes = parts
        return be

    # -- serve steps ---------------------------------------------------------
    def _fns(self, opts: SearchOptions, *, for_pq: bool = False) -> dict:
        """Serve-fns set for ``opts``, cached on its SearchConfig (rerank
        pinned to the backend default); a non-default ``opts.rerank``
        creates an extra set whose serve_brute_pq is the only member ever
        called."""
        rr = self.rerank
        if for_pq and opts.rerank is not None:
            rr = opts.rerank
        # the live flag is part of the key (and the cache is cleared when it
        # flips): a live DB carries an extra "alive" array
        key = (opts.search_config(), rr, self._live_active)
        fns = self._fns_cache.get(key)
        if fns is None:
            fns = dist.make_serve_fns(
                self.mesh, opts.search_config(),
                prefbf_chunk=self.prefbf_chunk,
                query_axes=self.query_axes, model_axis=self.model_axis,
                quant=self.quant, rerank=rr, live=self._live_active)
            self._fns_cache[key] = fns
        return fns

    def _pad(self, queries, programs: dict, valid=None):
        """Pad the batch to a multiple of the query axes' device count (the
        data-parallel split needs an even division) by repeating the last
        row.  The serve steps always take a validity mask, so ``valid=None``
        is materialized as all-True for the real rows; alignment pad rows
        are marked False."""
        b = int(queries.shape[0])
        valid = (np.ones((b,), bool) if valid is None
                 else np.asarray(to_host(valid), bool))
        pad = (-b) % self._qmult
        if pad:
            queries = torch.cat([queries, queries[-1:].expand(pad, -1)])
            programs = {k: torch.cat([v, v[-1:].expand(pad, *v.shape[1:])])
                        for k, v in programs.items()}
            valid = np.concatenate([valid, np.zeros((pad,), bool)])
        return (queries, programs,
                torch.as_tensor(valid, device=self.device), b)

    # -- Backend protocol -----------------------------------------------------
    def version(self) -> int:
        """Data epoch (see Backend.version); ``bump_version()`` after any
        reshard/re-attach that changes the served rows."""
        return self.epochs.total

    def versions(self) -> dict:
        """Scoped epochs (index subsystem): vectors / attributes / graph."""
        return self.epochs.as_dict()

    def shard_versions(self) -> tuple:
        """Per-shard mutation counters: shard s moves when a row it owns is
        tombstoned or its subgraph is rebuilt (merge/reshard)."""
        return tuple(self.shard_epochs)

    def bump_version(self) -> int:
        self.epochs.bump_all()
        self.shard_epochs = [e + 1 for e in self.shard_epochs]
        return self.epochs.total

    # -- live mutation API (index subsystem) ----------------------------------
    def _ensure_live(self) -> LiveState:
        if self._live is None:
            a = self.sharded.arrays
            self._live = LiveState(a["vectors"].shape[0],
                                   a["vectors"].shape[1],
                                   a["attrs_int"].shape[1],
                                   a["attrs_float"].shape[1])
        return self._live

    def _put_alive(self, alive: np.ndarray) -> None:
        alive = np.asarray(alive, bool)
        cap = self.sharded.arrays["vectors"].shape[0]
        if alive.shape[0] < cap:
            # headroom tail rows (reserved by a full-rebuild merge) are dead
            # until an incremental merge registers real rows onto them
            alive = np.concatenate(
                [alive, np.zeros((cap - alive.shape[0],), bool)])
        placed = dist.place_sharded_db({"alive": alive}, self.mesh,
                                       {"alive": (self.model_axis,)})
        db = np.empty(self.db.shape, dtype=object)
        for c in np.ndindex(*db.shape):
            db[c] = {**self.db[c], "alive": placed[c]["alive"]}
        self.db = db    # one assignment: readers see old or new, never both

    def _apply_tombstones(self, dead_rows: np.ndarray) -> None:
        if len(dead_rows) == 0:
            return
        if not self._live_active:
            self._live_active = True
            self._fns_cache.clear()
        self._put_alive(self._live.base_alive)
        for r in dead_rows:
            self.shard_epochs[int(r) // self.sharded.shard_rows] += 1

    def _delta(self):
        if self._live is None or self._live.delta.live_count == 0:
            return None
        return self._live.delta

    def upsert(self, vectors, ints=None, floats=None, *, replace=None):
        live = self._ensure_live()
        ids, dead = live.upsert(vectors, ints, floats, replace=replace)
        self._apply_tombstones(dead)
        self.epochs.bump("vectors")
        return ids

    def delete(self, ids):
        live = self._ensure_live()
        n, dead = live.delete(ids)
        self._apply_tombstones(dead)
        if n:
            self.epochs.bump("vectors")
        return n

    def live_view(self):
        return None if self._live is None else self._live.view()

    def live_stats(self) -> dict:
        if self._live is None:
            return {"base_rows": self.sharded.arrays["vectors"].shape[0],
                    "dead_base_rows": 0, "delta_rows": 0, "delta_slots": 0,
                    "upserts": 0, "deletes": 0, "replaced": 0,
                    "missing_deletes": 0}
        return self._live.stats()

    def _pick_capacity(self, n_tot: int, cnt: int) -> int:
        """Array capacity for a full-rebuild merge: shard-aligned, with up
        to ``merge_headroom * cnt`` extra dead-tail rows -- but never so many
        that the tail spills out of the LAST shard (the invariant that lets
        an incremental merge grow exactly one shard)."""
        s = self.sharded.n_shards

        def align(x):
            return -(-x // s) * s

        cap = align(n_tot)
        want = align(n_tot + max(0, int(self.merge_headroom * cnt)))
        while cap < want and (cap + s - n_tot) < (cap + s) // s:
            cap += s
        return cap

    def merge_prepare(self, *, wave: int = 512, on_wave=None):
        """Phase 1 of a sharded merge, safe to run off-thread (nothing
        served is mutated).  Two shapes:

        * incremental -- the delta fits in the headroom tail reserved by the
          last full rebuild AND the per-shard index handles are held: grow
          only the last shard's HNSW via ``bulk_add`` (positions
          [base_n, base_n+cnt) are that shard's unclaimed rows, so global
          ids stay positional without touching any other shard);
        * full -- rebuild every shard through ``build_sharded`` over the
          logical rows, reserving fresh headroom for future increments.

        The graph builds' candidate searches run on the mesh's first
        device.  Returns None when there is nothing to merge; pass the
        result to ``merge_commit`` under the serving lock.
        """
        from ..index.bulk import build_hnsw_bulk, bulk_add
        live = self._live
        if live is None or live.delta.count == 0:
            return None
        if self.quant is not None and self.codebook is None:
            raise ValueError("cannot merge: codes were pre-attached without "
                             "a codebook to re-encode the grown DB with")
        d = live.delta
        cnt = int(d.count)      # snapshot boundary: read BEFORE array refs
        vecs = d.vectors[:cnt].copy()
        ints = d.ints[:cnt].copy()
        flts = d.floats[:cnt].copy()
        link = d.alive[:cnt].copy()
        graph_epoch = self.epochs.graph
        base_n = int(live.base_n)
        sharded = self.sharded
        a = sharded.arrays
        cap = a["vectors"].shape[0]
        s_last = sharded.n_shards - 1
        dev = self.device
        if (self._shard_indexes is not None and base_n + cnt <= cap
                and self._shard_indexes[s_last].n
                == base_n - s_last * sharded.shard_rows):
            new_idx = bulk_add(self._shard_indexes[s_last], vecs, wave=wave,
                               link=link, on_wave=on_wave, device=dev)
            codes = None
            if self.codebook is not None:
                from .. import quant
                codes = to_host(quant.encode(self.codebook, vecs, device=dev))
            return _ShardMergePrep(
                kind="incr", from_slot=cnt, n_live=int(link.sum()),
                graph_epoch=graph_epoch, base_n=base_n, shard=s_last,
                index=new_idx, vectors=vecs, ints=ints, floats=flts,
                codes=codes)

        n_tot = base_n + cnt
        vectors = np.concatenate([a["vectors"][:base_n], vecs])
        ints_all = np.concatenate([a["attrs_int"][:base_n], ints])
        flts_all = np.concatenate([a["attrs_float"][:base_n], flts])
        cap_new = self._pick_capacity(n_tot, cnt)
        pad = cap_new - n_tot
        if pad:
            # alignment + headroom rows: zero attrs (NOT the -1/nan
            # padded-row fill -- attr=-1 would shift out of the imask range)
            # and alive=False until an incremental merge claims them
            vectors = np.concatenate(
                [vectors, np.zeros((pad, vectors.shape[1]), np.float32)])
            ints_all = np.concatenate(
                [ints_all, np.zeros((pad, ints_all.shape[1]), np.int32)])
            flts_all = np.concatenate(
                [flts_all, np.zeros((pad, flts_all.shape[1]), np.float32)])
        attrs = F.AttributeTable(self.schema, ints_all, flts_all)
        new_sharded, parts = dist.build_sharded(
            vectors, attrs, sharded.n_shards, self.hnsw_params,
            sample_rate=self.sel_cfg.sample_rate, seed=self.seed,
            min_sample=self.sel_cfg.min_sample,
            max_sample=self.sel_cfg.max_sample,
            build_fn=lambda v, p: build_hnsw_bulk(v, p, wave=wave,
                                                  on_wave=on_wave,
                                                  device=dev),
            n_valid=n_tot, keep_parts=True)
        if self.codebook is not None:
            new_sharded = dist.attach_quant(new_sharded, self.codebook,
                                            device=dev)
        return _ShardMergePrep(
            kind="full", from_slot=cnt, n_live=int(link.sum()),
            graph_epoch=graph_epoch, base_n=base_n, sharded=new_sharded,
            parts=parts, n_tot=n_tot)

    def merge_commit(self, prep) -> dict | None:
        """Phase 2: atomic swap under the caller's serving lock.  Mutations
        since the snapshot are honoured exactly like the local backend:
        current tombstones win, and delta slots past the snapshot boundary
        carry into the fresh delta with their ids intact.  Returns None --
        and changes nothing -- when the base graph moved since the snapshot
        (competing merge / explicit rebuild): the prep is stale."""
        live = self._live
        if live is None or self.epochs.graph != prep.graph_epoch:
            return None
        cnt = prep.from_slot
        base = (live.base_alive if live.base_alive is not None
                else np.ones((live.base_n,), bool))
        alive = np.concatenate([base, live.delta.alive[:cnt]])
        if prep.kind == "incr":
            out = self._commit_incremental(prep, alive)
        else:
            out = self._commit_full(prep, alive)
        live.reset_after_merge(out["n"], None if alive.all() else alive,
                               from_slot=cnt)
        return out

    def _commit_full(self, prep, alive: np.ndarray) -> dict:
        sharded = prep.sharded
        cap = sharded.arrays["vectors"].shape[0]
        live_active = bool(cap > prep.n_tot or not alive.all())
        db = dist.place_sharded_db(sharded.arrays, self.mesh,
                                   dist.db_specs(self.model_axis,
                                                 sharded.quant))
        self.sharded = sharded
        self.quant = sharded.quant
        self._shard_indexes = prep.parts
        self._live_active = live_active
        self._fns_cache.clear()
        self.db = db
        if live_active:
            self._put_alive(alive)
        # all three epochs move: the selectivity sample is re-drawn over the
        # new sharding, unlike the local merge
        self.epochs.bump("vectors", "attributes", "graph")
        self.shard_epochs = [e + 1 for e in self.shard_epochs]
        return {"merged_slots": prep.from_slot, "merged_live": prep.n_live,
                "n": prep.n_tot, "incremental": False}

    def _commit_incremental(self, prep, alive: np.ndarray) -> dict:
        old = self.sharded
        a = dict(old.arrays)
        R = old.shard_rows
        cap = a["vectors"].shape[0]
        s = prep.shard
        idx = prep.index
        cnt = prep.from_slot
        nl = prep.base_n + cnt
        # copy-on-swap: in-flight device phases keep reading the old arrays;
        # the new ones become visible only through the assignments below
        # (all under the caller's serving lock)
        rows = slice(prep.base_n, nl)
        vectors = a["vectors"].copy()
        vectors[rows] = prep.vectors
        norms = a["norms"].copy()
        norms[rows] = np.einsum("nd,nd->n", prep.vectors, prep.vectors)
        attrs_i = a["attrs_int"].copy()
        attrs_i[rows] = prep.ints
        attrs_f = a["attrs_float"].copy()
        attrs_f[rows] = prep.floats
        nb0 = a["neighbors0"].copy()
        nb0[s * R: s * R + idx.n] = idx.levels[0]
        lup = len(idx.levels) - 1
        upper = a["upper"]
        if lup > upper.shape[0]:
            upper = np.concatenate([
                upper, np.full((lup - upper.shape[0], cap, upper.shape[2]),
                               -1, np.int32)], axis=0)
        else:
            upper = upper.copy()
        upper[:, s * R:(s + 1) * R, :] = -1   # links may have been rewired
        for li, lvl in enumerate(idx.levels[1:]):
            upper[li, s * R: s * R + idx.n] = lvl
        entry = a["entry"].copy()
        entry[s] = idx.entry_point
        delta_d = a["delta_d"].copy()
        delta_d[s] = idx.delta_d
        a.update(vectors=vectors, norms=norms, attrs_int=attrs_i,
                 attrs_float=attrs_f, neighbors0=nb0, upper=upper,
                 entry=entry, delta_d=delta_d)
        if prep.codes is not None:
            codes = a["codes"].copy()
            codes[rows] = prep.codes
            a["codes"] = codes
        db = dist.place_sharded_db(a, self.mesh,
                                   dist.db_specs(self.model_axis, self.quant))
        self.sharded = dist.ShardedFavorArrays(a, old.n_shards, R,
                                               old.sample_rows, old.quant)
        self._shard_indexes = list(self._shard_indexes)
        self._shard_indexes[s] = idx
        if not self._live_active:
            self._live_active = True
            self._fns_cache.clear()
        self.db = db
        self._put_alive(alive)
        # the selectivity sample is untouched (no attributes bump) and only
        # the grown shard's subgraph moved
        self.epochs.bump("vectors", "graph")
        self.shard_epochs[s] += 1
        return {"merged_slots": cnt, "merged_live": prep.n_live,
                "n": nl, "incremental": True}

    def merge(self, *, wave: int = 512) -> dict:
        """Fold the delta into the base.  Implemented as ``merge_prepare``
        + ``merge_commit`` (background callers split the phases across
        threads); the first merge after a full rebuild reserves headroom so
        later merges grow only the last shard (see merge_prepare)."""
        prep = self.merge_prepare(wave=wave)
        if prep is None:
            n = (self._live.base_n if self._live is not None
                 else self.sharded.arrays["vectors"].shape[0])
            return {"merged_slots": 0, "merged_live": 0, "n": n}
        out = self.merge_commit(prep)
        if out is None:  # pragma: no cover - single-threaded epochs are stable
            raise RuntimeError("merge_commit rejected a same-thread prepare")
        return out

    @property
    def dim(self) -> int:
        """Query vector dimensionality (warmup builds its batches off it)."""
        return int(self.sharded.arrays["vectors"].shape[1])

    def validate(self, opts: SearchOptions) -> None:
        if opts.use_pq and self.quant is None:
            raise ValueError("use_pq=True needs a ShardedBackend built with "
                             "quantize codes (BuildSpec.quant, codebook=, or "
                             "attach_quant)")
        if opts.graph_quant is not None and self.quant != opts.graph_quant:
            raise ValueError(
                f"graph_quant={opts.graph_quant!r} needs a ShardedBackend "
                f"with {opts.graph_quant!r} codes attached "
                f"(this one has {self.quant!r})")

    def estimate(self, programs: dict, valid=None) -> torch.Tensor:
        # pad rows carry always-false programs (p_hat 0): no mask needed
        b = int(programs["valid"].shape[0])
        dummy = torch.zeros((b, 1), dtype=torch.float32, device=self.device)
        _, programs, _, b = self._pad(dummy, programs)
        # the estimate step is SearchConfig-independent: reuse any cached
        # serve-fns set rather than keying a fresh one on defaults
        fns = (next(iter(self._fns_cache.values())) if self._fns_cache
               else self._fns(SearchOptions()))
        return fns["estimate"](self.db, programs)[:b]

    def search_graph(self, queries, programs: dict, p_hat,
                     opts: SearchOptions, valid=None) -> dict:
        q0, programs0, valid0 = queries, programs, valid
        queries, programs, valid, b = self._pad(queries, programs, valid)
        p_hat = torch.as_tensor(p_hat, dtype=torch.float32,
                                device=self.device)
        pad = queries.shape[0] - p_hat.shape[0]
        if pad:
            p_hat = torch.cat([p_hat, p_hat[-1:].expand(pad)])
        ids, dists = self._fns(opts)["serve_graph_phat"](
            self.db, queries, programs, p_hat, valid)
        ids, dists = ids[:b], dists[:b]
        delta = self._delta()
        if delta is not None:
            # delta rows are host-replicated: scan them unsharded on the
            # original (un-padded) batch and fold them into the merged top-k
            gi, gd = delta.scan_dev(q0, programs0, k=opts.k, valid=valid0)
            ids, dists = compose_topk_dev(ids, dists, gi, gd, opts.k)
        return {"ids": ids, "dists": dists}

    def search_brute(self, queries, programs: dict, opts: SearchOptions,
                     valid=None):
        q0, programs0, valid0 = queries, programs, valid
        queries, programs, valid, b = self._pad(queries, programs, valid)
        fn = "serve_brute_pq" if opts.use_pq else "serve_brute"
        fns = self._fns(opts, for_pq=opts.use_pq)
        ids, dists = fns[fn](self.db, queries, programs, valid)
        ids, dists = ids[:b], dists[:b]
        delta = self._delta()
        if delta is not None:
            gi, gd = delta.scan_dev(q0, programs0, k=opts.k, valid=valid0)
            ids, dists = compose_topk_dev(ids, dists, gi, gd, opts.k)
        return ids, dists

    # -- accounting -----------------------------------------------------------
    def bytes_per_hop(self, opts: SearchOptions) -> int:
        """Bytes one gathered neighbour row streams under ``opts``' graph
        scorer (see Backend.bytes_per_hop).  Shard-local: each shard's
        traversal gathers from its own slice of the code/vector arrays."""
        if opts.graph_quant is not None:
            return int(self.sharded.arrays["codes"].shape[1])
        return 4 * int(self.sharded.arrays["vectors"].shape[1])

    def bytes_per_vector(self, quantized: bool = False) -> int:
        """Bytes streamed per DB row by the brute scan on each shard."""
        if quantized:
            if self.quant is None:
                raise ValueError("backend has no quantize codes attached")
            # one uint8 code per column, whether the codebook object is held
            # here or the codes were pre-attached via attach_quant
            return int(self.sharded.arrays["codes"].shape[1])
        return 4 * int(self.sharded.arrays["vectors"].shape[1])
