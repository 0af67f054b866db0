"""FavorIndex: the end-to-end FAVOR API (paper Figure 1 workflow).

Offline:  build a conventional HNSW over the vectors on the host, record
          Delta_d (Eq. 5), draw the selectivity sample, attach the attribute
          table, and move the graph, the rows and the sample to the device.
Online :  compile each query's filter to a DNF program, estimate p_hat on the
          sample (section 4.2), route by lambda (section 4.1), compute the
          exclusion distance D(p_hat) (Eq. 14) and execute either the PreFBF
          scan or the exclusion-distance graph search (section 5), returning
          the k nearest target points.

With ``BuildSpec(quant=QuantSpec(...))`` the offline phase also trains a PQ
codebook (k-means on the device) or an SQ quantizer -- or takes the
``codebook=`` given -- and encodes the rows, so the brute route can run the
compressed ADC scan (``SearchOptions.use_pq``) and the graph route can score
on codes (``SearchOptions.graph_quant``).

Live:    ``upsert`` / ``delete`` stream rows into a delta segment and
          tombstones beside the static device arrays; ``merge`` folds them
          into the graph (index.bulk) with positional ids kept.

The online pipeline lives in router.execute; this class owns the offline
state and exposes it through a LocalBackend.  ``query(queries, filters,
SearchOptions(...))`` is the typed API; ``search(**kwargs)`` and the
pre-BuildSpec constructor kwargs remain as deprecated shims, as in the JAX
package.  Everything runs on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device the default raises instead of falling
back to the CPU.  ``save``/``load`` use the JAX package's ``.npz``
layout, so an index moves between the two packages unchanged,
quantization state included.
"""
from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from . import filters as F
from . import prefbf, selectivity, selector
from .backend import LocalBackend
from .hnsw import HnswIndex, HnswParams, build_hnsw
from .options import BuildSpec, QuantSpec, SearchOptions
from .router import SearchResult, compile_programs, execute
from .search import graph_topology
from ..device import resolve_device
from ..index.epochs import COMPONENTS, ComponentEpochs
from ..index.live import LiveState

__all__ = ["FavorIndex", "SearchResult", "resolve_device"]

# the padded scan arrays (``_pf`` slots) each epoch component owns, and the
# graph-dict keys that view their first N rows; ``graph`` owns the
# neighbour arrays (search.graph_topology)
_COMPONENT_SLOTS = {"vectors": ((0, "vectors"), (1, "norms")),
                    "attributes": ((2, "attrs_int"), (3, "attrs_float")),
                    "graph": ()}

_LEGACY_BUILD_KW = ("sel_cfg", "prefbf_chunk", "quantize", "pq_m", "pq_nbits",
                    "pq_train_iters", "pq_train_sample", "rerank")


@dataclass
class _MergePrep:
    """Everything ``merge_prepare`` built off the serving path, ready for an
    atomic ``merge_commit`` swap.  ``graph_epoch`` guards staleness."""
    from_slot: int
    n_live: int
    graph_epoch: int
    index: HnswIndex
    attrs: F.AttributeTable
    chunk: int
    pf: tuple       # padded (vectors, pristine norms, ints, floats)
    codes: object
    g: dict


def _spec_from_legacy(kw: dict) -> BuildSpec:
    """Map the pre-BuildSpec __init__ kwargs onto a BuildSpec."""
    def get(name, default):
        return kw.get(name) if kw.get(name) is not None else default
    quant = None
    if kw.get("quantize") is not None:
        quant = QuantSpec(kind=kw["quantize"], m=get("pq_m", 8),
                          nbits=get("pq_nbits", 8),
                          train_iters=get("pq_train_iters", 20),
                          train_sample=get("pq_train_sample", 65536),
                          rerank=get("rerank", 4))
    return BuildSpec(selector=kw.get("sel_cfg") or selector.SelectorConfig(),
                     prefbf_chunk=get("prefbf_chunk", 8192), quant=quant)


class FavorIndex:
    """Single-device FAVOR index; execution goes through a LocalBackend."""

    def __init__(self, index: HnswIndex, attrs: F.AttributeTable,
                 spec: BuildSpec | None = None, *, codebook=None,
                 codes=None, device=None, **legacy):
        self.device = resolve_device(device)
        if isinstance(spec, selector.SelectorConfig):
            # the JAX package's pre-BuildSpec third positional was sel_cfg
            if legacy.get("sel_cfg") is not None:
                raise ValueError("sel_cfg passed both positionally and by "
                                 "keyword")
            legacy["sel_cfg"], spec = spec, None
        elif spec is not None and not isinstance(spec, BuildSpec):
            raise TypeError("spec must be a BuildSpec, got "
                            f"{type(spec).__name__}")
        unknown = set(legacy) - set(_LEGACY_BUILD_KW)
        if unknown:
            raise TypeError(f"unexpected FavorIndex kwargs: {sorted(unknown)}")
        if any(v is not None for v in legacy.values()):
            if spec is not None:
                raise ValueError("pass either spec=BuildSpec(...) or legacy "
                                 "kwargs, not both")
            warnings.warn(
                "FavorIndex(sel_cfg=/quantize=/pq_*=/rerank=...) is "
                "deprecated; pass spec=BuildSpec(...)",
                DeprecationWarning, stacklevel=2)
            spec = _spec_from_legacy(legacy)
        if spec is None:
            spec = BuildSpec()
        if spec.quant is None and codebook is not None:
            # a given codebook implies its quant kind and geometry
            from ..quant import PQCodebook
            rr = legacy.get("rerank")
            rr = rr if rr is not None else 4
            q = (QuantSpec(kind="pq", m=codebook.m, nbits=codebook.nbits,
                           rerank=rr)
                 if isinstance(codebook, PQCodebook)
                 else QuantSpec(kind="sq", rerank=rr))
            spec = BuildSpec(hnsw=spec.hnsw, selector=spec.selector,
                             prefbf_chunk=spec.prefbf_chunk, quant=q)
        self.spec = spec
        self.index = index
        self.attrs = attrs
        self.sel_cfg = spec.selector
        self.schema = attrs.schema
        dev = self.device

        samp = selectivity.sample_indices(
            index.n, self.sel_cfg.sample_rate, self.sel_cfg.min_sample,
            self.sel_cfg.max_sample, seed=index.params.seed + 17)
        self.sample_idx = samp
        self.sample_ints = torch.as_tensor(attrs.ints[samp], device=dev)
        self.sample_floats = torch.as_tensor(attrs.floats[samp], device=dev)

        self.prefbf_chunk, self._pf, self.g = self._device_arrays(index,
                                                                 attrs)
        # pristine padded norms, kept so tombstones can be (re)masked onto
        # the scan arrays
        self._pn0 = self._pf[1]

        # -- live mutation state (index subsystem) ----------------------------
        self.epochs = ComponentEpochs()
        self.live: LiveState | None = None
        self._alive: np.ndarray | None = None   # base-row tombstone mask

        self._quantize(spec.quant, codebook, codes, self._pf[0])
        self.backend = LocalBackend(self)

    def _device_arrays(self, index: HnswIndex, attrs: F.AttributeTable):
        """(scan chunk, padded scan arrays, graph dict) on the device.  The
        graph route reads the first N rows of the padded scan arrays: one
        copy of the corpus on the device."""
        chunk = min(self.spec.prefbf_chunk, max(256, index.n))
        pf = tuple(self._padded(index, attrs, chunk, s) for s in range(4))
        g = graph_topology(index, self.device)
        g.update({key: pf[s][:index.n] for ks in _COMPONENT_SLOTS.values()
                  for s, key in ks})
        return chunk, pf, g

    def _padded(self, index: HnswIndex, attrs: F.AttributeTable,
                chunk: int, slot: int) -> torch.Tensor:
        """Padded scan array ``slot`` (vectors, norms, ints, floats) on the
        device."""
        a = (index.vectors, index.norms, attrs.ints, attrs.floats)[slot]
        if slot == 1:
            a = a.astype(np.float32)
        a = prefbf.pad_rows(a, chunk, prefbf.PAD_FILL[slot])
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _quantize(self, q, codebook, codes, padded_vectors) -> None:
        """Optional compressed-domain state: the codebook (trained here when
        none is given), the codes of the *padded* DB -- so code rows align
        with the ``_pf`` arrays; padded rows encode the zero vector and
        their +inf norms gate them out of the scan -- and the graph
        scorer's arrays in ``g``."""
        self.quantize = q.kind if q is not None else None
        self.rerank = q.rerank if q is not None else 4
        self.codebook = None
        self._codes = None
        self._cb_dev = None
        if q is None:
            if codes is not None:
                raise ValueError("codes= supplied but the index requests no "
                                 "quantization (spec.quant is None and no "
                                 "codebook was given)")
            return
        from .. import quant
        index, dev = self.index, self.device
        if codebook is not None:
            kind = "pq" if isinstance(codebook, quant.PQCodebook) else "sq"
            if kind != q.kind:
                raise ValueError(f"spec.quant.kind={q.kind!r} does not match "
                                 f"the supplied {kind!r} codebook")
            if kind == "pq" and (codebook.m, codebook.nbits) != (q.m, q.nbits):
                raise ValueError(
                    f"spec.quant geometry (m={q.m}, nbits={q.nbits}) does not "
                    f"match the supplied codebook (m={codebook.m}, "
                    f"nbits={codebook.nbits})")
        elif index.n == 0:
            raise ValueError(
                "cannot train a codebook on an empty index; pass codebook= "
                "(or build unquantized and re-quantize after the first "
                "merge)")
        elif q.kind == "pq":
            codebook = quant.train_pq(index.vectors, m=q.m, nbits=q.nbits,
                                      iters=q.train_iters,
                                      sample=q.train_sample,
                                      seed=index.params.seed, device=dev)
        else:
            codebook = quant.train_sq(index.vectors)
        self.codebook = codebook
        if codes is not None:
            codes = np.array(codes, np.uint8)
            if codes.shape[0] != index.n:
                raise ValueError(f"codes= carries {codes.shape[0]} rows for "
                                 f"an index of {index.n}")
            pad = padded_vectors[index.n:]
            self._codes = torch.cat([
                torch.as_tensor(codes, device=dev),
                quant.encode(codebook, pad, device=dev)]).contiguous()
        else:
            self._codes = quant.encode(codebook, padded_vectors, device=dev)
        if q.kind == "pq":
            self._cb_dev = (torch.as_tensor(codebook.centroids, device=dev),)
        else:
            self._cb_dev = (torch.as_tensor(codebook.lo, device=dev),
                            torch.as_tensor(codebook.scale, device=dev))
        self._attach_scorer_arrays()

    def _attach_scorer_arrays(self) -> None:
        """Graph-route scorer arrays: code rows 0..N-1 of the padded
        encoding align with the graph arrays."""
        if self._codes is None:
            return
        self.g["codes"] = self._codes[:self.index.n]
        if self.quantize == "pq":
            self.g["centroids"] = self._cb_dev[0]
        else:
            self.g["sq_lo"], self.g["sq_scale"] = self._cb_dev

    # -- construction --------------------------------------------------------
    @staticmethod
    def build(vectors: np.ndarray, attrs: F.AttributeTable,
              params: HnswParams | None = None,
              spec: BuildSpec | None = None, *, device=None) -> "FavorIndex":
        """Build the HNSW graph on the host, then the device state."""
        device = resolve_device(device)   # before the (slow) host build
        if spec is not None and spec.hnsw is not None:
            if params is not None:
                raise ValueError("pass HNSW params via either params= or "
                                 "spec.hnsw, not both")
            params = spec.hnsw
        t0 = time.perf_counter()
        index = build_hnsw(vectors, params)
        build_s = time.perf_counter() - t0
        fi = FavorIndex(index, attrs, spec, device=device)
        fi.build_seconds = build_s
        return fi

    @property
    def delta_d(self) -> float:
        return self.index.delta_d

    def compile_filters(self, filters, width: int = 8) -> dict:
        if isinstance(filters, F.Filter):
            filters = [filters]
        return compile_programs(filters, self.schema, len(filters), width,
                                device=self.device)

    # -- online search --------------------------------------------------------
    def query(self, queries, filters,
              opts: SearchOptions | None = None) -> SearchResult:
        """Typed search API: one SearchOptions drives routing + execution."""
        return execute(self.backend, queries, filters, opts or SearchOptions())

    def search(self, queries, filters, k: int = 10, ef: int = 100, *,
               pbar_min: float = 0.5, gamma: float = 1.0,
               force: str | None = None, use_pallas: bool = False,
               cand_cap: int = 0, use_pq: bool = False,
               rerank: int | None = None) -> SearchResult:
        """Deprecated kwarg shim over ``query``, kept so the JAX package's
        pre-SearchOptions callers run unmodified.  ``use_pallas`` is
        accepted and not acted on: the device picks kernel or plain
        version (``SearchOptions``)."""
        warnings.warn(
            "FavorIndex.search(k=, ef=, ...) is deprecated; use "
            "FavorIndex.query(queries, filters, SearchOptions(...))",
            DeprecationWarning, stacklevel=2)
        opts = SearchOptions(k=k, ef=ef, pbar_min=pbar_min, gamma=gamma,
                             force=force, cand_cap=cand_cap, use_pq=use_pq,
                             rerank=rerank)
        return self.query(queries, filters, opts)

    def bytes_per_vector(self, quantized: bool = False) -> int:
        """Bytes streamed per DB row by the brute scan (float32 vs codes)."""
        if quantized:
            if self.codebook is None:
                raise ValueError("index is not quantized")
            return self.codebook.bytes_per_vector()
        return 4 * self.index.dim

    # -- live mutation API (index subsystem) ----------------------------------
    def version(self) -> int:
        """Aggregate data epoch: any component bump changes it."""
        return self.epochs.total

    def versions(self) -> dict:
        """Scoped epochs (vectors / attributes / graph)."""
        return self.epochs.as_dict()

    def bump_version(self, components: tuple[str, ...] | None = None) -> int:
        """Mark served rows as changed (rebuild, attribute update): the
        epochs of ``components`` (subset of vectors / attributes / graph;
        None = all) move, and their device arrays are uploaded again from
        the host arrays, so an in-place edit of ``index`` or ``attrs`` is
        served from then on: a component's padded scan arrays and the graph
        views over them, or the neighbour arrays.  Every other device
        tensor is reused; a full bump also re-uploads the ``alive`` mask."""
        changed = COMPONENTS if components is None else tuple(components)
        self.epochs.bump(*changed)
        n = self.index.n
        pf, g = list(self._pf), dict(self.g)
        for c in changed:
            for s, key in _COMPONENT_SLOTS[c]:
                pf[s] = self._padded(self.index, self.attrs,
                                     self.prefbf_chunk, s)
                g[key] = pf[s][:n]
        if "graph" in changed:
            g.update(graph_topology(self.index, self.device))
        if "vectors" in changed:
            self._pn0 = pf[1]
            if self._alive is not None:
                pf[1] = self._masked_norms(pf[1], self._alive)
        self._pf, self.g = tuple(pf), g
        self._attach_scorer_arrays()
        if self._alive is not None and components is None:
            self.g["alive"] = torch.as_tensor(self._alive, device=self.device)
        return self.epochs.total

    def _ensure_live(self) -> LiveState:
        if self.live is None:
            self.live = LiveState(self.index.n, self.index.dim,
                                  self.attrs.ints.shape[1],
                                  self.attrs.floats.shape[1])
        return self.live

    def _masked_norms(self, pn0, alive: np.ndarray):
        """Padded norms with +inf on the dead rows of ``alive`` (N,)."""
        pad = int(pn0.shape[0]) - len(alive)
        alive_pad = np.concatenate([alive, np.ones((pad,), bool)])
        return torch.where(torch.as_tensor(alive_pad, device=self.device),
                           pn0, float("inf"))

    def _apply_tombstones(self, dead_rows: np.ndarray) -> None:
        """Thread newly-dead base rows onto the device arrays: an ``alive``
        key for the graph traversal and +inf norms for every brute scan.
        Nothing else re-uploads -- vectors/neighbours/attrs stay put."""
        if len(dead_rows) == 0:
            return
        alive = self.live.base_alive
        self._alive = alive
        self.g["alive"] = torch.as_tensor(alive, device=self.device)
        self._pf = (self._pf[0], self._masked_norms(self._pn0, alive),
                    self._pf[2], self._pf[3])

    def upsert(self, vectors: np.ndarray, ints=None, floats=None, *,
               replace=None) -> np.ndarray:
        """Stream rows into the live delta; returns their ids (positional:
        ``base_n + slot``).  ``replace=`` retires the named ids first (an
        update is delete + fresh insert; the new ids are the handles)."""
        live = self._ensure_live()
        ids, dead = live.upsert(vectors, ints, floats, replace=replace)
        self._apply_tombstones(dead)
        self.epochs.bump("vectors")
        return ids

    def delete(self, ids) -> int:
        """Tombstone ids (base rows or unmerged delta rows); returns how
        many were found alive."""
        live = self._ensure_live()
        n, dead = live.delete(ids)
        self._apply_tombstones(dead)
        if n:
            self.epochs.bump("vectors")
        return n

    def live_view(self):
        return None if self.live is None else self.live.view()

    def live_stats(self) -> dict:
        if self.live is None:
            return {"base_rows": self.index.n, "dead_base_rows": 0,
                    "delta_rows": 0, "delta_slots": 0, "upserts": 0,
                    "deletes": 0, "replaced": 0, "missing_deletes": 0}
        return self.live.stats()

    def merge_prepare(self, *, wave: int = 512,
                      on_wave=None) -> "_MergePrep | None":
        """Phase 1 of a merge: snapshot the delta and run the expensive work
        (bulk graph build with its candidate searches on the device,
        attribute concat, scan-array padding, code re-encode with the
        index's codebook, device upload) WITHOUT mutating any served state.

        The snapshot boundary is ``cnt = delta.count`` read *before* any
        array reference (append never rewrites rows below ``count`` and
        ``_grow`` reallocates, so rows ``[:cnt]`` of whatever arrays are
        then seen are stable).  Safe to run on another thread while serving
        continues.  ``on_wave`` is ``bulk_add``'s pacing hook, called
        before each device wave.  Returns None when there is nothing to
        merge.
        """
        from ..index.bulk import bulk_add
        live = self.live
        if live is None or live.delta.count == 0:
            return None
        d = live.delta
        cnt = int(d.count)       # snapshot boundary: read BEFORE array refs
        index, attrs = self.index, self.attrs
        vecs = d.vectors[:cnt].copy()
        ints = d.ints[:cnt].copy()
        flts = d.floats[:cnt].copy()
        link = d.alive[:cnt].copy()
        graph_epoch = self.epochs.graph
        new_index = bulk_add(index, vecs, wave=wave, link=link,
                             on_wave=on_wave, device=self.device)
        new_attrs = F.AttributeTable(
            self.schema,
            np.concatenate([attrs.ints, ints]),
            np.concatenate([attrs.floats, flts]))
        chunk, pf, g = self._device_arrays(new_index, new_attrs)
        codes = None
        if self.codebook is not None:
            from .. import quant
            codes = quant.encode(self.codebook, pf[0], device=self.device)
        return _MergePrep(
            from_slot=cnt, n_live=int(link.sum()), graph_epoch=graph_epoch,
            index=new_index, attrs=new_attrs, chunk=chunk, pf=pf,
            codes=codes, g=g)

    def merge_commit(self, prep: "_MergePrep") -> dict | None:
        """Phase 2: atomic swap of the served state onto the prepared merge.

        Mutations that landed since the snapshot are honoured: deletes
        become tombstones on the fresh arrays, and delta slots past the
        snapshot boundary carry into the new delta with their ids intact.
        Returns None -- and changes nothing -- if the base graph was rebuilt
        since the snapshot (the prepared state is then stale).
        """
        live = self.live
        if live is None or self.epochs.graph != prep.graph_epoch:
            return None
        cnt = prep.from_slot
        base = (live.base_alive if live.base_alive is not None
                else np.ones((live.base_n,), bool))
        alive = np.concatenate([base, live.delta.alive[:cnt]])
        self._alive = None if alive.all() else alive
        self.index = prep.index
        self.attrs = prep.attrs
        self.prefbf_chunk = prep.chunk
        pv, self._pn0, pi, pf = prep.pf
        pn = (self._pn0 if self._alive is None
              else self._masked_norms(self._pn0, self._alive))
        self._pf = (pv, pn, pi, pf)
        self._codes = prep.codes
        # vectors (membership) and graph (base arrays rebuilt) move;
        # attributes deliberately do not -- the estimator sample is untouched
        self.epochs.bump("vectors", "graph")
        self.g = dict(prep.g)
        self._attach_scorer_arrays()
        if self._alive is not None:
            self.g["alive"] = torch.as_tensor(self._alive, device=self.device)
        live.reset_after_merge(prep.index.n, self._alive, from_slot=cnt)
        return {"merged_slots": cnt, "merged_live": prep.n_live,
                "n": prep.index.n}

    def merge(self, *, wave: int = 512) -> dict:
        """Fold the delta segment into the base HNSW and return to the
        static fast path.

        Every delta *slot* is appended in order -- dead slots ride along as
        tombstoned, unlinked rows -- so surviving ids keep their positions.
        The selectivity sample is left untouched.  Runs ``merge_prepare``
        and ``merge_commit`` on this thread.
        """
        prep = self.merge_prepare(wave=wave)
        if prep is None:
            return {"merged_slots": 0, "merged_live": 0, "n": self.index.n}
        out = self.merge_commit(prep)
        if out is None:  # pragma: no cover - single-threaded epochs are stable
            raise RuntimeError("merge_commit rejected a same-thread prepare")
        return out

    # -- persistence -----------------------------------------------------------
    def _quant_payload(self) -> dict | None:
        """Quantization state persisted inside the .hnsw.npz: the codebook
        tables and the (unpadded) codes."""
        if self.codebook is None:
            return None
        payload = {"kind": self.quantize, "dim": self.codebook.dim,
                   "codes": self._codes[:self.index.n].cpu().numpy()}
        if self.quantize == "pq":
            payload["centroids"] = np.asarray(self.codebook.centroids)
        else:
            payload["lo"] = np.asarray(self.codebook.lo)
            payload["scale"] = np.asarray(self.codebook.scale)
        return payload

    def save(self, path: str) -> None:
        """``path + ".hnsw.npz"`` (with ``quant_*`` keys when quantized),
        ``path + ".attrs.npz"`` and, when quantized, the codebook as
        ``path + ".quant.npz"``: the JAX package's layout.  Unmerged live
        mutations are not persisted (a warning says so): ``merge`` first."""
        if self.live is not None and (self.live.delta.count
                                      or self.live.has_tombstones):
            warnings.warn(
                "FavorIndex.save: unmerged live mutations (delta rows or "
                "tombstones) are not persisted -- call merge() first",
                stacklevel=2)
        self.index.save(path + ".hnsw.npz", quant=self._quant_payload())
        np.savez_compressed(path + ".attrs.npz", ints=self.attrs.ints,
                            floats=self.attrs.floats,
                            kinds=np.array([c.kind for c in self.schema.columns]),
                            names=np.array([c.name for c in self.schema.columns]),
                            vocabs=np.array([c.vocab or 0 for c in self.schema.columns]))
        if self.codebook is not None:
            from ..quant import save_codebook
            save_codebook(path + ".quant.npz", self.codebook)

    @staticmethod
    def load(path: str, spec: BuildSpec | None = None, *,
             device=None) -> "FavorIndex":
        """Load an index saved by either package (``FavorIndex.save``); its
        quantization state comes from the ``quant_*`` keys, else from a
        ``.quant.npz`` codebook beside it (the codes are then re-encoded)."""
        from ..convert import from_reference_arrays
        index = HnswIndex.load(path + ".hnsw.npz")
        with np.load(path + ".attrs.npz") as z:
            schema = [(str(n), str(k), int(v))
                      for n, k, v in zip(z["names"], z["kinds"], z["vocabs"])]
            ints, floats = z["ints"], z["floats"]
        qs = index.quant_state or {}
        quant = {k: qs[k] for k in ("centroids", "lo", "scale", "codes")
                 if k in qs}
        if not qs and os.path.exists(path + ".quant.npz"):
            from ..quant import PQCodebook, load_codebook
            cb = load_codebook(path + ".quant.npz")
            quant = ({"centroids": cb.centroids} if isinstance(cb, PQCodebook)
                     else {"lo": cb.lo, "scale": cb.scale})
        want = spec.quant.kind if spec is not None and spec.quant else None
        have = ("pq" if "centroids" in quant else "sq") if quant else None
        if want is not None and have is None:
            raise ValueError(
                f"spec requests quant kind={want!r} but {path!r} was saved "
                "without quantization state")
        if want is not None and want != have:
            raise ValueError(f"spec requests quant kind={want!r} but the "
                             f"saved index carries {have!r}")
        return from_reference_arrays(
            vectors=index.vectors, levels=index.levels,
            node_level=index.node_level, entry_point=index.entry_point,
            max_level=index.max_level, delta_d=index.delta_d,
            params=index.params, ints=ints, floats=floats, schema=schema,
            spec=spec, device=device, **quant)
