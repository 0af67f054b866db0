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

The online pipeline lives in router.execute; this class owns the offline
state and exposes it through a LocalBackend.  Everything runs on the CUDA
device unless the caller passes ``device="cpu"``; with no CUDA device the
default raises instead of falling back to the CPU.  ``save``/``load`` use
the JAX package's ``.npz`` layout, so an index moves between the two
packages unchanged, quantization state included.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import filters as F
from . import prefbf, selectivity
from .backend import LocalBackend
from .hnsw import HnswIndex, HnswParams, build_hnsw
from .options import BuildSpec, QuantSpec, SearchOptions
from .router import SearchResult, compile_programs, execute
from .search import graph_topology

__all__ = ["FavorIndex", "SearchResult", "resolve_device"]

_LIVE = ("live mutation (upsert/delete/merge) comes with the live-index "
         "slice of the port")


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the FAVOR port runs on the card "
            "unless the caller passes device='cpu'")
    return dev


class FavorIndex:
    """Single-device FAVOR index; execution goes through a LocalBackend."""

    def __init__(self, index: HnswIndex, attrs: F.AttributeTable,
                 spec: BuildSpec | None = None, *, codebook=None,
                 codes=None, device=None):
        self.device = resolve_device(device)
        if spec is None:
            spec = BuildSpec()
        elif not isinstance(spec, BuildSpec):
            raise TypeError("spec must be a BuildSpec, got "
                            f"{type(spec).__name__}")
        if spec.quant is None and codebook is not None:
            # a given codebook implies its quant kind and geometry
            from ..quant import PQCodebook
            q = (QuantSpec(kind="pq", m=codebook.m, nbits=codebook.nbits)
                 if isinstance(codebook, PQCodebook) else QuantSpec(kind="sq"))
            spec = BuildSpec(hnsw=spec.hnsw, selector=spec.selector,
                             prefbf_chunk=spec.prefbf_chunk, quant=q)
        if index.n == 0:
            raise ValueError("empty index: an index without base rows comes "
                             "with the live-index slice of the port")
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

        self.prefbf_chunk = min(spec.prefbf_chunk, max(256, index.n))
        padded = prefbf.pad_db(index.vectors, index.norms.astype(np.float32),
                               attrs.ints, attrs.floats, self.prefbf_chunk)
        self._pf = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                         for a in padded)
        # the graph route reads the first N rows of the padded scan arrays:
        # one copy of the corpus on the device
        n = index.n
        pv, pn, pi, pf = self._pf
        self.g = graph_topology(index, dev)
        self.g.update({"vectors": pv[:n], "norms": pn[:n],
                       "attrs_int": pi[:n], "attrs_float": pf[:n]})
        self._quantize(spec.quant, codebook, codes, padded[0])
        self.backend = LocalBackend(self)

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
            self.g["centroids"] = self._cb_dev[0]
        else:
            self._cb_dev = (torch.as_tensor(codebook.lo, device=dev),
                            torch.as_tensor(codebook.scale, device=dev))
            self.g["sq_lo"], self.g["sq_scale"] = self._cb_dev
        self.g["codes"] = self._codes[:index.n]

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

    # -- live mutation: a later slice -------------------------------------------
    def upsert(self, *args, **kwargs):
        raise NotImplementedError(_LIVE)

    def delete(self, *args, **kwargs):
        raise NotImplementedError(_LIVE)

    def merge(self, *args, **kwargs):
        raise NotImplementedError(_LIVE)

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
        ``path + ".quant.npz"``: the JAX package's layout."""
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
