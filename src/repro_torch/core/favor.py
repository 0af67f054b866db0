"""FavorIndex: the end-to-end FAVOR API (paper Figure 1 workflow).

Offline:  build a conventional HNSW over the vectors on the host, record
          Delta_d (Eq. 5), draw the selectivity sample, attach the attribute
          table, and move the graph, the rows and the sample to the device.
Online :  compile each query's filter to a DNF program, estimate p_hat on the
          sample (section 4.2), route by lambda (section 4.1), compute the
          exclusion distance D(p_hat) (Eq. 14) and execute either the PreFBF
          scan or the exclusion-distance graph search (section 5), returning
          the k nearest target points.

The online pipeline lives in router.execute; this class owns the offline
state and exposes it through a LocalBackend.  Everything runs on the CUDA
device unless the caller passes ``device="cpu"``; with no CUDA device the
default raises instead of falling back to the CPU.  ``save``/``load`` use
the JAX package's ``.npz`` layout, so an index moves between the two
packages unchanged.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import filters as F
from . import prefbf, selectivity
from .backend import LocalBackend
from .hnsw import HnswIndex, HnswParams, build_hnsw
from .options import BuildSpec, SearchOptions
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
                 spec: BuildSpec | None = None, *, device=None):
        self.device = resolve_device(device)
        if spec is None:
            spec = BuildSpec()
        elif not isinstance(spec, BuildSpec):
            raise TypeError("spec must be a BuildSpec, got "
                            f"{type(spec).__name__}")
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
        self.backend = LocalBackend(self)

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
    def save(self, path: str) -> None:
        """``path + ".hnsw.npz"`` and ``path + ".attrs.npz"``, the JAX
        package's layout."""
        self.index.save(path + ".hnsw.npz")
        np.savez_compressed(path + ".attrs.npz", ints=self.attrs.ints,
                            floats=self.attrs.floats,
                            kinds=np.array([c.kind for c in self.schema.columns]),
                            names=np.array([c.name for c in self.schema.columns]),
                            vocabs=np.array([c.vocab or 0 for c in self.schema.columns]))

    @staticmethod
    def load(path: str, spec: BuildSpec | None = None, *,
             device=None) -> "FavorIndex":
        """Load an index saved by either package (``FavorIndex.save``)."""
        from ..convert import from_reference_arrays
        with np.load(path + ".hnsw.npz") as z:
            if any(k.startswith("quant_") for k in z.files):
                raise NotImplementedError(
                    f"{path!r} carries quantization state: compressed "
                    "indexes come with the compressed routes (port slice 2)")
            n_levels = int(z["n_levels"])
            M, M0, efc, alpha, seed = (int(x) for x in z["params"])
            params = HnswParams(M=M, M0=M0, efc=efc, alpha=alpha, seed=seed,
                                ml=float(z["ml"]))
            hnsw = {"vectors": z["vectors"],
                    "levels": [z[f"level_{l}"] for l in range(n_levels)],
                    "node_level": z["node_level"],
                    "entry_point": int(z["entry_point"]),
                    "max_level": int(z["max_level"]),
                    "delta_d": float(z["delta_d"])}
        with np.load(path + ".attrs.npz") as z:
            schema = [(str(n), str(k), int(v))
                      for n, k, v in zip(z["names"], z["kinds"], z["vocabs"])]
            ints, floats = z["ints"], z["floats"]
        return from_reference_arrays(**hnsw, params=params, ints=ints,
                                     floats=floats, schema=schema, spec=spec,
                                     device=device)
