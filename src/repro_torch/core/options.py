"""Typed build/search options (paper Figure 1 knobs as frozen dataclasses).

  QuantSpec     -- offline memory format of the brute-scan DB (PQ/SQ codes)
  BuildSpec     -- offline construction: HNSW params, selectivity sampling,
                   scan chunking, optional QuantSpec
  SearchOptions -- per-query-batch online knobs (k/ef, routing force,
                   termination)

All three validate eagerly in ``__post_init__``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from .batching import BatchSpec
from .hnsw import HnswParams
from .search import SearchConfig
from .selector import SelectorConfig

ROUTES = (None, "graph", "brute")
QUANT_KINDS = ("pq", "sq")
GRAPH_QUANT = (None,) + QUANT_KINDS


@dataclass(frozen=True)
class QuantSpec:
    """Compressed memory format of the DB rows: PQ (``m`` subspaces of
    2^``nbits`` centroids) or SQ codes, and the exact re-rank depth of the
    compressed brute route (``rerank * k`` candidates)."""
    kind: str = "pq"
    m: int = 8
    nbits: int = 8
    train_iters: int = 20
    train_sample: int = 65536
    rerank: int = 4

    def __post_init__(self):
        if self.kind not in QUANT_KINDS:
            raise ValueError(f"QuantSpec.kind must be one of {QUANT_KINDS}, "
                             f"got {self.kind!r}")
        if not 1 <= self.nbits <= 8:
            raise ValueError(f"QuantSpec.nbits must be in [1, 8] (uint8 "
                             f"codes), got {self.nbits}")
        if self.m < 1:
            raise ValueError(f"QuantSpec.m must be >= 1, got {self.m}")
        if self.rerank < 0:
            raise ValueError(f"QuantSpec.rerank must be >= 0, got {self.rerank}")


@dataclass(frozen=True)
class BuildSpec:
    """Offline construction spec."""
    hnsw: HnswParams | None = None
    selector: SelectorConfig = field(default_factory=SelectorConfig)
    prefbf_chunk: int = 8192
    quant: QuantSpec | None = None

    def __post_init__(self):
        if self.prefbf_chunk < 1:
            raise ValueError(f"BuildSpec.prefbf_chunk must be >= 1, "
                             f"got {self.prefbf_chunk}")
        if self.quant is not None and not isinstance(self.quant, QuantSpec):
            raise TypeError("BuildSpec.quant must be a QuantSpec or None, "
                            f"got {self.quant!r}")
        if self.hnsw is not None and not isinstance(self.hnsw, HnswParams):
            raise TypeError("BuildSpec.hnsw must be HnswParams or None, "
                            f"got {type(self.hnsw).__name__}")


@dataclass(frozen=True)
class SearchOptions:
    """Online per-batch options.

    ``force`` pins the route for benchmarks/ablations and must be None,
    "graph" or "brute".  ``max_steps`` bounds the total traversal waves
    across the lane-compaction ladder; 0 keeps the 8*ef safety bound.

    ``use_pq`` runs the brute route as the compressed ADC scan plus an exact
    re-rank of ``max(k, rerank * k)`` candidates (``rerank=None`` defers to
    the index's ``QuantSpec.rerank``; 0 re-ranks exactly the top k).
    ``graph_quant`` picks the graph route's scorer: None keeps f32, "pq" /
    "sq" score neighbour blocks on the index's codes of that kind and
    exact-re-rank the final top ``max(k, graph_rerank * k)`` TD candidates,
    capped at ef (``graph_rerank=None`` means 4).

    ``batch`` is the shape-stable execution policy (core.batching): when
    set, the router bucket-pads the estimate call and the graph/brute
    sub-batches to the BatchSpec's power-of-two ladder; results are
    bit-identical to ``batch=None``.
    """
    k: int = 10
    ef: int = 100
    pbar_min: float = 0.5
    gamma: float = 1.0
    force: str | None = None
    cand_cap: int = 0
    max_steps: int = 0
    use_pq: bool = False
    rerank: int | None = None
    graph_quant: str | None = None
    graph_rerank: int | None = None
    batch: BatchSpec | None = None

    def __post_init__(self):
        if self.force not in ROUTES:
            raise ValueError(f"SearchOptions.force must be one of {ROUTES}, "
                             f"got {self.force!r}")
        if self.k < 1:
            raise ValueError(f"SearchOptions.k must be >= 1, got {self.k}")
        if self.ef < 1:
            raise ValueError(f"SearchOptions.ef must be >= 1, got {self.ef}")
        if self.cand_cap < 0:
            raise ValueError(f"SearchOptions.cand_cap must be >= 0, "
                             f"got {self.cand_cap}")
        if self.max_steps < 0:
            raise ValueError(f"SearchOptions.max_steps must be >= 0, "
                             f"got {self.max_steps}")
        if self.rerank is not None and self.rerank < 0:
            raise ValueError(f"SearchOptions.rerank must be None or >= 0, "
                             f"got {self.rerank}")
        if self.graph_quant not in GRAPH_QUANT:
            raise ValueError(f"SearchOptions.graph_quant must be one of "
                             f"{GRAPH_QUANT}, got {self.graph_quant!r}")
        if self.graph_rerank is not None and self.graph_rerank < 0:
            raise ValueError(f"SearchOptions.graph_rerank must be None or "
                             f">= 0, got {self.graph_rerank}")
        if self.batch is not None and not isinstance(self.batch, BatchSpec):
            raise TypeError("SearchOptions.batch must be a BatchSpec or "
                            f"None, got {self.batch!r}")

    def search_config(self) -> SearchConfig:
        """Lower to the config the traversal runs with."""
        return SearchConfig(k=self.k, ef=self.ef, cand_cap=self.cand_cap,
                            max_steps=self.max_steps,
                            pbar_min=self.pbar_min, gamma=self.gamma,
                            graph_quant=self.graph_quant,
                            graph_rerank=(4 if self.graph_rerank is None
                                          else self.graph_rerank))

    def with_(self, **overrides) -> "SearchOptions":
        return replace(self, **overrides)
