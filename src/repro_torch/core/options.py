"""Typed build/search options (paper Figure 1 knobs as frozen dataclasses).

  QuantSpec     -- offline memory format of the brute-scan DB (PQ/SQ codes)
  BuildSpec     -- offline construction: HNSW params, selectivity sampling,
                   scan chunking, optional QuantSpec
  SearchOptions -- per-query-batch online knobs (k/ef, routing force,
                   termination)

All three validate eagerly in ``__post_init__``.  The options of the JAX
package that this port does not run yet -- compressed routes (``quant``,
``use_pq``, ``graph_quant``; slice 2) and bucketing (``batch``) -- raise
``NotImplementedError`` instead of being ignored.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from .hnsw import HnswParams
from .search import SearchConfig
from .selector import SelectorConfig

ROUTES = (None, "graph", "brute")
QUANT_KINDS = ("pq", "sq")
GRAPH_QUANT = (None,) + QUANT_KINDS


@dataclass(frozen=True)
class QuantSpec:
    """Compressed memory format for the brute-scan rows.  Validated here;
    indexes that use one come with the compressed routes (slice 2)."""
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
        if self.quant is not None:
            raise NotImplementedError(
                "BuildSpec.quant: compressed indexes come with the compressed "
                "routes (port slice 2)")


@dataclass(frozen=True)
class SearchOptions:
    """Online per-batch options.

    ``force`` pins the route for benchmarks/ablations and must be None,
    "graph" or "brute".  ``max_steps`` bounds the total traversal waves
    across the lane-compaction ladder; 0 keeps the 8*ef safety bound.
    """
    k: int = 10
    ef: int = 100
    pbar_min: float = 0.5
    gamma: float = 1.0
    force: str | None = None
    cand_cap: int = 0
    max_steps: int = 0
    use_pq: bool = False
    graph_quant: str | None = None
    batch: object = None

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
        if self.graph_quant not in GRAPH_QUANT:
            raise ValueError(f"SearchOptions.graph_quant must be one of "
                             f"{GRAPH_QUANT}, got {self.graph_quant!r}")
        if self.use_pq or self.graph_quant is not None:
            raise NotImplementedError(
                "SearchOptions.use_pq / graph_quant: the compressed routes "
                "come in port slice 2")
        if self.batch is not None:
            raise NotImplementedError(
                "SearchOptions.batch: bucketing (core/batching.py) comes in a "
                "later slice of the port")

    def search_config(self) -> SearchConfig:
        """Lower to the config the traversal runs with."""
        return SearchConfig(k=self.k, ef=self.ef, cand_cap=self.cand_cap,
                            max_steps=self.max_steps,
                            pbar_min=self.pbar_min, gamma=self.gamma)

    def with_(self, **overrides) -> "SearchOptions":
        return replace(self, **overrides)
