"""Typed build/search options (paper Figure 1 knobs as frozen dataclasses).

  QuantSpec     -- offline memory format of the brute-scan DB (PQ/SQ codes)
  BuildSpec     -- offline construction: HNSW params, selectivity sampling,
                   scan chunking, optional QuantSpec
  SearchOptions -- per-query-batch online knobs (k/ef, routing force,
                   termination)
  CacheSpec     -- the serving cache layers (repro_torch.cache)
  TenantSpec    -- one tenant's QoS contract under the async front-end
  FrontEndSpec  -- the async front-end's policy (repro_torch.serving.frontend)
  ObsSpec       -- observability policy of one serving stack (repro_torch.obs)

All of them validate eagerly in ``__post_init__``.
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
class CacheSpec:
    """Serving-side cache configuration (``repro_torch.cache``).

    Three layers, all keyed by the canonical filter signature
    (``filters.filter_signature``) and all LRU+TTL bounded:

      selectivity -- signature -> p_hat; skips ``backend.estimate`` for
                     repeat filters.  Exact: the estimator is deterministic
                     over the fixed sample, so a hit returns the same value.
      candidates  -- signature -> matching-ID set for hot *low-selectivity*
                     filters; repeat brute routes scan only the cached block
                     instead of the full corpus.  Exact: the ID set is the
                     predicate's true extension.
      semantic    -- (query vector, signature, opts) -> top-k, redisvl-style.
                     ``semantic_threshold`` is the max L2 distance between
                     the incoming and cached query vector for a hit; the
                     default 0.0 serves only exact repeats and is therefore
                     lossless, larger values trade recall for QPS.

    ``ttl_s=None`` disables time-based expiry (epoch invalidation via
    ``Backend.version()`` still applies).  ``candidate_p_max`` gates which
    signatures get an ID set (only filters that route brute benefit);
    ``candidate_max_ids`` bounds one entry's memory.
    """
    selectivity: bool = True
    candidates: bool = True
    semantic: bool = True
    selectivity_cap: int = 4096
    candidate_cap: int = 64
    candidate_p_max: float = 0.02
    candidate_max_ids: int = 262144
    semantic_cap: int = 1024
    semantic_per_key: int = 32
    semantic_threshold: float = 0.0
    ttl_s: float | None = None

    def __post_init__(self):
        for name in ("selectivity_cap", "candidate_cap", "semantic_cap",
                     "semantic_per_key", "candidate_max_ids"):
            if getattr(self, name) < 1:
                raise ValueError(f"CacheSpec.{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if not 0.0 <= self.candidate_p_max <= 1.0:
            raise ValueError("CacheSpec.candidate_p_max must be in [0, 1], "
                             f"got {self.candidate_p_max}")
        if self.semantic_threshold < 0.0:
            raise ValueError("CacheSpec.semantic_threshold must be >= 0, "
                             f"got {self.semantic_threshold}")
        if self.ttl_s is not None and self.ttl_s <= 0:
            raise ValueError(f"CacheSpec.ttl_s must be None or > 0, "
                             f"got {self.ttl_s}")

    def with_(self, **overrides) -> "CacheSpec":
        return replace(self, **overrides)


@dataclass(frozen=True)
class TenantSpec:
    """Per-tenant QoS contract for the async serving front-end
    (``repro_torch.serving.frontend``).

    ``weight`` sets the tenant's share under weighted fair dequeue (2.0 gets
    twice the dequeue rate of 1.0 under contention).  ``rate_qps``/``burst``
    parameterize the admission token bucket (None disables rate limiting);
    ``queue_cap`` bounds the tenant's pending queue (overflow is shed with a
    structured ``Overloaded``); ``deadline_ms`` is the default per-request
    deadline (requests still queued past it are shed, never served late).
    """
    weight: float = 1.0
    rate_qps: float | None = None
    burst: int = 16
    queue_cap: int = 1024
    deadline_ms: float | None = None

    def __post_init__(self):
        if not self.weight > 0.0:
            raise ValueError(f"TenantSpec.weight must be > 0, "
                             f"got {self.weight}")
        if self.rate_qps is not None and not self.rate_qps > 0.0:
            raise ValueError(f"TenantSpec.rate_qps must be None or > 0, "
                             f"got {self.rate_qps}")
        if self.burst < 1:
            raise ValueError(f"TenantSpec.burst must be >= 1, "
                             f"got {self.burst}")
        if self.queue_cap < 1:
            raise ValueError(f"TenantSpec.queue_cap must be >= 1, "
                             f"got {self.queue_cap}")
        if self.deadline_ms is not None and not self.deadline_ms > 0.0:
            raise ValueError(f"TenantSpec.deadline_ms must be None or > 0, "
                             f"got {self.deadline_ms}")

    def with_(self, **overrides) -> "TenantSpec":
        return replace(self, **overrides)


@dataclass(frozen=True)
class FrontEndSpec:
    """Policy for one logical async front-end over a ServeEngine.

    ``coalesce_ms`` is the cross-step batch-coalescing window: an
    under-filled batch is held up to this long for more arrivals before it
    is dispatched, so low arrival rates stop paying bucket-pad overhead
    (0.0 dispatches immediately -- the uncoalesced baseline).
    ``coalesce_target`` is the fill level (rows) that releases a held batch
    early; None targets the dispatch cap.  ``max_batch`` caps one dispatch
    (None defers to the engine's ``max_batch``).  ``admission=False``
    disables the token buckets *and* the queue caps (pure unbounded FIFO --
    the no-QoS baseline); ``fair=False`` replaces weighted fair dequeue
    with global FIFO order.  ``tenants`` maps tenant name -> TenantSpec
    (accepted as a dict, stored canonically as a sorted tuple of pairs);
    unknown tenants fall back to ``default_tenant``.
    """
    coalesce_ms: float = 0.0
    coalesce_target: int | None = None
    max_batch: int | None = None
    admission: bool = True
    fair: bool = True
    default_tenant: TenantSpec = field(default_factory=TenantSpec)
    tenants: tuple = ()
    latency_window: int = 4096
    # executor slots for pipelined step dispatch: N > 1 lets the front-end
    # overlap one step's device wait with the next step's host phase
    # (routing/cache), riding the card's asynchronous launches.  Responses
    # still resolve in dispatch order; 1 = the serialized baseline.
    parallel_steps: int = 1

    def __post_init__(self):
        if self.coalesce_ms < 0.0:
            raise ValueError(f"FrontEndSpec.coalesce_ms must be >= 0, "
                             f"got {self.coalesce_ms}")
        if self.parallel_steps < 1:
            raise ValueError(f"FrontEndSpec.parallel_steps must be >= 1, "
                             f"got {self.parallel_steps}")
        for name in ("coalesce_target", "max_batch"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"FrontEndSpec.{name} must be None or >= 1, "
                                 f"got {v}")
        if self.latency_window < 1:
            raise ValueError(f"FrontEndSpec.latency_window must be >= 1, "
                             f"got {self.latency_window}")
        if not isinstance(self.default_tenant, TenantSpec):
            raise TypeError("FrontEndSpec.default_tenant must be a "
                            f"TenantSpec, got {self.default_tenant!r}")
        tenants = self.tenants
        if isinstance(tenants, dict):
            tenants = tuple(sorted(tenants.items()))
            object.__setattr__(self, "tenants", tenants)
        for pair in tenants:
            if (not isinstance(pair, tuple) or len(pair) != 2
                    or not isinstance(pair[0], str)
                    or not isinstance(pair[1], TenantSpec)):
                raise TypeError("FrontEndSpec.tenants must map tenant name "
                                f"-> TenantSpec, got {pair!r}")

    def tenant(self, name: str) -> TenantSpec:
        """The spec configured for ``name`` (``default_tenant`` otherwise)."""
        for n, spec in self.tenants:
            if n == name:
                return spec
        return self.default_tenant

    def with_(self, **overrides) -> "FrontEndSpec":
        return replace(self, **overrides)


@dataclass(frozen=True)
class ObsSpec:
    """Observability policy for one serving stack (``repro.obs``).

    ``enabled=False`` turns off tracing, probes and kernel annotations
    wholesale -- the engine still keeps its registry counters (they back
    ``ServeEngine.stats``) but the router's hot path takes zero extra
    branches per stage and results are bit-identical.

    ``trace_sample`` is the fraction of engine batches that get a full
    per-stage span trace (deterministic 1-in-N, not random, so runs
    reproduce); traced batches whose wall time exceeds ``slow_ms`` land
    per-query entries -- filter signature, p_hat, route, ef, stage
    timings -- in a ``slow_cap``-bounded ring buffer (``slow_ms=None``
    disables the slow-query log).

    ``probe_sample`` is the fraction of batches on which one query's
    estimated selectivity is checked against the filter's *true* match
    fraction over the corpus attributes (estimator-accuracy error
    histogram + route-flip counter); ``shadow_sample`` is the fraction on
    which one query is additionally re-executed on BOTH routes against the
    cache-unwrapped backend to populate the route-decision confusion
    counter (would-have-been-faster-on-the-other-route).  Both default to
    0.0: they cost real work and are bench/diagnostic knobs, not
    steady-state ones.

    ``kernel_annotations`` makes every span of a sampled trace, and each
    wait on the device inside it, a host-side
    ``torch.profiler.record_function`` range named by its path
    (``favor/graph/search``, ``repro_torch.obs.trace``), and wraps backend
    dispatches in ranges of their own (``repro_torch.obs.profiling``), so a
    ``torch.profiler`` capture attributes device time and idle gaps to
    router stages and routes.

    ``latency_buckets`` are the shared histogram upper bounds (seconds)
    for request latency and per-stage timings.
    """
    enabled: bool = True
    trace_sample: float = 1.0
    trace_cap: int = 256
    slow_ms: float | None = 100.0
    slow_cap: int = 128
    probe_sample: float = 0.0
    shadow_sample: float = 0.0
    kernel_annotations: bool = False
    latency_buckets: tuple = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                              0.05, 0.1, 0.25, 0.5, 1.0, 2.5)

    def __post_init__(self):
        for name in ("trace_sample", "probe_sample", "shadow_sample"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"ObsSpec.{name} must be in [0, 1], "
                                 f"got {v}")
        for name in ("trace_cap", "slow_cap"):
            if getattr(self, name) < 1:
                raise ValueError(f"ObsSpec.{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if self.slow_ms is not None and self.slow_ms < 0.0:
            raise ValueError(f"ObsSpec.slow_ms must be None or >= 0, "
                             f"got {self.slow_ms}")
        buckets = tuple(float(b) for b in self.latency_buckets)
        if not buckets or any(b <= 0 for b in buckets) or \
                any(a >= b for a, b in zip(buckets, buckets[1:])):
            raise ValueError("ObsSpec.latency_buckets must be strictly "
                             f"increasing positive bounds, got {buckets}")
        object.__setattr__(self, "latency_buckets", buckets)

    def with_(self, **overrides) -> "ObsSpec":
        return replace(self, **overrides)


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

    There is no ``use_pallas``: the tensors' device picks kernel or plain
    version (the hand-written kernels on the card, the plain versions on
    the CPU), and on the card no option selects the plain version.
    ``ServeEngine.stats["scorers"]["use_pallas"]`` reports whether the
    kernels serve the routes.
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
