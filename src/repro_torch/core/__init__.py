"""FAVOR core on PyTorch: the paper's contribution as a torch/CUDA library."""
from . import (batching, exclusion, filters, prefbf, refimpl, router,
               selectivity, selector)
from .backend import Backend, LocalBackend, ShardedBackend
from .batching import BatchSpec, ShapeRegistry
from .favor import FavorIndex, resolve_device
from .filters import (And, AttributeTable, ColumnSpec, Equality, FalseFilter,
                      Filter, Inclusion, Not, Or, Range, Schema, TrueFilter,
                      batch_signatures, compile_filter, filter_signature,
                      paper_filters, paper_schema, program_signature,
                      random_attributes, stack_programs)
from .hnsw import HnswIndex, HnswParams, build_hnsw
from .options import (BuildSpec, CacheSpec, FrontEndSpec, ObsSpec, QuantSpec,
                      SearchOptions, TenantSpec)
from .router import RoutePlan, SearchResult
from .scoring import (ExactScorer, PqAdcScorer, Scorer, SqScorer,
                      exclusion_compose, scorer_for)
from .search import (SearchConfig, favor_graph_search, graph_arrays,
                     rsf_graph_search)

__all__ = [
    "And", "AttributeTable", "Backend", "BatchSpec", "BuildSpec",
    "CacheSpec", "ColumnSpec", "Equality", "ExactScorer", "FalseFilter",
    "Filter", "FavorIndex", "FrontEndSpec", "HnswIndex", "HnswParams",
    "Inclusion", "LocalBackend", "Not", "ObsSpec", "Or", "PqAdcScorer",
    "QuantSpec", "Range", "RoutePlan", "Schema", "Scorer", "SearchConfig",
    "SearchOptions", "SearchResult", "ShapeRegistry", "ShardedBackend",
    "SqScorer", "TenantSpec", "TrueFilter", "batching", "batch_signatures",
    "build_hnsw", "compile_filter", "exclusion", "exclusion_compose",
    "favor_graph_search",
    "filter_signature", "filters", "graph_arrays", "paper_filters",
    "paper_schema", "prefbf", "program_signature", "random_attributes",
    "refimpl", "resolve_device", "router", "rsf_graph_search",
    "scorer_for", "selectivity", "selector", "stack_programs",
]
