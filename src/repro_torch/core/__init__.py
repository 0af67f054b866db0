"""FAVOR core on PyTorch: the paper's contribution as a torch/CUDA library."""
from . import exclusion, filters, prefbf, refimpl, router, selectivity, selector
from .backend import LocalBackend
from .favor import FavorIndex, resolve_device
from .filters import (And, AttributeTable, ColumnSpec, Equality, FalseFilter,
                      Filter, Inclusion, Not, Or, Range, Schema, TrueFilter,
                      batch_signatures, compile_filter, filter_signature,
                      paper_filters, paper_schema, program_signature,
                      random_attributes, stack_programs)
from .hnsw import HnswIndex, HnswParams, build_hnsw
from .options import BuildSpec, QuantSpec, SearchOptions
from .router import RoutePlan, SearchResult
from .scoring import ExactScorer
from .search import (SearchConfig, favor_graph_search, graph_arrays,
                     rsf_graph_search)

__all__ = [
    "And", "AttributeTable", "BuildSpec", "ColumnSpec", "Equality",
    "ExactScorer", "FalseFilter", "Filter", "FavorIndex", "HnswIndex",
    "HnswParams", "Inclusion", "LocalBackend", "Not", "Or", "QuantSpec",
    "Range", "RoutePlan", "Schema", "SearchConfig", "SearchOptions",
    "SearchResult", "TrueFilter", "batch_signatures", "build_hnsw",
    "compile_filter", "exclusion", "favor_graph_search",
    "filter_signature", "filters", "graph_arrays", "paper_filters",
    "paper_schema", "prefbf", "program_signature", "random_attributes",
    "refimpl", "resolve_device", "router", "rsf_graph_search",
    "selectivity", "selector", "stack_programs",
]
