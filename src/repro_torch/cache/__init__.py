"""Serving-side cache subsystem (see core.options.CacheSpec for knobs).

``CachingBackend`` wraps the port's ``LocalBackend`` and plugs into
``router.execute``/``ServeEngine`` unchanged:

    from repro_torch.cache import CachingBackend
    eng = ServeEngine(CachingBackend(LocalBackend(fi), CacheSpec()), opts)

Keys are canonical filter signatures (``core.filters.filter_signature``), so
semantically equivalent predicates share cache entries across all three
layers (selectivity, candidate block, semantic result).  The layers are host
numpy; ``CachingBackend`` is where values cross from the card to the host.
"""
from ..core.options import CacheSpec
from .backend import CachingBackend
from .layers import CandidateCache, SelectivityCache, SemanticResultCache
from .lru import LruTtlCache

__all__ = ["CacheSpec", "CachingBackend", "CandidateCache", "LruTtlCache",
           "SelectivityCache", "SemanticResultCache"]
