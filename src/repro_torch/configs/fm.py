"""fm [Rendle ICDM'10]: 39 sparse fields, embed_dim=10, 2-way interactions
via the O(nk) sum-square trick."""
from ..models.recsys import FMConfig
from .base import ArchSpec, RECSYS_CELLS


def spec() -> ArchSpec:
    cfg = FMConfig(name="fm", n_sparse=39, vocab=1_000_000, embed_dim=10)
    red = FMConfig(name="fm-red", n_sparse=8, vocab=1000, embed_dim=10)
    return ArchSpec("fm", "recsys", "ICDM'10 (Rendle); paper", cfg, red,
                    RECSYS_CELLS,
                    notes="uniform 1e6-row vocab per field (criteo-scale)")
