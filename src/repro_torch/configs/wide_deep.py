"""wide-deep [arXiv:1606.07792]: 40 sparse fields, embed_dim=32,
deep MLP 1024-512-256, concat interaction."""
from ..models.recsys import WideDeepConfig
from .base import ArchSpec, RECSYS_CELLS


def spec() -> ArchSpec:
    cfg = WideDeepConfig(name="wide-deep", n_sparse=40, vocab=1_000_000,
                         embed_dim=32, mlp=(1024, 512, 256))
    red = WideDeepConfig(name="wd-red", n_sparse=8, vocab=1000, embed_dim=8,
                         mlp=(32, 16))
    return ArchSpec("wide-deep", "recsys", "arXiv:1606.07792; paper", cfg,
                    red, RECSYS_CELLS)
