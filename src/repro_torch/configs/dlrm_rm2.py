"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse, embed_dim=64,
bot 512-256-64, top 512-512-256-1, dot interaction."""
from ..models.recsys import DLRMConfig
from .base import ArchSpec, RECSYS_CELLS


def spec() -> ArchSpec:
    cfg = DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26,
                     vocab=1_000_000, embed_dim=64,
                     bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256))
    red = DLRMConfig(name="dlrm-red", n_dense=13, n_sparse=6, vocab=1000,
                     embed_dim=16, bot_mlp=(32, 16), top_mlp=(32, 16))
    return ArchSpec("dlrm-rm2", "recsys", "arXiv:1906.00091; paper", cfg,
                    red, RECSYS_CELLS)
