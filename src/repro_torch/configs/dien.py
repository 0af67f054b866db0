"""dien [arXiv:1809.03672; unverified]: embed_dim=18, seq_len=100,
GRU dim=108, AUGRU interest evolution, MLP 200-80."""
from ..models.recsys import DIENConfig
from .base import ArchSpec, RECSYS_CELLS


def spec() -> ArchSpec:
    cfg = DIENConfig(name="dien", vocab=1_000_000, embed_dim=18, seq_len=100,
                     gru_dim=108, mlp=(200, 80))
    red = DIENConfig(name="dien-red", vocab=1000, embed_dim=18, seq_len=12,
                     gru_dim=24, mlp=(20, 8))
    return ArchSpec("dien", "recsys", "arXiv:1809.03672; unverified", cfg,
                    red, RECSYS_CELLS,
                    notes="aux loss of the original omitted (DESIGN.md)")
