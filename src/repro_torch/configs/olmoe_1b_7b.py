"""olmoe-1b-7b [arXiv:2409.02060]: 16L d_model=2048 16H (GQA kv=16)
MoE 64 experts top-8, expert d_ff=1024, vocab=50304."""
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .base import ArchSpec, lm_cells


def spec() -> ArchSpec:
    cfg = LMConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16, n_kv=16,
        d_ff=1024, vocab=50304, tie_embeddings=False, param_dtype="bfloat16",
        moe=MoEConfig(n_experts=64, top_k=8, d_model=2048, d_ff=1024))
    red = LMConfig(
        name="olmoe-red", n_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=32, vocab=512, tie_embeddings=False, remat=False,
        moe=MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=32))
    return ArchSpec("olmoe-1b-7b", "lm", "arXiv:2409.02060; hf", cfg, red,
                    lm_cells(long_ok=False, arch="olmoe-1b-7b"))
