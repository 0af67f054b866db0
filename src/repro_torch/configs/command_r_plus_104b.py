"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01; unverified]:
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, LayerNorm, no bias."""
from ..models.transformer import LMConfig
from .base import ArchSpec, lm_cells


def spec() -> ArchSpec:
    cfg = LMConfig(
        name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
        n_kv=8, d_ff=33792, vocab=256000, norm="layernorm",
        tie_embeddings=True, param_dtype="bfloat16")
    red = LMConfig(
        name="commandr-red", n_layers=2, d_model=96, n_heads=8, n_kv=2,
        d_ff=192, vocab=512, norm="layernorm", remat=False)
    return ArchSpec("command-r-plus-104b", "lm",
                    "hf:CohereForAI/c4ai-command-r-v01; unverified", cfg, red,
                    lm_cells(long_ok=False, arch="command-r-plus-104b"))
