"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: 35L d_model=7168 56H
(GQA kv=8) MoE 128 experts top-2 + dense residual, d_ff=4864, vocab=32000."""
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .base import ArchSpec, lm_cells


def spec() -> ArchSpec:
    cfg = LMConfig(
        name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv=8,
        d_ff=4864, vocab=32000, tie_embeddings=False, param_dtype="bfloat16",
        moe=MoEConfig(n_experts=128, top_k=2, d_model=7168, d_ff=4864,
                      dense_residual=True, d_ff_dense=4864))
    red = LMConfig(
        name="arctic-red", n_layers=2, d_model=64, n_heads=8, n_kv=2,
        d_ff=48, vocab=512, tie_embeddings=False, remat=False,
        moe=MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=48,
                      dense_residual=True, d_ff_dense=48))
    return ArchSpec("arctic-480b", "lm", "hf:Snowflake/snowflake-arctic-base",
                    cfg, red, lm_cells(long_ok=False, arch="arctic-480b"))
