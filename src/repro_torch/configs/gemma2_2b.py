"""gemma2-2b [arXiv:2408.00118]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000; local(4096)/global alternating windows, attn softcap 50,
final softcap 30, post-norms, (1+w) RMSNorm, embed scaling, head_dim=256."""
from ..models.transformer import LMConfig
from .base import ArchSpec, lm_cells


def spec() -> ArchSpec:
    cfg = LMConfig(
        name="gemma2-2b", n_layers=26, d_model=2304, n_heads=8, n_kv=4,
        d_ff=9216, vocab=256000, head_dim=256, attn_softcap=50.0,
        final_softcap=30.0, local_window=4096, layer_pattern="local_global",
        post_norms=True, gemma_norm=True, embed_scale=True,
        tie_embeddings=True, param_dtype="bfloat16")
    red = LMConfig(
        name="gemma2-red", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_ff=128, vocab=512, head_dim=32, attn_softcap=50.0, final_softcap=30.0,
        local_window=8, layer_pattern="local_global", post_norms=True,
        gemma_norm=True, embed_scale=True, remat=False)
    # hybrid local/global: long_500k decode is bounded (local layers attend a
    # 4096 window; global layers are linear-in-cache at decode)
    return ArchSpec("gemma2-2b", "lm", "arXiv:2408.00118; hf", cfg, red,
                    lm_cells(long_ok=True, arch="gemma2-2b"))
