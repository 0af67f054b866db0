"""qwen1.5-32b [hf:Qwen/Qwen1.5-*]: 64L d_model=5120 40H (kv=40)
d_ff=27392 vocab=152064, QKV bias."""
from ..models.transformer import LMConfig
from .base import ArchSpec, lm_cells


def spec() -> ArchSpec:
    cfg = LMConfig(
        name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv=40,
        d_ff=27392, vocab=152064, qkv_bias=True, tie_embeddings=False,
        param_dtype="bfloat16")
    red = LMConfig(
        name="qwen-red", n_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=128, vocab=512, qkv_bias=True, tie_embeddings=False, remat=False)
    return ArchSpec("qwen1.5-32b", "lm", "hf:Qwen/Qwen1.5-0.5B; hf", cfg, red,
                    lm_cells(long_ok=False, arch="qwen1.5-32b"))
