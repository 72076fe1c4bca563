"""DeepSeek-67B — dense llama-arch [arXiv:2401.02954; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense", n_layers=95, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=22016, vocab_size=102400,
    rope_theta=10000.0, attn_repeat_kv=True, dtype="bfloat16",
    remat=True,
)

REDUCED = ArchConfig(
    name="deepseek-67b-smoke", family="dense", n_layers=3, d_model=128,
    n_heads=8, n_kv_heads=1, head_dim=16, d_ff=352, vocab_size=512,
    attn_chunk=64,
)
