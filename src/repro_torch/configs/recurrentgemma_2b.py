"""RecurrentGemma-2B — RG-LRU + local attention (1:2), MQA
[arXiv:2402.19427; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, head_dim=256, d_ff=7680, vocab_size=256000,
    window=2048, lru_width=2560, rope_theta=10000.0, tie_embeddings=True,
    dtype="bfloat16", remat=True,
)

REDUCED = ArchConfig(
    name="recurrentgemma-2b-smoke", family="hybrid", n_layers=5, d_model=128,
    n_heads=4, n_kv_heads=1, head_dim=32, d_ff=384, vocab_size=512,
    window=32, lru_width=128, attn_chunk=64,
)
