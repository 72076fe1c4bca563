"""Qwen2-7B — dense, GQA kv=4, QKV bias [arXiv:2407.10671; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, head_dim=128, d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, dtype="bfloat16", remat=True,
)

REDUCED = ArchConfig(
    name="qwen2-7b-smoke", family="dense", n_layers=3, d_model=128,
    n_heads=8, n_kv_heads=2, head_dim=16, d_ff=608, vocab_size=512,
    qkv_bias=True, attn_chunk=64,
)
