"""Qwen2-0.5B — dense, GQA kv=2, QKV bias, tied embeddings
[arXiv:2407.10671; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, head_dim=64, d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6, dtype="bfloat16",
    remat=True,
)

REDUCED = ArchConfig(
    name="qwen2-0.5b-smoke", family="dense", n_layers=3, d_model=128,
    n_heads=8, n_kv_heads=2, head_dim=16, d_ff=320, vocab_size=512,
    qkv_bias=True, tie_embeddings=True, attn_chunk=64,
)
