"""Qwen1.5-MoE-A2.7B — 60 routed top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=151936,
    qkv_bias=True, n_experts=60, top_k=4, n_shared_experts=4,
    capacity_factor=1.25, moe_groups=32, rope_theta=1e6, dtype="bfloat16",
    remat=True,
)

REDUCED = ArchConfig(
    name="qwen2-moe-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=96, vocab_size=512,
    qkv_bias=True, n_experts=6, top_k=2, n_shared_experts=2,
    capacity_factor=3.0, attn_chunk=64,
)
