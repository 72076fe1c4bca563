"""Moonshot/Moonlight-16B-A3B — MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=163840,
    n_experts=64, top_k=6, n_shared_experts=0, capacity_factor=1.25,
    moe_groups=32, rope_theta=50000.0, dtype="bfloat16", remat=True,
)

REDUCED = ArchConfig(
    name="moonshot-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=96, vocab_size=512,
    n_experts=8, top_k=2, n_shared_experts=0, capacity_factor=4.0,
    attn_chunk=64,
)
