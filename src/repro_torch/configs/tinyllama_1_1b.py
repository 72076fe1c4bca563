"""TinyLlama-1.1B — llama2-arch small, GQA kv=4 [arXiv:2401.02385; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=64, d_ff=5632, vocab_size=32000,
    rope_theta=10000.0, attn_repeat_kv=True, dtype="bfloat16",
    remat=True,
)

REDUCED = ArchConfig(
    name="tinyllama-1.1b-smoke", family="dense", n_layers=3, d_model=128,
    n_heads=8, n_kv_heads=1, head_dim=16, d_ff=352, vocab_size=512,
    attn_chunk=64,
)
