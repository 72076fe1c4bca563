"""HuBERT-XLarge — encoder-only audio backbone; the conv frontend is a
stub (input_specs provides frame embeddings) [arXiv:2106.07447]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, head_dim=80, d_ff=5120, vocab_size=504,
    causal=False, embed_inputs=False, attn_repeat_kv=True,
    dtype="bfloat16", remat=True,
)

REDUCED = ArchConfig(
    name="hubert-smoke", family="encoder", n_layers=3, d_model=128,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=320, vocab_size=64,
    causal=False, embed_inputs=False, attn_chunk=64,
)
