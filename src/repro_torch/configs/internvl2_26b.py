"""InternVL2-26B — InternLM2 LM backbone; InternViT frontend is a stub
(input_specs provides patch embeddings) [arXiv:2404.16821; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=92553,
    embed_inputs=False, rope_theta=1e6, attn_repeat_kv=True,
    dtype="bfloat16", remat=True,
)

REDUCED = ArchConfig(
    name="internvl2-smoke", family="vlm", n_layers=3, d_model=128,
    n_heads=8, n_kv_heads=2, head_dim=16, d_ff=384, vocab_size=512,
    embed_inputs=False, attn_chunk=64,
)
