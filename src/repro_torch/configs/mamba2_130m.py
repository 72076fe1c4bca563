"""Mamba2-130M — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    vocab_size=50280, ssm_state=128, expand=2, conv_kernel=4,
    ssm_headdim=64, ssm_ngroups=1, ssm_chunk=256, tie_embeddings=True,
    dtype="bfloat16", remat=True,
)

REDUCED = ArchConfig(
    name="mamba2-smoke", family="ssm", n_layers=3, d_model=96,
    vocab_size=512, ssm_state=16, expand=2, conv_kernel=4,
    ssm_headdim=16, ssm_ngroups=1, ssm_chunk=16, tie_embeddings=True,
)
