"""The fixed block-Hadamard used by the online T3 rotation (the serving
part of ``repro.core.transforms``; the learnable transforms come with the
PTQ slice)."""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    """Sylvester construction, cached."""
    if n & (n - 1) != 0:
        raise ValueError(f"Hadamard size must be a power of 2, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h / np.sqrt(n)


def hadamard_matrix(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Sylvester-ordered Hadamard matrix, scaled to be orthogonal."""
    return torch.as_tensor(_hadamard_np(n), dtype=dtype, device=device)


def apply_blockwise(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Multiply the last axis of x by blockdiag(h): x (..., d), h (b, b).

    The products of f32 values with f32 matrix entries are exact in
    float64, so the block sums are accumulated there and rounded once to
    x's dtype. That pins the rotated value independently of summation
    order, which is what keeps this plain version and the GEMM kernel's
    T3 prologue (the same f64 accumulation) on the same side of every
    snap midpoint."""
    b = h.shape[0]
    *lead, d = x.shape
    xb = x.reshape(*lead, d // b, b).double()
    yb = xb @ h.to(torch.float32).double()
    return yb.reshape(*lead, d).to(x.dtype)
