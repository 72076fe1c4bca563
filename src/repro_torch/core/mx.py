"""Microscaling (MX) quantization in PyTorch — the port of
``repro.core.mx``, with the straight-through estimator that lets the PTQ
pipeline learn transformations through the quantizer.

    s_i = 2^( floor(log2(max_{j in I_i} |x_j|)) - r_max )
    Q(x)_j = s_i * Q_e(x_j / s_i)

Block exponent: ``floor(log2(amax))`` is taken *exactly* from the float's
bits (``torch.frexp``), with amax == 0 mapped to scale 1. The CUDA kernels
use the same definition (``ilogbf``), so the plain versions and the kernels
are byte-identical on the card. The JAX package rounds ``log2`` in f32
first, which lands one exponent higher for amax just below a power of two
(``nextafter(2^k, 0)``); ``tests/test_torch_numerics.py`` pins that list.

Snap: ``searchsorted(mids, |z|, right=True)`` — a magnitude equal to a
midpoint goes to the larger grid value (the ``>=`` compares of the Pallas
tile) — and the sign comes from ``z < 0``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

# FP4 E2M1 positive grid per OCP MX spec: max exponent r_max = 2, max = 6.0
_FP4_POS = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float64)
# FP6 E2M3 positive grid
_FP6_POS = np.concatenate(
    [
        np.arange(0, 8) / 8.0,
        (8 + np.arange(0, 8)) / 8.0,
        (8 + np.arange(0, 8)) / 4.0,
        (8 + np.arange(0, 8)) / 2.0,
    ]
).astype(np.float64)


def _fp8_e4m3_grid() -> np.ndarray:
    """Positive representable values of FP8 E4M3 (OCP variant, max 448)."""
    vals = [0.0]
    for e in range(0, 16):
        for m in range(0, 8):
            if e == 0:
                v = (m / 8.0) * 2.0 ** (-6)
            else:
                v = (1 + m / 8.0) * 2.0 ** (e - 7)
            vals.append(v)
    vals = sorted(set(v for v in vals if v <= 448.0))
    return np.array(vals, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ElementFormat:
    """A symmetric low-precision element format defined by its value grid."""

    name: str
    bits: int
    grid: tuple  # positive half-grid including 0, ascending
    r_max: int   # max representable power-of-two exponent (for scale calc)

    @property
    def max_val(self) -> float:
        return float(self.grid[-1])

    def full_grid(self) -> np.ndarray:
        pos = np.asarray(self.grid, dtype=np.float64)
        return np.concatenate([-pos[::-1][:-1], pos])


FP4 = ElementFormat("fp4_e2m1", 4, tuple(_FP4_POS.tolist()), r_max=2)
FP6 = ElementFormat("fp6_e2m3", 6, tuple(_FP6_POS.tolist()), r_max=2)
FP8 = ElementFormat("fp8_e4m3", 8, tuple(_fp8_e4m3_grid().tolist()), r_max=8)
INT4 = ElementFormat("int4", 4, tuple(np.arange(0.0, 8.0).tolist()), r_max=2)
INT8 = ElementFormat("int8", 8, tuple(np.arange(0.0, 128.0).tolist()), r_max=6)

FORMATS = {f.name: f for f in (FP4, FP6, FP8, INT4, INT8)}
FORMATS.update({"mxfp4": FP4, "mxint4": INT4, "mxfp8": FP8, "mxfp6": FP6,
                "mxint8": INT8})


@dataclasses.dataclass(frozen=True)
class MXConfig:
    """Configuration of an MX quantizer (same fields as the JAX package,
    so artifacts' quant modes round-trip). ``block_size`` divides the last
    axis; ``scale_mode`` is 'pow2' (OCP MX) or 'fp8' (NVFP4-style)."""

    fmt: str = "mxfp4"
    block_size: int = 32
    scale_mode: str = "pow2"
    stochastic: bool = False

    @property
    def element(self) -> ElementFormat:
        return FORMATS[self.fmt]


NVFP4 = MXConfig(fmt="mxfp4", block_size=16, scale_mode="fp8")


def _grid_t(grid, dtype, device) -> tuple:
    """(grid, midpoints) as tensors; the midpoints are computed in the
    working dtype exactly as the JAX package does (exact in f32)."""
    g = torch.as_tensor(np.asarray(grid), dtype=dtype, device=device)
    return g, (g[1:] + g[:-1]) / 2.0


def _snap_to_grid(x: torch.Tensor, grid) -> torch.Tensor:
    g, mids = _grid_t(grid, x.dtype, x.device)
    idx = torch.searchsorted(mids, x.abs().contiguous(), right=True)
    return torch.sign(x) * g[idx]


def block_exponent(amax: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2(amax))`` as int32 (amax > 0), from the float bits."""
    _, e = torch.frexp(amax.float())
    return (e - 1).to(torch.int32)


def compute_scales(x: torch.Tensor, cfg: MXConfig) -> torch.Tensor:
    """Per-block scales for the last axis of ``x``: shape
    x.shape[:-1] + (x.shape[-1] // B,), float32."""
    B = cfg.block_size
    *lead, d = x.shape
    if d % B != 0:
        raise ValueError(f"last dim {d} not divisible by block size {B}")
    amax = x.reshape(*lead, d // B, B).abs().amax(dim=-1).float()
    if cfg.scale_mode == "pow2":
        e = block_exponent(amax) - cfg.element.r_max
        s = torch.ldexp(torch.ones_like(amax), e)
        return torch.where(amax > 0, s, torch.ones_like(s))
    if cfg.scale_mode == "fp8":
        s = _snap_to_grid(amax / cfg.element.max_val, FP8.grid)
        return torch.where(s > 0, s, torch.ones_like(s))
    raise ValueError(f"unknown scale_mode {cfg.scale_mode}")


def _quantize_value(x: torch.Tensor, cfg: MXConfig) -> torch.Tensor:
    B = cfg.block_size
    *lead, d = x.shape
    scales = compute_scales(x, cfg)
    xb = x.reshape(*lead, d // B, B)
    z = xb / scales[..., None].to(x.dtype)
    q = _snap_to_grid(z, cfg.element.grid)
    return (q * scales[..., None].to(x.dtype)).reshape(*lead, d)


class _QuantizeSTE(torch.autograd.Function):
    """Fake quantization whose backward is the identity (straight-through:
    d quantize / dx = I)."""

    @staticmethod
    def forward(ctx, x, cfg):
        return _quantize_value(x, cfg)

    @staticmethod
    def backward(ctx, g):
        return g, None


def quantize(x: torch.Tensor, cfg: MXConfig | None = None, *,
             ste: bool = True) -> torch.Tensor:
    """MX fake-quantize ``x`` along its last axis (values land exactly on
    the element grid times the block scale). With ``ste`` the gradient
    passes straight through; otherwise none flows (the snap's derivative
    is zero almost everywhere)."""
    cfg = cfg or MXConfig()
    if ste and torch.is_grad_enabled() and x.requires_grad:
        return _QuantizeSTE.apply(x, cfg)
    return _quantize_value(x, cfg)


def quantization_mse(x: torch.Tensor,
                     cfg: MXConfig | None = None) -> torch.Tensor:
    """Mean squared quantization error of x under cfg (Definition 3.2 with
    T = identity)."""
    q = _quantize_value(x, cfg or MXConfig())
    return torch.mean((x - q) ** 2)


def blockwise_error(x: torch.Tensor, q: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """Per-MX-block squared error E_B^i (Sec. 3.1): the mean over the
    elements of each block position and every leading index."""
    *lead, d = x.shape
    e = ((x - q) ** 2).reshape(*lead, d // block_size, block_size)
    return torch.mean(e, dim=(-1,) + tuple(range(len(lead))))


def encode(x: torch.Tensor, cfg: MXConfig | None = None):
    """Quantize and return (codes uint8, scales f32). Codes index the full
    symmetric grid: ``center ± halfgrid_index(|z|)``."""
    cfg = cfg or MXConfig()
    B = cfg.block_size
    *lead, d = x.shape
    scales = compute_scales(x, cfg)
    xb = x.reshape(*lead, d // B, B)
    z = (xb / scales[..., None].to(x.dtype)).reshape(*lead, d).float()
    _, mids = _grid_t(cfg.element.grid, torch.float32, x.device)
    idx = torch.searchsorted(mids, z.abs().contiguous(), right=True)
    center = len(cfg.element.grid) - 1
    codes = center + torch.where(z < 0, -idx, idx)
    return codes.to(torch.uint8), scales


@functools.lru_cache(maxsize=None)
def _full_grid_np(fmt: str) -> np.ndarray:
    return FORMATS[fmt].full_grid()


def decode(codes: torch.Tensor, scales: torch.Tensor,
           cfg: MXConfig | None = None,
           dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`encode`: one LUT gather + a per-block scale
    multiply."""
    cfg = cfg or MXConfig()
    B = cfg.block_size
    full = torch.as_tensor(_full_grid_np(cfg.fmt), dtype=dtype,
                           device=codes.device)
    vals = full[codes.long()]
    *lead, d = vals.shape
    vb = vals.reshape(*lead, d // B, B) * scales[..., None].to(dtype)
    return vb.reshape(*lead, d)


def packed_nbytes(shape: Sequence[int], cfg: MXConfig | None = None) -> int:
    """Deployable byte count: packed codes + 1 E8M0 byte per block."""
    cfg = cfg or MXConfig()
    n = int(np.prod(shape))
    return n * cfg.element.bits // 8 + n // cfg.block_size
