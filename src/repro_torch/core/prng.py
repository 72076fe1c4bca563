"""``jax.random``'s threefry2x32 keys and draws in PyTorch.

Keys are pairs of ``int64`` tensors holding uint32 words (adds, xors and
rotations masked to 32 bits), so the integers are the same on the CPU and
on the card. ``prng_key``, ``fold_in``, ``split``, ``random_bits``,
``uniform``, ``bernoulli`` and ``rademacher`` are bitwise those of
``jax.random`` under its partitionable threefry scheme (the default). The
``normal`` draw is ``sqrt(2) * erfinv(u)`` with u uniform on (-1, 1), as in
``jax.random.normal``, with XLA's float32 ``erf_inv`` (Giles'
polynomial, its steps fused multiply-adds); the ``log1p`` inside may part
from XLA's in the last bit, so a normal draw may part from jax's by an ulp
or two.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# Giles, "Approximating the erfinv function": float32 coefficients, highest
# degree first, for w = -log1p(-x^2) below 5 and from 5 up
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pair ``(x1, x2)``
    under the key ``(k1, k2)``: int64 tensors holding uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    y0 = (x1 + ks[0]) & _M32
    y1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0 = (y0 + y1) & _M32
            y1 = _rotl(y1, r) ^ y0
        y0 = (y0 + ks[(i + 1) % 3]) & _M32
        y1 = (y1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return y0, y1


def prng_key(seed, device=None) -> tuple:
    """``jax.random.PRNGKey`` of uint32 seeds: the key ``(0, seed)`` (a
    tensor of seeds gives a batch of keys)."""
    s = torch.as_tensor(seed, device=device).long() & _M32
    return torch.zeros_like(s), s


def fold_in(key: tuple, data) -> tuple:
    """``jax.random.fold_in``: the hash of the count pair ``(0, data)``
    under ``key``. ``data`` broadcasts against the key's batch shape."""
    k1, k2 = key
    d = torch.as_tensor(data, device=k1.device).long() & _M32
    return threefry2x32(k1, k2, torch.zeros_like(d), d)


def split(key: tuple, num: int = 2) -> list:
    """``jax.random.split(key, num)`` as a list of ``num`` keys: key i is
    the hash of the count pair ``(0, i)``."""
    k1, k2 = key
    i = torch.arange(num, device=k1.device, dtype=torch.int64)
    y0, y1 = threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(i),
                          i)
    return [(y0[..., j], y1[..., j]) for j in range(num)]


def _shape(shape) -> tuple | None:
    if shape is None:
        return None
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def random_bits(key: tuple, shape=None) -> torch.Tensor:
    """``jax.random.bits`` (uint32, partitionable scheme) of shape () when
    ``shape`` is None, else ``shape`` (an int n means (n,)), for each key
    of the batch: the hash of the flat 64-bit iota split into its (hi, lo)
    words, the two output words xor-ed. Shape ``key batch + shape``,
    int64."""
    k1, k2 = key
    shape = _shape(shape)
    if shape is None:
        lo = torch.zeros_like(k1)
    else:
        pad = (1,) * len(shape)
        k1, k2 = k1.reshape(k1.shape + pad), k2.reshape(k2.shape + pad)
        lo = torch.arange(math.prod(shape), device=k1.device,
                          dtype=torch.int64).reshape(shape)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return y0 ^ y1


# float dtype -> (bits of the draw, mantissa bits, the integer view of 1.0,
# the integer type of that view): as ``jax.random``, a dtype of fewer than
# 8 mantissa bits draws 8 bits
_FLOAT_BITS = {torch.float32: (32, 23, 0x3F800000, torch.int32),
               torch.bfloat16: (8, 7, 0x3F80, torch.int16),
               torch.float16: (16, 10, 0x3C00, torch.int16)}


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0,
                      dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform`` on [minval, maxval) in ``dtype`` (float32,
    bfloat16 or float16) from its 32-bit draw: the draw cut to its low 16
    or 8 bits where jax draws fewer, its top mantissa-many bits as the
    mantissa of a float in [1, 2), minus 1, scaled by ``maxval - minval``
    (rounded to the dtype), shifted, and clamped below at minval."""
    if dtype not in _FLOAT_BITS:
        raise TypeError(f"uniform takes float32, bfloat16 or float16, "
                        f"got {dtype}")
    nbits, nmant, one, itype = _FLOAT_BITS[dtype]
    if nbits < 32:
        bits = bits & ((1 << nbits) - 1)
    f = ((bits >> (nbits - nmant)) | one).to(itype).view(dtype) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return f
    lo = torch.tensor(minval, dtype=dtype)
    scale = (torch.tensor(maxval, dtype=dtype) - lo).item()
    return torch.clamp_min(f * scale + lo.item(), lo.item())


def uniform(key: tuple, shape=None, minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``; one
    draw per key when ``shape`` is None."""
    return uniform_from_bits(random_bits(key, shape), minval, maxval, dtype)


def bernoulli(key: tuple, p: float = 0.5, shape=None) -> torch.Tensor:
    """``jax.random.bernoulli``: a float32 uniform below ``p``."""
    return uniform(key, shape) < float(np.float32(p))


def rademacher(key: tuple, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.rademacher``: ``2 * bernoulli(0.5) - 1``."""
    return (2 * bernoulli(key, 0.5, shape).to(torch.int32) - 1).to(dtype)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on (-1, 1): Giles' polynomial in w, each
    step ``c + p * w`` rounded once (a fused multiply-add, taken exactly in
    float64)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = torch.tensor((_ERFINV_LT5, _ERFINV_GE5), dtype=torch.float32,
                        device=x.device).double()
    pick = torch.where(lt, 0, 1)
    p = coef[pick, 0]
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef[pick, i] + p * w).float().double()
    return p.float() * x


def normal(key: tuple, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)``, u
    uniform on (nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return (_SQRT2 * erf_inv(u)).to(dtype)
