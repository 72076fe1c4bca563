"""4-bit code packing, E8M0 scale bytes and the paged MX KV pool — the
byte layouts of ``repro.kernels.packing``, in PyTorch.

Weights pack along the contraction axis (-2): ``codes_packed (*lead, K//2,
N)`` with code 2i in the low nibble of byte i, plus ``scales_e8m0 (*lead,
K//32, N)``. The KV cache packs along its feature axis (-1): one code per
byte for 8-bit formats, nibble-packed for 4-bit ones, plus one E8M0 byte
per 32-block. A ``PagedKV`` pool is ``(*lead, N, P, D*bits/8)`` codes and
``(*lead, N, P, D//32)`` scales; position t of a request lives at page
``block_table[t // P]``, row ``t % P``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import mx as mxlib

PACKABLE_FMTS = ("mxfp4", "mxint4")
KV_FMTS = ("mxfp8", "mxint8", "mxfp4", "mxint4")


def _check_packable(fmt: str, block_size: int = 32, scale_mode: str = "pow2"):
    if fmt not in PACKABLE_FMTS:
        raise ValueError(
            f"fmt {fmt!r} is not 4-bit packable (supported: {PACKABLE_FMTS})")
    if scale_mode != "pow2":
        raise ValueError(
            f"E8M0 scale bytes require pow2 scales, got {scale_mode!r}")
    if block_size != 32:
        raise ValueError(f"packed layout is fixed at 32-blocks, "
                         f"got block_size={block_size}")


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes in [0, 15] -> packed uint8, two per byte (even index in
    the low nibble). Last axis must be even."""
    *lead, d = codes.shape
    if d % 2 != 0:
        raise ValueError(f"packing axis must be even, got {d}")
    c = codes.reshape(*lead, d // 2, 2).to(torch.uint8)
    return c[..., 0] | (c[..., 1] << 4)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    *lead, h = packed.shape
    return torch.stack([packed & 0xF, (packed >> 4) & 0xF],
                       dim=-1).reshape(*lead, h * 2)


def pack_scales_e8m0(scales: torch.Tensor) -> torch.Tensor:
    """Power-of-two f32 scales -> E8M0 byte (biased exponent, OCP MX)."""
    e = torch.round(torch.log2(scales.float())).to(torch.int32)
    return (e + 127).to(torch.uint8)


def unpack_scales_e8m0(b: torch.Tensor) -> torch.Tensor:
    return torch.ldexp(torch.ones(b.shape, device=b.device),
                       b.to(torch.int32) - 127)


def pack_weight(w: torch.Tensor, fmt: str = "mxfp4") -> dict:
    """(*lead, K, N) float weight -> {codes_packed (*lead, K//2, N) uint8,
    scales_e8m0 (*lead, K//32, N) uint8, fmt, shape}. Exact for weights
    already on the MX grid; quantizes (RTN) otherwise."""
    _check_packable(fmt)
    cfg = mxlib.MXConfig(fmt=fmt, block_size=32)
    wt = w.transpose(-1, -2)
    if wt.shape[-1] % cfg.block_size != 0:
        raise ValueError(f"contraction dim {wt.shape[-1]} not divisible by "
                         f"block size {cfg.block_size}")
    codes_t, scales_t = mxlib.encode(wt, cfg)
    packed_t = pack_codes(codes_t)
    return {"codes_packed": packed_t.transpose(-1, -2).contiguous(),
            "scales_e8m0":
                pack_scales_e8m0(scales_t).transpose(-1, -2).contiguous(),
            "fmt": fmt, "shape": tuple(w.shape)}


def unpack_weight(bundle, dtype=torch.float32) -> torch.Tensor:
    cfg = mxlib.MXConfig(fmt=bundle["fmt"], block_size=32)
    codes_t = unpack_codes(bundle["codes_packed"].transpose(-1, -2))
    scales_t = bundle["scales_e8m0"].transpose(-1, -2)
    out_t = mxlib.decode(codes_t, unpack_scales_e8m0(scales_t), cfg, dtype)
    return out_t.transpose(-1, -2)


def packed_bundle_nbytes(bundle) -> int:
    return (bundle["codes_packed"].numel()
            + bundle["scales_e8m0"].numel())


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """Logical dtype name (as the manifests record it) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


@dataclasses.dataclass
class PackedWeight:
    """An MX-packed linear weight usable in place of a dense tensor.

    Under ``QuantMode(backend='fused')`` ``qlinear`` hands the packed
    bytes straight to the packed-native GEMM kernel; the reference path
    decodes them (:func:`maybe_dense`)."""

    codes_packed: torch.Tensor   # (*lead, K//2, N) uint8
    scales_e8m0: torch.Tensor    # (*lead, K//32, N) uint8
    fmt: str = "mxfp4"
    dtype: str = "float32"

    @property
    def shape(self):
        *lead, k2, n = self.codes_packed.shape
        return tuple(lead) + (k2 * 2, n)

    @property
    def ndim(self) -> int:
        return self.codes_packed.ndim

    def __getitem__(self, i) -> "PackedWeight":
        """Slice the leading (layer) axis."""
        return PackedWeight(self.codes_packed[i], self.scales_e8m0[i],
                            self.fmt, self.dtype)

    def to(self, device) -> "PackedWeight":
        return PackedWeight(self.codes_packed.to(device),
                            self.scales_e8m0.to(device), self.fmt,
                            self.dtype)

    def to_dense(self, dtype=None) -> torch.Tensor:
        return unpack_weight(
            {"codes_packed": self.codes_packed,
             "scales_e8m0": self.scales_e8m0, "fmt": self.fmt},
            torch_dtype(dtype if dtype is not None else self.dtype))

    @classmethod
    def from_dense(cls, w: torch.Tensor, fmt: str = "mxfp4") -> "PackedWeight":
        b = pack_weight(w, fmt)
        return cls(b["codes_packed"], b["scales_e8m0"], fmt,
                   str(w.dtype).replace("torch.", ""))


def maybe_dense(w):
    """Resolve a PackedWeight to its dense tensor; pass others through."""
    if isinstance(w, PackedWeight):
        return w.to_dense()
    return w


# ---------------------------------------------------------------------------
# KV-cache bytes and the paged pool
# ---------------------------------------------------------------------------

def _kv_center(fmt: str) -> int:
    """The uint8 code that decodes to 0.0 (zero-init of a fresh cache)."""
    return len(mxlib.FORMATS[fmt].grid) - 1


def kv_fmt_bits(fmt: str) -> int:
    if fmt not in KV_FMTS:
        raise ValueError(f"fmt {fmt!r} is not a KV-cache format "
                         f"(supported: {KV_FMTS})")
    return mxlib.FORMATS[fmt].bits


def kv_encode(x: torch.Tensor, fmt: str = "mxfp8"):
    """(..., D) float -> (codes uint8 (..., D*bits/8), scales uint8
    (..., D//32) E8M0). D % 32 == 0; pow2 scales per 32-block."""
    bits = kv_fmt_bits(fmt)
    if x.shape[-1] % 32 != 0:
        raise ValueError(f"KV feature dim {x.shape[-1]} not divisible by 32")
    codes, scales = mxlib.encode(x, mxlib.MXConfig(fmt=fmt, block_size=32))
    if bits == 4:
        codes = pack_codes(codes)
    return codes, pack_scales_e8m0(scales)


def kv_decode(codes: torch.Tensor, scales_e8m0: torch.Tensor,
              fmt: str = "mxfp8", dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`kv_encode` -> (..., D) dense values."""
    if kv_fmt_bits(fmt) == 4:
        codes = unpack_codes(codes)
    return mxlib.decode(codes, unpack_scales_e8m0(scales_e8m0),
                        mxlib.MXConfig(fmt=fmt, block_size=32), dtype)


@dataclasses.dataclass
class PagedKV:
    """A paged KV pool: ``codes`` (*lead, N, P, D*bits/8) uint8 and
    ``scales`` (*lead, N, P, D//32) uint8 E8M0 — or dense float pages
    (*lead, N, P, D) with ``scales=None`` when ``fmt == 'none'``.

    The port updates pools in place (``kv_write_*`` scatter into the
    tensors), where the JAX package returns new arrays."""

    codes: torch.Tensor
    scales: Optional[torch.Tensor]
    fmt: str = "none"
    dtype: str = "float32"

    @property
    def page_size(self) -> int:
        return self.codes.shape[-2]

    @property
    def n_pages(self) -> int:
        return self.codes.shape[-3]

    @property
    def feature_dim(self) -> int:
        if self.fmt == "none":
            return self.codes.shape[-1]
        return self.codes.shape[-1] * 8 // kv_fmt_bits(self.fmt)

    @property
    def ndim(self) -> int:
        return self.codes.ndim

    def __getitem__(self, i) -> "PagedKV":
        """Layer slice (a view: writes reach the stacked pool)."""
        return PagedKV(self.codes[i],
                       None if self.scales is None else self.scales[i],
                       self.fmt, self.dtype)

    @classmethod
    def zeros(cls, shape, fmt: str = "none", dtype=torch.float32,
              device="cpu") -> "PagedKV":
        """Fresh pool of logical dense ``shape`` (*lead, N, P, D)."""
        *lead, n, p, d = shape
        dname = str(torch_dtype(dtype)).replace("torch.", "")
        if fmt == "none":
            return cls(torch.zeros((*lead, n, p, d), dtype=torch_dtype(dtype),
                                   device=device), None, "none", dname)
        bits = kv_fmt_bits(fmt)
        if d % 32 != 0:
            raise ValueError(f"KV feature dim {d} not divisible by 32")
        center = _kv_center(fmt)
        cbyte = center | (center << 4) if bits == 4 else center
        codes = torch.full((*lead, n, p, d * bits // 8), cbyte,
                           dtype=torch.uint8, device=device)
        scales = torch.full((*lead, n, p, d // 32), 127, dtype=torch.uint8,
                            device=device)
        return cls(codes, scales, fmt, dname)

    def gather_dense(self, block_tables: torch.Tensor,
                     dtype=None) -> torch.Tensor:
        """Logical contiguous view of ``block_tables`` (B, maxp): a dense
        (B, maxp*P, D) tensor. Pool must be layer-sliced."""
        if self.codes.ndim != 3:
            raise ValueError("gather_dense expects a layer-sliced pool "
                             f"(N, P, ·); got ndim={self.codes.ndim}")
        B, maxp = block_tables.shape
        P = self.page_size
        dt = torch_dtype(dtype if dtype is not None else self.dtype)
        bt = block_tables.long()
        c = self.codes[bt].reshape(B, maxp * P, self.codes.shape[-1])
        if self.fmt == "none":
            return c.to(dt)
        s = self.scales[bt].reshape(B, maxp * P, self.scales.shape[-1])
        return kv_decode(c, s, self.fmt, dt)
