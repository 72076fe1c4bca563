"""Quantized execution mode: MX linears and expert-batched einsums with a
kernel-dispatch backend (the serving part of ``repro.core.quantize``).

``backend="ref"``: plain fake-quant path — a ``PackedWeight`` is decoded
in place and the GEMM runs dense. ``backend="fused"``: when the weight is
a ``PackedWeight`` whose layout matches the activation config and the
call site quantizes, the matmul runs through ``ops.mx_gemm_packed`` (the
packed-native GEMM kernel on the card, its plain version on the CPU);
``role='ffn_down'`` with ``t3_block=32`` folds the online T3
block-Hadamard into the kernel's activation-quantize prologue;
``qeinsum`` runs an expert-stacked ``PackedWeight`` (E, K, N) through the
same kernel with the expert axis as a grid axis (one launch). Anything off
the kernel contract takes the reference path. Each decision is counted in
``ops.quant_paths``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.packing import (KV_FMTS, PackedWeight, maybe_dense,
                                        torch_dtype)

from . import mx as mxlib
from . import transforms as tfm

BACKENDS = ("ref", "fused")
MXBLOCK = 32


@dataclasses.dataclass(frozen=True)
class KVCacheQuant:
    """How the serving KV cache is stored: MX element format of the stored
    keys/values ('mxfp8' / 'mxint8' one code byte per element, 'mxfp4' /
    'mxint4' nibble-packed), with E8M0 scales per 32-block."""

    fmt: str = "mxfp8"

    def __post_init__(self):
        if self.fmt not in KV_FMTS:
            raise ValueError(f"unknown KV-cache fmt {self.fmt!r} "
                             f"(expected one of {KV_FMTS} or 'none')")

    @staticmethod
    def parse(spec) -> "Optional[KVCacheQuant]":
        if spec is None or isinstance(spec, KVCacheQuant):
            return spec
        if spec in ("", "none", "off", "bf16", "fp"):
            return None
        return KVCacheQuant(fmt=spec)


@dataclasses.dataclass(frozen=True)
class QuantMode:
    """How to execute linears (fields as in the JAX package, so artifact
    manifests round-trip). ``t3_block`` > 0 applies the online
    block-Hadamard before ``ffn_down``; ``quantize_head`` keeps the LM head
    in f32 when False; ``backend`` is 'ref' | 'fused'."""

    enabled: bool = False
    act_cfg: Optional[mxlib.MXConfig] = None
    weight_cfg: Optional[mxlib.MXConfig] = None
    t3_block: int = 0
    quantize_head: bool = False
    backend: str = "ref"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(expected one of {BACKENDS})")

    def with_backend(self, backend: str) -> "QuantMode":
        return dataclasses.replace(self, backend=backend)

    @staticmethod
    def off(t3: int = 0) -> "QuantMode":
        return QuantMode(enabled=False, t3_block=t3)

    @staticmethod
    def mxfp4(weights: bool = True, t3: bool = True,
              backend: str = "ref") -> "QuantMode":
        c = mxlib.MXConfig(fmt="mxfp4", block_size=32)
        return QuantMode(enabled=True, act_cfg=c,
                         weight_cfg=c if weights else None,
                         t3_block=32 if t3 else 0, backend=backend)


def _maybe_quant_act(x, qm: QuantMode):
    if qm.enabled and qm.act_cfg is not None:
        return mxlib.quantize(x, qm.act_cfg)
    return x


def _maybe_quant_weight(w, qm: QuantMode):
    """Weights are MX-blocked along the contraction (first) axis."""
    if qm.enabled and qm.weight_cfg is not None:
        return mxlib.quantize(w.transpose(-1, -2),
                              qm.weight_cfg).transpose(-1, -2)
    return w


def _cfg_matches_packed(cfg: Optional[mxlib.MXConfig], fmt: str) -> bool:
    return (cfg is not None and cfg.fmt == fmt
            and cfg.block_size == MXBLOCK and cfg.scale_mode == "pow2")


def _packed_on_grid(w, qm: QuantMode) -> bool:
    """A PackedWeight already sits on the MX grid of a matching
    weight_cfg, so re-quantizing it is the identity and is skipped."""
    return (isinstance(w, PackedWeight)
            and _cfg_matches_packed(qm.weight_cfg, w.fmt))


def _fused_t3(qm: QuantMode, role: str) -> bool:
    return bool(qm.t3_block) and role == "ffn_down"


def _mode_fusable(w, qm: QuantMode, role: str) -> bool:
    """Does (mode, weight, role) meet the packed-kernel contract?"""
    if qm.backend != "fused" or not qm.enabled or qm.act_cfg is None:
        return False
    if not isinstance(w, PackedWeight):
        return False
    if role == "head" and not qm.quantize_head:
        return False
    a = qm.act_cfg
    if not _cfg_matches_packed(a, w.fmt) or a.stochastic:
        return False
    if qm.weight_cfg is not None and not _cfg_matches_packed(
            qm.weight_cfg, w.fmt):
        return False
    if _fused_t3(qm, role) and qm.t3_block != MXBLOCK:
        return False
    return w.shape[-2] % MXBLOCK == 0


def _out_dtype(x: torch.Tensor, w: PackedWeight) -> torch.dtype:
    return torch.promote_types(x.dtype, torch_dtype(w.dtype))


def _fused_linear(x, w: PackedWeight, b, qm: QuantMode, role: str):
    """Flatten (..., K) -> (M, K) and run the packed-native kernel; a
    stacked weight (*lead, K, N) takes x (*lead, M, K)."""
    k, n = w.shape[-2], w.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k) if w.ndim == 2 else x
    y = ops.mx_gemm_packed(x2, w.codes_packed, w.scales_e8m0, w.fmt,
                           t3=_fused_t3(qm, role))
    y = y.reshape(*lead, n).to(_out_dtype(x, w))
    return y if b is None else y + b


def _fusable_shapes(x, w: PackedWeight) -> bool:
    if x.shape[-1] != w.shape[-2]:
        return False
    if w.ndim == 2:
        return True
    return x.ndim == w.ndim and tuple(x.shape[:-2]) == tuple(w.shape[:-2])


def qlinear(x: torch.Tensor, w, b: Optional[torch.Tensor], qm: QuantMode,
            role: str = "") -> torch.Tensor:
    """y = Q(x) @ Q(w) + b under the quant mode; plain x @ w + b otherwise.

    x (..., K); w (K, N) tensor or PackedWeight (or stacked (*lead, K, N)
    with x (*lead, M, K)); b (N,) or None. ``role='ffn_down'`` applies the
    online T3 block-Hadamard to the activation before quantization."""
    if fused_route(x, w, qm, role):
        ops.record_quant_path("qlinear", "fused", role)
        return _fused_linear(x, w, b, qm, role)
    ops.record_quant_path("qlinear", "ref", role)
    y = quant_act(x, qm, role) @ quant_weight(w, qm, role)
    return y if b is None else y + b


def fused_route(x, w, qm: QuantMode, role: str = "") -> bool:
    """Does :func:`qlinear` of these operands run the packed kernel?"""
    return _mode_fusable(w, qm, role) and _fusable_shapes(x, w)


def quant_act(x: torch.Tensor, qm: QuantMode, role: str = ""):
    """The activation the reference path multiplies: the online T3 for
    ``ffn_down``, then MX fake quantization along the last axis (the head
    stays exact unless ``quantize_head``)."""
    if _fused_t3(qm, role):
        x = tfm.apply_blockwise(
            x, tfm.hadamard_matrix(qm.t3_block, x.dtype, x.device))
    if role == "head" and not qm.quantize_head:
        return x
    return _maybe_quant_act(x, qm)


def quant_weight(w, qm: QuantMode, role: str = "") -> torch.Tensor:
    """The dense weight the reference path multiplies: MX fake-quantized
    along its contraction axis, unless it already sits on the grid (or is
    the exact head)."""
    if _packed_on_grid(w, qm) or (role == "head" and not qm.quantize_head):
        return maybe_dense(w)
    return _maybe_quant_weight(maybe_dense(w), qm)


def _parse_expert_spec(spec: str):
    """Recognize expert-batched einsums of the shape ``(..., E, ..., K),
    (E, K, N) -> (..., E, ..., N)`` — the MoE dispatch and combine specs
    'gecd,edf->gecf' and 'gecf,efd->gecd'.

    Returns (expert-axis position in the activation, activation rank the
    spec demands), or None if the spec does not match the packed-kernel
    contract. Callers also check the actual x rank, so the fused path
    rejects exactly what the reference einsum rejects."""
    try:
        ins, out = spec.replace(" ", "").split("->")
        in1, in2 = ins.split(",")
    except ValueError:
        return None
    if len(in2) != 3 or len(set(in1)) != len(in1):
        return None
    e, k, n = in2
    if in1[-1] != k or e not in in1[:-1] or n in in1:
        return None
    if out != in1[:-1] + n:
        return None
    return in1.index(e), len(in1)


def qeinsum(spec: str, x: torch.Tensor, w, qm: QuantMode,
            role: str = "") -> torch.Tensor:
    """Quantized einsum for expert-batched weights, e.g. 'gecd,edf->gecf'.

    The activation is quantized along its last axis, the weight along the
    contraction axis (its second-to-last). ``w`` may be a stacked
    ``PackedWeight`` (E, K, N): under ``backend='fused'`` the activation's
    expert axis moves to the front, the other axes fold into the rows, and
    ``ops.mx_gemm_packed`` runs the E products in one launch."""
    if _mode_fusable(w, qm, role) and w.ndim == 3:
        parsed = _parse_expert_spec(spec)
        if (parsed is not None and x.ndim == parsed[1]
                and x.shape[parsed[0]] == w.shape[0]
                and x.shape[-1] == w.shape[-2]):
            ops.record_quant_path("qeinsum", "fused", role)
            e_pos = parsed[0]
            xe = torch.movedim(x, e_pos, 0)           # (E, *rest, K)
            rest = tuple(xe.shape[1:-1])
            y = ops.mx_gemm_packed(
                xe.reshape(w.shape[0], math.prod(rest), w.shape[-2]),
                w.codes_packed, w.scales_e8m0, w.fmt,
                t3=_fused_t3(qm, role))
            y = y.reshape(w.shape[0], *rest, w.shape[-1])
            return torch.movedim(y, 0, e_pos).to(_out_dtype(x, w))
    ops.record_quant_path("qeinsum", "ref", role)
    return torch.einsum(spec, quant_act(x, qm, role),
                        quant_weight(w, qm, role))
