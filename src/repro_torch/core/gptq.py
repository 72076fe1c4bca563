"""Block-wise GPTQ (Frantar et al. 2023) adapted to the MX format
(MR-GPTQ-style), and round-to-nearest — the port of ``repro.core.gptq``.

GPTQ quantizes along the input dimension with per-MX-block scales
recomputed from the *current* (compensated) weights at each block
boundary, compensating each row's error through the Hessian of the
layer's inputs. It runs in float64 on the weights' device, over a whole
stack of layers at once (the row sweep is the same for every layer), with
the JAX package's row order, dead-input rule, damping and grid lookup;
the pow2 block exponent is taken exactly from the float's bits. Hessians
H = Σ xᵀx are accumulated per batch from float32 products into float64,
at every linear's input (the down projection's after the online T3).
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F

from repro_torch import devices
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as dense
from repro_torch.models.layers import rms_norm

from . import mx as mxlib
from . import transforms as tfm
from .latmix import batch_to
from .quantize import QuantMode, qlinear

WEIGHT_KEYS = {"wq", "wk", "wv", "wo", "wg", "wu", "wd", "router",
               "eg", "eu", "ed", "sg", "su", "sd", "in_proj", "out_proj",
               "wx", "wy", "wor"}


# ---------------------------------------------------------------------------
# Core GPTQ
# ---------------------------------------------------------------------------

def _upper_cholesky(m: torch.Tensor) -> torch.Tensor:
    """Upper-triangular U with m = Uᵀ U (the GPTQ propagation factors):
    the transpose of the lower Cholesky factor."""
    return torch.linalg.cholesky(m).transpose(-1, -2)


def _block_scales(amax: torch.Tensor, cfg: mxlib.MXConfig) -> torch.Tensor:
    """The scale of each block from its float64 absolute maximum: a power
    of two (the exact exponent) or, for NVFP4, amax / max (unsnapped, as
    the JAX package's GPTQ takes it)."""
    one = torch.ones_like(amax)
    if cfg.scale_mode == "pow2":
        _, e = torch.frexp(amax)
        s = torch.ldexp(one, e - 1 - cfg.element.r_max)
    else:
        s = amax / cfg.element.max_val
    return torch.where(amax > 0, s, one)


def gptq_matrix(w, hess, cfg: mxlib.MXConfig,
                damp: float = 0.01) -> torch.Tensor:
    """Quantize ``w`` (..., d_in, d_out) along d_in with MX blocks,
    compensating error through the Hessian (..., d_in, d_in) of the layer
    inputs; leading axes are independent matrices. Returns float32 on w's
    device."""
    w = torch.as_tensor(w).double().clone()
    H = torch.as_tensor(hess, device=w.device).double()
    d_in = w.shape[-2]
    B = cfg.block_size
    # dead inputs: unit Hessian diagonal, zero weight row
    dead = torch.diagonal(H, dim1=-2, dim2=-1) == 0
    H = H + torch.diag_embed(dead.double())
    w = w.masked_fill(dead[..., :, None], 0.0)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    H = H + torch.diag_embed(torch.ones_like(diag) * damp
                             * diag.mean(dim=-1, keepdim=True))
    # Hinv = Uᵀ U with U upper-triangular — the propagation factors
    U = _upper_cholesky(tfm.per_matrix(torch.linalg.inv, H))

    q = torch.zeros_like(w)
    grid = torch.tensor(cfg.element.grid, dtype=torch.float64,
                        device=w.device)
    mids = (grid[1:] + grid[:-1]) / 2.0
    for b0 in range(0, d_in, B):
        b1 = min(b0 + B, d_in)
        # MX scales from the *current* compensated weights of this block
        s = _block_scales(w[..., b0:b1, :].abs().amax(dim=-2), cfg)
        err = torch.zeros_like(w[..., b0:b1, :])
        for i in range(b0, b1):
            z = w[..., i, :] / s
            idx = torch.searchsorted(mids, z.abs(), right=True)
            qi = torch.sign(z) * grid[idx] * s
            q[..., i, :] = qi
            e = (w[..., i, :] - qi) / U[..., i, i, None]
            if i + 1 < b1:
                w[..., i + 1:b1, :] -= (U[..., i, i + 1:b1, None]
                                        * e[..., None, :])
            err[..., i - b0, :] = e
        if b1 < d_in:
            w[..., b1:, :] -= U[..., b0:b1, b1:].transpose(-1, -2) @ err
    return q.float()


def rtn_matrix(w, cfg: mxlib.MXConfig) -> torch.Tensor:
    """Round-to-nearest along d_in (no compensation), float32."""
    w = torch.as_tensor(w).float()
    return mxlib.quantize(w.transpose(-1, -2), cfg,
                          ste=False).transpose(-1, -2)


# ---------------------------------------------------------------------------
# Hessian capture for the dense-transformer family
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HessianStats:
    """Per-layer input Hessians keyed by role (float64 tensors)."""
    h_attn_in: torch.Tensor     # (L, d, d)  — input of wq/wk/wv
    h_attn_out: torch.Tensor    # (L, qd, qd) — not captured (wo takes RTN)
    h_ffn_in: torch.Tensor      # (L, d, d)
    h_ffn_down: torch.Tensor    # (L, f, f)  — includes the online T3


def _xtx(t: torch.Tensor) -> torch.Tensor:
    a = t.float().reshape(-1, t.shape[-1])
    return (a.T @ a).double()


def capture_hessians(params, cfg: ArchConfig, batches: List[dict],
                     qm: QuantMode) -> HessianStats:
    """Layer by layer forward capturing Σ xᵀx at each linear input. The
    residual stream runs the quantized path (act quant on), as the
    deployed GEMMs see it; the captured inputs are those before the
    activation quantizer."""
    L, d, f, qd = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.q_dim
    dev = devices.of(params)
    z = lambda n: torch.zeros((L, n, n), dtype=torch.float64,  # noqa: E731
                              device=dev)
    hs = HessianStats(h_attn_in=z(d), h_attn_out=z(qd), h_ffn_in=z(d),
                      h_ffn_down=z(f))
    with torch.no_grad():
        for b in batches:
            x = dense.embed_inputs(params, cfg, batch_to(b, dev)["inputs"])
            pos = torch.arange(x.shape[1], device=dev)
            for l in range(L):
                pl = dense._layer(params["blocks"], l)
                h1 = rms_norm(x, pl["ln1"], cfg.norm_eps)
                x2, _, _ = dense.attn_sublayer(x, pl, cfg, qm, pos,
                                               window=cfg.window)
                h2 = rms_norm(x2, pl["ln2"], cfg.norm_eps)
                x3 = dense.ffn_sublayer(x2, pl, cfg, qm)
                g = qlinear(h2, pl["wg"], pl.get("bg"), qm, "ffn_in")
                u = qlinear(h2, pl["wu"], pl.get("bu"), qm, "ffn_in")
                hmid = F.silu(g.float()).to(x.dtype) * u
                if qm.t3_block:
                    hmid = tfm.apply_blockwise(hmid, tfm.hadamard_matrix(
                        qm.t3_block, hmid.dtype, dev))
                hs.h_attn_in[l] += _xtx(h1)
                hs.h_ffn_in[l] += _xtx(h2)
                hs.h_ffn_down[l] += _xtx(hmid)
                x = x3
    return hs


_GPTQ_ROLES = (("wq", "h_attn_in"), ("wk", "h_attn_in"), ("wv", "h_attn_in"),
               ("wg", "h_ffn_in"), ("wu", "h_ffn_in"), ("wd", "h_ffn_down"))


def quantize_weights_gptq(params, cfg: ArchConfig, stats: HessianStats,
                          mxcfg: mxlib.MXConfig, t3_block: int = 32):
    """GPTQ the dense-family weights with the captured Hessians, every
    layer of a role in one sweep; ``wo`` (no Hessian captured) takes RTN,
    embeddings and head stay as they are."""
    del cfg, t3_block
    p = dict(params)
    b = dict(p["blocks"])
    for name, key in _GPTQ_ROLES:
        b[name] = gptq_matrix(b[name].detach(), getattr(stats, key),
                              mxcfg).to(b[name].dtype)
    b["wo"] = rtn_matrix(b["wo"].detach(), mxcfg).to(b["wo"].dtype)
    p["blocks"] = b
    return p


# ---------------------------------------------------------------------------
# RTN for any family (generic tree traversal)
# ---------------------------------------------------------------------------

def quantize_weights_rtn(params, cfg: ArchConfig, mxcfg: mxlib.MXConfig):
    """Fake-quantize every linear weight (a leaf named in WEIGHT_KEYS with
    ndim >= 2) along its input axis (-2). Returns a new nested dict."""
    del cfg

    def visit(name, leaf):
        if isinstance(leaf, dict):
            return {k: visit(k, v) for k, v in leaf.items()}
        if name in WEIGHT_KEYS and leaf.ndim >= 2:
            wq = mxlib.quantize(leaf.transpose(-1, -2), mxcfg, ste=False)
            return wq.transpose(-1, -2).to(leaf.dtype).contiguous()
        return leaf

    return visit("", params)
