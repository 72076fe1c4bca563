"""Transformation folding (Appendix C), row convention ``y = x @ W + b`` —
the port of ``repro.core.folding``.

A ``TransformSet`` carries the learned transformations:

  A1 (d, d), v1 (d,)          — global residual-stream transform T1
  A2 (L, Dh, Dh), v2 (L, Dh)  — per-layer per-head value transform T2
  t3_block                    — online block-Hadamard size (inverse folded
                                into the down projection here)

Role helpers (each exact and differentiable — the LATMiX student *is* the
folded network, so gradients flow through these into Ω):

  read:      W ← A1⁻¹ W,  b ← b − v1 @ (A1⁻¹ W)        (Eq. 30)
  write:     W ← W A1,    b ← b @ A1                     (Eq. 31)
  embed:     W_e ← W_e A1 + v1                           (Eq. 32)
  value:     per-head  W_V ← (A1⁻¹ W_V) A2 (+v2)         (Eq. 33)
  attn_out:  per-head  W_O ← A2⁻¹ W_O, then · A1; bias −v2 correction
                                                         (Eq. 34)
  t3:        W_down ← blockdiag(H)ᵀ W_down (runtime applies H online)

Every helper takes weights with leading (layer) axes; matmuls broadcast
over them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import transforms as tfm


@dataclasses.dataclass
class TransformSet:
    a1: torch.Tensor                     # (d, d)
    v1: torch.Tensor                     # (d,)
    a2: Optional[torch.Tensor] = None    # (L, Dh, Dh)
    v2: Optional[torch.Tensor] = None    # (L, Dh)
    t3_block: int = 32

    @property
    def a1_inv(self) -> torch.Tensor:
        return tfm.inverse(self.a1)

    def a2_inv(self) -> torch.Tensor:
        return tfm.inverse(self.a2)


def identity_set(d: int, n_layers: int, head_dim: int, t3_block: int = 32,
                 device="cpu") -> TransformSet:
    return TransformSet(
        a1=torch.eye(d, device=device), v1=torch.zeros(d, device=device),
        a2=torch.eye(head_dim, device=device)[None].repeat(n_layers, 1, 1),
        v2=torch.zeros((n_layers, head_dim), device=device),
        t3_block=t3_block)


# ---------------------------------------------------------------------------
# Norm folding (exact)
# ---------------------------------------------------------------------------

def fold_norm_into(gamma: torch.Tensor, *ws: torch.Tensor):
    """Return (ones_like(gamma), [diag(γ) @ W ...]) — the exact rewrite of
    ``rmsnorm(x)*γ @ W``. Takes stacked (L, d, out) weights with stacked
    (L, d) gammas."""
    new_ws = []
    for w in ws:
        if w.ndim != gamma.ndim + 1:
            raise ValueError(f"shape mismatch {tuple(gamma.shape)} vs "
                             f"{tuple(w.shape)}")
        new_ws.append(w * gamma[..., :, None].to(w.dtype))
    return torch.ones_like(gamma), new_ws


# ---------------------------------------------------------------------------
# Role folds
# ---------------------------------------------------------------------------

def fold_read(w: torch.Tensor, b: Optional[torch.Tensor],
              a1_inv: torch.Tensor, v1: torch.Tensor):
    """W (…, d, out) ← A1⁻¹ W;  b ← b − v1 @ (A1⁻¹ W)."""
    wt = a1_inv.to(w.dtype) @ w
    corr = torch.einsum("d,...do->...o", v1.to(wt.dtype), wt)
    return wt, (-corr if b is None else b - corr)


def fold_write(w: torch.Tensor, b: Optional[torch.Tensor], a1: torch.Tensor):
    """W (…, in, d) ← W A1;  b ← b @ A1."""
    wt = w @ a1.to(w.dtype)
    return wt, (None if b is None else b @ a1.to(b.dtype))


def fold_embed(w_e: torch.Tensor, a1: torch.Tensor, v1: torch.Tensor):
    """(V, d) table ← W_e A1 + v1 per row."""
    return w_e @ a1.to(w_e.dtype) + v1.to(w_e.dtype)[None, :]


def fold_value(w_v: torch.Tensor, b_v: Optional[torch.Tensor],
               a1_inv: torch.Tensor, v1: torch.Tensor, a2: torch.Tensor,
               v2: torch.Tensor, n_kv: int):
    """Value projection: stream-read fold then per-head T2.
    w_v (…, d, n_kv*Dh); the bias gains +v2 per head."""
    wt, bt = fold_read(w_v, b_v, a1_inv, v1)
    *lead, d, kd = wt.shape
    dh = kd // n_kv
    wh = torch.einsum("...dkh,...hj->...dkj", wt.reshape(*lead, d, n_kv, dh),
                      a2.to(wt.dtype))
    bh = torch.einsum("...kh,...hj->...kj", bt.reshape(*lead, n_kv, dh),
                      a2.to(bt.dtype))
    bh = bh + v2[..., None, :].to(bh.dtype)
    return wh.reshape(*lead, d, kd), bh.reshape(*lead, kd)


def fold_attn_out(w_o: torch.Tensor, b_o: Optional[torch.Tensor],
                  a1: torch.Tensor, a2_inv: torch.Tensor, v2: torch.Tensor,
                  n_heads: int):
    """Output projection: per-head T2⁻¹, then the stream-write fold
    (Eq. 34). w_o (…, n_heads*Dh, d)."""
    *lead, hd, d = w_o.shape
    dh = hd // n_heads
    wh = torch.einsum("...ij,...kjd->...kid", a2_inv.to(w_o.dtype),
                      w_o.reshape(*lead, n_heads, dh, d))
    # each head's value stream carries +v2 (softmax rows sum to one,
    # Appendix B), removed here: − Σ_h v2 @ (A2⁻¹ W_O[h])
    corr = torch.einsum("...j,...kjd->...d", v2.to(wh.dtype), wh)
    b0 = -corr if b_o is None else b_o - corr
    return fold_write(wh.reshape(*lead, hd, d), b0, a1)


def fold_t3(w_down: torch.Tensor, block: int):
    """W_down (…, f, d) ← blockdiag(H_b)ᵀ W_down: the runtime's
    (x·blockdiag(H)) @ W̃ equals x @ W, H being orthogonal."""
    h = tfm.hadamard_matrix(block, w_down.dtype, w_down.device)
    *lead, f, d = w_down.shape
    wb = torch.einsum("jb,...kjd->...kbd", h,
                      w_down.reshape(*lead, f // block, block, d))
    return wb.reshape(*lead, f, d)
