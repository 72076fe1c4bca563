"""Mamba2 — State Space Duality (SSD) in chunked matmul form; the port of
``repro.models.ssd``.

Block layout (the reference Mamba2 block):
  in_proj: d -> [z (d_inner), xBC (d_inner + 2·G·N), dt (H)]
  depthwise causal conv over xBC, SiLU
  SSD recurrence  h_t = exp(dt·A) h_{t-1} + dt·B_t ⊗ x_t ;  y_t = C_t·h_t + D·x_t
  gated RMSNorm(y · silu(z)), out_proj: d_inner -> d

:func:`ssd_chunked` runs chunk-local matmuls and a loop over the chunks
with an f32 carry (the JAX package's ``lax.scan``). The chunk is the
largest power-of-two divisor of the length up to ``cfg.ssm_chunk`` (``while
l % q: q //= 2``), and the outputs depend on it: an odd length runs one
chunk per token, so the engine's traffic takes bucketed lengths.

Parameters are the JAX package's tree (``blocks/*`` stacked over the
layers); the cache is ``{"ssm": (L, B, H, P, N) f32, "conv": (L, B,
conv_dim, K-1)}``, O(1) in the sequence length and updated in place by
decode. LATMiX folds T1 only: there is no value path for T2.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch import devices
from repro_torch.configs.base import ArchConfig
from repro_torch.core import folding as fold_lib
from repro_torch.core.quantize import QuantMode
from repro_torch.launch import pcontext as pctx

from .layers import (causal_conv1d, conv1d_step, dense_init, embed_lookup,
                     qlinear, rms_norm, rms_norm_gated, softplus)
from .transformer import _layer, head_matrix, head_out


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None, place=lambda name, t: t):
    """Seeded random parameters at ``cfg``'s widths (the JAX package's
    layout and scales; ``torch.Generator`` draws, so the values differ);
    ``place`` as :func:`repro_torch.models.api.init` takes it."""
    device = gen.device if device is None else device
    L, d = cfg.n_layers, cfg.d_model
    di, H = cfg.d_inner, cfg.ssm_nheads
    G, N, K = cfg.ssm_ngroups, cfg.ssm_state, cfg.conv_kernel
    proj_out = 2 * di + 2 * G * N + H

    def stack(name, din, dout, scale=1.0):
        return place(name, torch.stack([
            dense_init(gen, din, dout, dtype, scale, device)
            for _ in range(L)]))

    dt0 = torch.linspace(1e-3, 1e-1, H, device=device)
    blocks = {
        "ln": torch.ones((L, d), dtype=dtype, device=device),
        "in_proj": stack("in_proj", d, proj_out),
        "conv_w": place("conv_w", (torch.randn(
            (L, cfg.conv_dim, K), generator=gen, device=device) * 0.1
        ).to(dtype)),
        "conv_b": torch.zeros((L, cfg.conv_dim), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)
                           ).repeat(L, 1),
        "D": torch.ones((L, H), device=device),
        "dt_bias": torch.log(dt0 / (1 - dt0)).repeat(L, 1),
        "norm": torch.ones((L, di), dtype=dtype, device=device),
        "out_proj": stack("out_proj", di, d, 1.0 / math.sqrt(2.0 * L)),
    }
    params = {
        "blocks": blocks,
        "ln_f": torch.ones((d,), dtype=dtype, device=device),
        "embed": place("embed", (torch.randn(
            (cfg.vocab_size, d), generator=gen, device=device) * 0.02
        ).to(dtype)),
    }
    if not cfg.tie_embeddings:
        params["head"] = place("head", dense_init(
            gen, d, cfg.vocab_size, dtype, device=device))
    return params


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): out[i, j] = sum_{k=j+1..i} x[k], -inf above
    the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, torch.full_like(d, -math.inf))


def chunk_len(length: int, chunk: int) -> int:
    """The chunk :func:`ssd_chunked` takes for ``length`` tokens: the
    largest power-of-two divisor of ``length`` within ``chunk``'s halvings
    (one token per chunk for an odd length)."""
    q = min(chunk, length)
    while length % q != 0:
        q //= 2
    return q


def ssd_chunked(x, dA, B, C, chunk: int, init_state=None):
    """SSD in chunked matmul form.

    x (b, l, h, p) inputs already scaled by dt; dA (b, l, h) log-decay per
    step (dt * A, A < 0); B, C (b, l, h, n) the input and output
    projections (groups broadcast to heads). Returns (y (b, l, h, p) in x's
    dtype, final state (b, h, p, n) f32). Mixed-dtype products run in f32,
    as the JAX package's promotion does."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    q = chunk_len(l, chunk)
    nc = l // q
    xr = x.reshape(b, nc, q, h, p).float()
    Br = B.reshape(b, nc, q, h, n).float()
    Cr = C.reshape(b, nc, q, h, n).float()
    Ar = dA.reshape(b, nc, q, h).float().transpose(-1, -2)   # (b, nc, h, q)
    A_cum = torch.cumsum(Ar, dim=-1)

    # 1) intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(Ar))                            # (b,nc,h,q,q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", Cr, Br) * Lmat
    Ydiag = torch.einsum("bchqs,bcshp->bcqhp", scores, xr)

    # 2) per-chunk end states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)        # (b, nc, h, q)
    states = torch.einsum("bcqhn,bchq,bcqhp->bchpn", Br, decay_states, xr)

    # 3) inter-chunk recurrence, f32 carry; the state entering each chunk
    chunk_decay = torch.exp(A_cum[..., -1])                  # (b, nc, h)
    s = (torch.zeros((b, h, p, n), device=x.device) if init_state is None
         else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,h,p,n)

    # 4) inter-chunk (off-diagonal) contribution
    Yoff = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Cr, prev_states,
                        torch.exp(A_cum))
    return (Ydiag + Yoff).reshape(b, l, h, p).to(x.dtype), s


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

def _split_proj(zxbcdt, cfg: ArchConfig):
    di = cfg.d_inner
    return (zxbcdt[..., :di], zxbcdt[..., di:di + cfg.conv_dim],
            zxbcdt[..., di + cfg.conv_dim:])


def _ssm_inputs(xBC, dt_raw, p, cfg: ArchConfig):
    di, G, N, H = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    lead = xBC.shape[:-1]
    xh = xBC[..., :di].reshape(*lead, H, cfg.ssm_headdim)
    rep = H // G
    Bh = xBC[..., di:di + G * N].reshape(*lead, G, N).repeat_interleave(
        rep, dim=-2)
    Ch = xBC[..., di + G * N:].reshape(*lead, G, N).repeat_interleave(
        rep, dim=-2)
    dt = softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())                       # (H,) negative
    return xh, Bh, Ch, dt, a


def block(x, p, cfg: ArchConfig, qm: QuantMode, init_state=None):
    """x (B, L, d). Returns (x', (final ssm state (B, H, P, N) f32, conv
    tail (B, conv_dim, K-1)))."""
    Lq = x.shape[1]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = qlinear(h, p["in_proj"], p.get("b_in"), qm, "ssm_in")

    def mix(zxbcdt, conv_w, conv_b, dt_bias, A_log, D, norm):
        # the conv, the SSD scan and the gated norm of each lane (under a
        # mesh: each rank's lanes, the projection's channels whole)
        Bb = zxbcdt.shape[0]
        z, xBC, dt_raw = _split_proj(zxbcdt, cfg)
        conv_tail = xBC[:, -(cfg.conv_kernel - 1):, :]       # pre-conv
        xBC = causal_conv1d(xBC, conv_w, conv_b)
        xBC = F.silu(xBC.float()).to(x.dtype)
        xh, Bh, Ch, dt, a = _ssm_inputs(xBC, dt_raw, {"dt_bias": dt_bias,
                                                      "A_log": A_log}, cfg)
        dA = dt * a[None, None, :]                           # (B, L, H)
        xin = (xh.float() * dt[..., None]).to(x.dtype)
        y, s_final = ssd_chunked(xin, dA, Bh.to(x.dtype), Ch.to(x.dtype),
                                 cfg.ssm_chunk, init_state)
        y = y + xh * D.to(x.dtype)[None, None, :, None]
        y = rms_norm_gated(y.reshape(Bb, Lq, cfg.d_inner), z, norm,
                           cfg.norm_eps)
        return y, s_final, conv_tail.transpose(1, 2)
    lane = ("batch", None, None)
    y, s_final, conv_tail = pctx.local(
        mix, (zxbcdt, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"],
              p["D"], p["norm"]),
        (lane, (None, None), (None,), (None,), (None,), (None,), (None,)),
        out_like=(0, 0, 0))
    out = qlinear(y, p["out_proj"], p.get("b_out"), qm, "ssm_out")
    return x + out.to(x.dtype), (s_final, conv_tail)


def block_decode(x, p, cfg: ArchConfig, qm: QuantMode, ssm_state,
                 conv_state):
    """One token. x (B, 1, d); ssm_state (B, H, P, N) f32; conv_state (B,
    conv_dim, K-1). Returns (x', ssm_state', conv_state')."""
    Bb = x.shape[0]
    h = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)
    zxbcdt = qlinear(h, p["in_proj"], p.get("b_in"), qm, "ssm_in")
    z, xBC_t, dt_raw = _split_proj(zxbcdt, cfg)
    xBC_t, conv_state = conv1d_step(conv_state, xBC_t, p["conv_w"],
                                    p["conv_b"])
    xBC_t = F.silu(xBC_t.float()).to(x.dtype)
    xh, Bh, Ch, dt, a = _ssm_inputs(xBC_t, dt_raw, p, cfg)
    dA = torch.exp(dt * a[None, :])                          # (B, H)
    upd = torch.einsum("bhn,bhp->bhpn", Bh.float(),
                       xh.float() * dt[..., None])
    ssm_state = ssm_state * dA[..., None, None] + upd.to(ssm_state.dtype)
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(),
                     ssm_state.float()).to(x.dtype)
    y = y + xh * p["D"].to(x.dtype)[None, :, None]
    y = rms_norm_gated(y.reshape(Bb, cfg.d_inner), z, p["norm"],
                       cfg.norm_eps)
    out = qlinear(y, p["out_proj"], p.get("b_out"), qm, "ssm_out")
    return x + out[:, None, :], ssm_state, conv_state


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------

def forward(params, cfg: ArchConfig, inputs,
            qm: QuantMode = QuantMode.off()):
    """inputs (B, S) tokens -> logits (B, S, V); each block recomputed in
    the backward under autograd with ``cfg.remat``."""
    x = pctx.shard(embed_lookup(params["embed"], inputs), "batch", None, None)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(x, pl):
        # a sequence-parallel residual is gathered at the block's entry
        x = pctx.shard(x, "batch", None, None)
        return pctx.shard(block(x, pl, cfg, qm)[0], "batch", "seq", None)

    for i in range(cfg.n_layers):
        pl = _layer(params["blocks"], i)
        x = (_ckpt.checkpoint(run, x, pl, use_reentrant=False) if remat
             else run(x, pl))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return head_out(x, params, cfg, qm)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, kv_quant=None, device=None):
    """Zero state: ``ssm`` (L, B, H, P, N) f32 and ``conv`` (L, B,
    conv_dim, K-1). There is no attention cache to quantize (``api``
    refuses ``kv_quant``). ``device`` None means the CUDA card."""
    del max_len, kv_quant
    dev = devices.resolve(device)
    L, H, P, N = (cfg.n_layers, cfg.ssm_nheads, cfg.ssm_headdim,
                  cfg.ssm_state)
    return {"ssm": torch.zeros((L, batch, H, P, N), device=dev),
            "conv": torch.zeros((L, batch, cfg.conv_dim, cfg.conv_kernel - 1),
                                dtype=dtype, device=dev)}


def prefill(params, cfg: ArchConfig, inputs, qm: QuantMode = QuantMode.off(),
            max_len: int | None = None, kv_quant=None):
    """Run the prompt (B, S); returns (last logits (B, V), cache). The
    state is O(1) in the length, so ``max_len`` sizes nothing."""
    del max_len, kv_quant
    x = pctx.shard(embed_lookup(params["embed"], inputs), "batch", None, None)
    ss, cs = [], []
    for i in range(cfg.n_layers):
        x, (s, c) = block(x, _layer(params["blocks"], i), cfg, qm)
        x = pctx.shard(x, "batch", "seq", None)
        ss.append(s)
        cs.append(c)
    x = rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return (head_out(x[:, 0], params, cfg, qm),
            {"ssm": torch.stack(ss).float(), "conv": torch.stack(cs)})


def decode(params, cfg: ArchConfig, cache, inputs, cur_len,
           qm: QuantMode = QuantMode.off()):
    """One decode step (the state is position-free: ``cur_len`` is
    unused). inputs (B,) tokens. Returns (logits (B, V), cache), the cache
    updated in place."""
    del cur_len
    x = pctx.shard(embed_lookup(params["embed"], inputs[:, None]).to(
        cache["conv"].dtype), "batch", None, None)
    for i in range(cfg.n_layers):
        x, s, c = block_decode(x, _layer(params["blocks"], i), cfg, qm,
                               cache["ssm"][i], cache["conv"][i])
        cache["ssm"][i], cache["conv"][i] = s, c
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return head_out(x[:, 0], params, cfg, qm), cache


# ---------------------------------------------------------------------------
# PTQ integration — T1 only (no value path)
# ---------------------------------------------------------------------------

def fold_norms(params, cfg: ArchConfig):
    p = dict(params)
    b = dict(p["blocks"])
    b["ln"], (b["in_proj"],) = fold_lib.fold_norm_into(b["ln"], b["in_proj"])
    b["norm"], (b["out_proj"],) = fold_lib.fold_norm_into(b["norm"],
                                                          b["out_proj"])
    p["ln_f"], (p["head"],) = fold_lib.fold_norm_into(
        p["ln_f"], head_matrix(params, cfg))
    p["blocks"] = b
    return p


def fold(params, cfg: ArchConfig, tset: fold_lib.TransformSet):
    """T1 into in_proj (read), out_proj (write), the embedding and the
    head; differentiable; requires :func:`fold_norms` first."""
    p = dict(params)
    b = dict(p["blocks"])
    a1i = tset.a1_inv
    b["in_proj"], b["b_in"] = fold_lib.fold_read(b["in_proj"], None, a1i,
                                                 tset.v1)
    b["out_proj"], b["b_out"] = fold_lib.fold_write(
        b["out_proj"], torch.zeros_like(b["out_proj"][..., 0, :]), tset.a1)
    p["embed"] = fold_lib.fold_embed(p["embed"], tset.a1, tset.v1)
    p["head"], p["bhead"] = fold_lib.fold_read(head_matrix(params, cfg),
                                               None, a1i, tset.v1)
    p["blocks"] = b
    return p
