"""Shared layers of the dense transformer: RMSNorm, RoPE, GQA attention
(online softmax over KV chunks), the KV-cache writes of both layouts and
the gated MLP — the serving part of ``repro.models.layers``.

A contiguous cache leaf is a dense (B, S, kv_dim) tensor or a ``PackedKV``
(MX codes + E8M0 bytes, quantized at append time). Paged-cache writes go
through the block-table indirection: logical position t of lane b lives at
pool page ``block_tables[b, t // P]``, row ``t % P``. Every write updates
the (layer-sliced) cache in place, where the JAX package returns new
arrays (the engine guarantees writable pages are private to their
lane)."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.quantize import QuantMode, qlinear
from repro_torch.kernels import ops
from repro_torch.kernels.packing import PackedKV, PagedKV, kv_encode
from repro_torch.kernels.ref import sm_scale

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Contiguous-cache writes
# ---------------------------------------------------------------------------

def kv_write_rows(cache, new: torch.Tensor, rows: torch.Tensor):
    """Scatter one token per lane: lane b writes row ``rows[b]`` (the
    continuous scheduler's per-lane positions). cache (B, S, kv_dim) dense
    or ``PackedKV``; new (B, 1, kv_dim) dense."""
    bidx = torch.arange(new.shape[0], device=new.device)
    rows = torch.as_tensor(rows, device=new.device).long()
    if isinstance(cache, PackedKV):
        c, s = kv_encode(new, cache.fmt)
        cache.codes[bidx, rows] = c[:, 0]
        cache.scales[bidx, rows] = s[:, 0]
        return cache
    cache[bidx, rows] = new[:, 0].to(cache.dtype)
    return cache


def kv_write_slice(cache, new: torch.Tensor, start: int):
    """Write ``new`` (B, C, kv_dim) at rows start..start+C-1 of every lane
    (the wave scheduler's shared position, chunked prefill)."""
    C = new.shape[1]
    st = int(start)
    if isinstance(cache, PackedKV):
        c, s = kv_encode(new, cache.fmt)
        cache.codes[:, st:st + C] = c
        cache.scales[:, st:st + C] = s
        return cache
    cache[:, st:st + C] = new.to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# Paged-cache writes
# ---------------------------------------------------------------------------

def kv_write_token_paged(pool: PagedKV, new: torch.Tensor,
                         pages: torch.Tensor, offs: torch.Tensor) -> PagedKV:
    """Scatter one token per lane: pool (N, P, ·) layer slice; new (B, 1, D)
    dense; lane b writes pool[pages[b], offs[b]], quantized at append time
    when the pool is MX-packed."""
    pages, offs = pages.long(), offs.long()
    if pool.fmt == "none":
        pool.codes[pages, offs] = new[:, 0].to(pool.codes.dtype)
        return pool
    c, s = kv_encode(new, pool.fmt)
    pool.codes[pages, offs] = c[:, 0]
    pool.scales[pages, offs] = s[:, 0]
    return pool


def _chunk_pages_offs(block_tables: torch.Tensor, B: int, C: int, P: int,
                      start):
    """(pages, offs) (B, C) int64 for a C-token chunk at ``start`` — a
    scalar shared by all lanes or a (B,) per-lane vector."""
    st = torch.as_tensor(start, device=block_tables.device).long()
    ar = torch.arange(C, device=block_tables.device)
    pos = st[:, None] + ar[None, :] if st.ndim == 1 else (st + ar)[None, :]
    pos = pos.expand(B, C)
    idx = (pos // P).clamp(max=block_tables.shape[1] - 1)
    return torch.take_along_dim(block_tables.long(), idx, dim=1), pos % P


def kv_write_chunk_paged(pool: PagedKV, new: torch.Tensor,
                         block_tables: torch.Tensor, start) -> PagedKV:
    """Write a C-token chunk at positions start..start+C-1 through the
    block tables (chunks may straddle page boundaries). new (B, C, D)."""
    B, C = new.shape[0], new.shape[1]
    pages, offs = _chunk_pages_offs(block_tables, B, C, pool.page_size,
                                    start)
    if pool.fmt == "none":
        pool.codes[pages, offs] = new.to(pool.codes.dtype)
        return pool
    c, s = kv_encode(new, pool.fmt)
    pool.codes[pages, offs] = c
    pool.scales[pages, offs] = s
    return pool


def kv_scatter_chunk_paged(pool: PagedKV, codes: torch.Tensor,
                           scales: torch.Tensor, block_tables: torch.Tensor,
                           start) -> PagedKV:
    """Scatter *pre-encoded* chunk bytes (the fused prefill kernel's
    quantize-on-append outputs) into a packed pool — byte-identical to
    :func:`kv_write_chunk_paged` of the dense chunk."""
    if pool.fmt == "none":
        raise ValueError("kv_scatter_chunk_paged commits packed bytes; a "
                         "dense (fmt='none') pool has none — use "
                         "kv_write_chunk_paged")
    B, C = codes.shape[0], codes.shape[1]
    pages, offs = _chunk_pages_offs(block_tables, B, C, pool.page_size,
                                    start)
    pool.codes[pages, offs] = codes
    pool.scales[pages, offs] = scales
    return pool


def kv_heads_view(c, kvh: int, dh: int):
    """(B, S, kv_dim) cache leaf -> the (B, S, K, Dh) view attention takes.
    A ``PackedKV`` passes through: attention dispatches on it."""
    if isinstance(c, PackedKV):
        return c
    return c.reshape(c.shape[0], c.shape[1], kvh, dh)


def attention_paged(q: torch.Tensor, k_pool: PagedKV, v_pool: PagedKV,
                    block_tables: torch.Tensor, *, causal: bool, q_pos,
                    window: int = 0, kv_len=None, chunk: int = 1024,
                    backend: str = "ref") -> torch.Tensor:
    """Attention over a paged pool. Under ``backend='fused'`` the
    single-token decode contract (Sq == 1, quantized pool, known fill)
    runs ``ops.mx_flash_decode_paged``; everything else gathers each
    lane's pages into the logical layout and runs :func:`attention`."""
    B, Sq, H, Dh = q.shape
    if (backend == "fused" and Sq == 1 and causal and k_pool.fmt != "none"
            and kv_len is not None):
        qp = torch.as_tensor(q_pos)
        qpv = qp[:, 0] if qp.ndim == 2 else qp.reshape(-1)
        out = ops.mx_flash_decode_paged(
            q.reshape(B, H, Dh), k_pool.codes, k_pool.scales, v_pool.codes,
            v_pool.scales, block_tables, qpv,
            torch.as_tensor(kv_len).reshape(-1), k_pool.fmt, window=window)
        return out.reshape(B, Sq, H, Dh).to(q.dtype)
    kvh = k_pool.feature_dim // Dh
    kd = kv_heads_view(k_pool.gather_dense(block_tables), kvh, Dh)
    vd = kv_heads_view(v_pool.gather_dense(block_tables), kvh, Dh)
    return attention(q, kd, vd, causal=causal, q_pos=q_pos, window=window,
                     kv_len=kv_len, chunk=chunk)


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * gamma.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_inv_freq(theta: float, half: int) -> np.ndarray:
    """RoPE inverse-frequency table, computed in numpy f32 exactly as the
    JAX package computes it."""
    return (1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
            ).astype(np.float32)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x (B, S, N, Dh); pos (S,) positions shared by the batch or (B, S)
    per-row positions. Rotates (x[..., :half], x[..., half:]) pairs."""
    half = x.shape[-1] // 2
    inv_freq = torch.as_tensor(_rope_inv_freq(float(theta), half),
                               device=x.device)
    pos = torch.as_tensor(pos, device=x.device)
    if pos.ndim == 2:
        freqs = pos.float()[:, :, None] * inv_freq[None, None, :]
        cos, sin = freqs.cos()[:, :, None, :], freqs.sin()[:, :, None, :]
    else:
        freqs = pos.float()[:, None] * inv_freq[None, :]
        cos, sin = freqs.cos()[None, :, None, :], freqs.sin()[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention — grouped-query, online softmax over KV chunks
# ---------------------------------------------------------------------------

def _attention_packed(q, k: PackedKV, v: PackedKV, *, causal, q_pos,
                      k_start, window, kv_len, chunk, backend):
    """Attention over a contiguous MX-packed cache. Under
    ``backend='fused'`` the single-token decode contract (Sq == 1, causal,
    keys from position 0, a known fill) runs ``ops.mx_flash_decode``;
    everything else — chunked prefill, the 'ref' backend — decodes the
    cache in place and runs the dense :func:`attention` on the same
    values (the JAX package has no kernel there either)."""
    B, Sq, H, Dh = q.shape
    if (backend == "fused" and Sq == 1 and causal and k_start == 0
            and kv_len is not None):
        qp = torch.as_tensor(q_pos)
        qpv = qp[:, 0] if qp.ndim == 2 else qp.reshape(-1)
        out = ops.mx_flash_decode(
            q.reshape(B, H, Dh), k.codes, k.scales, v.codes, v.scales, qpv,
            torch.as_tensor(kv_len).reshape(-1), k.fmt, window=window)
        return out.reshape(B, Sq, H, Dh).to(q.dtype)
    kvh = k.shape[-1] // Dh
    kd = kv_heads_view(k.to_dense(), kvh, Dh)
    vd = kv_heads_view(v.to_dense(), kvh, Dh)
    return attention(q, kd, vd, causal=causal, q_pos=q_pos,
                     k_start=k_start, window=window, kv_len=kv_len,
                     chunk=chunk)


def attention(q: torch.Tensor, k, v, *, causal: bool, q_pos,
              k_start: int = 0, window: int = 0, kv_len=None,
              chunk: int = 1024, backend: str = "ref") -> torch.Tensor:
    """Memory-bounded attention. q (B, Sq, H, Dh); k, v (B, Sk, K, Dh)
    with H % K == 0 — or ``PackedKV`` leaves of logical shape (B, Sk,
    K*Dh), dispatched by :func:`_attention_packed`; q_pos (Sq,) shared or
    (B, Sq) per-row absolute positions; k_start the position of k[:, 0];
    window > 0 masks keys at pos <= q_pos - window; kv_len masks key
    indices >= kv_len (a scalar or a (B,) vector). Output (B, Sq, H,
    Dh)."""
    if isinstance(k, PackedKV):
        return _attention_packed(q, k, v, causal=causal, q_pos=q_pos,
                                 k_start=k_start, window=window,
                                 kv_len=kv_len, chunk=chunk, backend=backend)
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, Dh).to(k.dtype)
    scale = sm_scale(Dh)
    if Sk % chunk != 0 or Sk <= chunk:
        chunk = Sk
    qp = torch.as_tensor(q_pos, device=q.device).long()
    qp = qp[None, :] if qp.ndim == 1 else qp                # (1|B, Sq)
    kl = (None if kv_len is None else
          torch.as_tensor(kv_len, device=q.device).long().reshape(-1, 1, 1))

    m = torch.full((B, Sq, K, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Sq, K, G), device=q.device)
    acc = torch.zeros((B, Sq, K, G, Dh), device=q.device)
    for i in range(Sk // chunk):
        kci = k[:, i * chunk:(i + 1) * chunk]
        vci = v[:, i * chunk:(i + 1) * chunk]
        kp = k_start + i * chunk + torch.arange(chunk, device=q.device)
        kpb = kp[None, None, :]
        ok = kpb >= 0
        if causal:
            ok = ok & (kpb <= qp[:, :, None])
        if window:
            ok = ok & (kpb > qp[:, :, None] - window)
        if kl is not None:
            ok = ok & (kpb - k_start < kl)
        okb = ok[:, :, None, None, :]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg.float(), kci.float()) * scale
        s = torch.where(okb, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(okb, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(k.dtype).float(), vci.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def gated_mlp(x: torch.Tensor, wg, wu, wd, qm: QuantMode, act: str = "silu",
              bg=None, bu=None, bd=None) -> torch.Tensor:
    """SwiGLU / GeGLU: down(act(x @ wg) * (x @ wu)). Under the fused
    backend the down projection's online T3 runs in the GEMM prologue."""
    g = qlinear(x, wg, bg, qm, "ffn_in")
    u = qlinear(x, wu, bu, qm, "ffn_in")
    fn = F.silu if act == "silu" else F.gelu
    h = fn(g.float()).to(x.dtype) * u
    return qlinear(h, wd, bd, qm, "ffn_down")


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0, device="cpu") -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return (w * (scale / d_in ** 0.5)).to(dtype)
