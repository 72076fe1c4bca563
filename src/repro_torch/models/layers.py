"""Shared layers of the model families: RMSNorm (and Mamba2's gated form),
RoPE, GQA attention (online softmax over KV chunks, optionally over a ring
buffer's explicit key positions), the differentiable flash attention of
training and prefill, the KV-cache writes of both layouts, the gated MLP
and the depthwise causal conv of the recurrent families — the port of
``repro.models.layers``.

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

from repro_torch.core import quantize
from repro_torch.core.quantize import QuantMode
from repro_torch.kernels import ops
from repro_torch.kernels.packing import (PackedKV, PagedKV, kv_decode,
                                         kv_encode, torch_dtype)
from repro_torch.kernels.ref import sm_scale
from repro_torch.launch import pcontext as pctx

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Projections and KV codecs under a mesh
# ---------------------------------------------------------------------------

def qlinear(x: torch.Tensor, w, b, qm: QuantMode, role: str = ""):
    """:func:`repro_torch.core.quantize.qlinear`. Under a mesh its
    reference path runs the MX numerics (T3, the quantizers) as islands on
    each rank's whole blocks — rows made whole first, a partial sum
    reduced — and the product as a ``DTensor`` matmul; the packed kernel's
    wrapper takes whole operands itself."""
    if not pctx.is_dtensor(x) or quantize.fused_route(x, w, qm, role):
        return quantize.qlinear(x, w, b, qm, role)
    ops.record_quant_path("qlinear", "ref", role)
    x = pctx.rows_whole(x)
    block = lambda c: c.block_size if qm.enabled and c is not None else 0
    bx = max(qm.t3_block if role == "ffn_down" else 0, block(qm.act_cfg))
    xq = x if not bx else pctx.blockwise(
        lambda t: quantize.quant_act(t, qm, role), x, bx)
    if pctx.is_dtensor(w) and block(qm.weight_cfg):
        wq = pctx.blockwise(
            lambda t: quantize.quant_weight(t.mT, qm, role).mT, w.mT,
            block(qm.weight_cfg)).mT
    else:
        wq = quantize.quant_weight(w, qm, role)
    y = xq @ wq
    return y if b is None else y + b


def _lanes(x, lanes: int) -> tuple:
    return tuple("batch" if i == lanes else None for i in range(x.ndim))


def kv_codes(x: torch.Tensor, fmt: str, lanes: int = 0):
    """``kv_encode(x, fmt)``; under a mesh each rank encodes its own lanes
    (axis ``lanes``), the feature axis whole."""
    n = _lanes(x, lanes)
    return pctx.local(lambda t: kv_encode(t, fmt), (x,), (n,),
                      out_like=(0, 0))


def kv_pack(x: torch.Tensor, fmt: str, lanes: int = 0) -> PackedKV:
    """``PackedKV.from_dense`` through :func:`kv_codes`."""
    c, s = kv_codes(x, fmt, lanes)
    return PackedKV(c, s, fmt, str(x.dtype).replace("torch.", ""))


def kv_dense(c: PackedKV, lanes: int = 0) -> torch.Tensor:
    """``c.to_dense()``; under a mesh each rank decodes its own lanes."""
    n = _lanes(c.codes, lanes)
    return pctx.local(
        lambda a, s: kv_decode(a, s, c.fmt, torch_dtype(c.dtype)),
        (c.codes, c.scales), (n, n))


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
        c, s = kv_codes(new, cache.fmt)
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
        c, s = kv_codes(new, cache.fmt)
        cache.codes[:, st:st + C] = c
        cache.scales[:, st:st + C] = s
        return cache
    cache[:, st:st + C] = new.to(cache.dtype)
    return cache


def spec_slots(pos, n_valid, C: int, limit: int | None = None) -> tuple:
    """The slots a speculative verify step writes: lane b slot j for
    ``j < n_valid[b]`` (and ``pos[b] + j < limit`` when given), as long
    tensors (b, j, t) with ``t = pos[b] + j`` its logical position, on
    ``pos``' device. Computed once per verify forward: with host tensors it
    needs no device sync."""
    pv = torch.as_tensor(pos).long()
    nv = torch.as_tensor(n_valid, device=pv.device).long()
    j = torch.arange(C, device=pv.device)[None, :]
    t = pv[:, None] + j
    ok = j < nv[:, None]
    if limit is not None:
        ok = ok & (t < limit)
    b, jj = ok.nonzero(as_tuple=True)
    return b, jj, t[b, jj]


def kv_write_spec(cache, new: torch.Tensor, slots: tuple):
    """Per-lane multi-token write of the speculative verify step: slot
    (b, j, t) of :func:`spec_slots` writes ``new[b, j]`` at row t of lane
    b; the other slots (past a lane's draft count, or past the cache) write
    nothing. cache (B, S, kv_dim) dense or ``PackedKV``; new (B, C, kv_dim)
    dense."""
    b, j, t = (s.to(new.device) for s in slots)
    if isinstance(cache, PackedKV):
        c, s = kv_codes(new[b, j][None], cache.fmt)
        cache.codes[b, t] = c[0]
        cache.scales[b, t] = s[0]
        return cache
    cache[b, t] = new[b, j].to(cache.dtype)
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
    c, s = kv_codes(new, pool.fmt)
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
    c, s = kv_codes(new, pool.fmt)
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


def kv_write_spec_paged(pool: PagedKV, new: torch.Tensor,
                        block_tables: torch.Tensor, slots: tuple) -> PagedKV:
    """Per-lane multi-token write through block tables: slot (b, j, t) of
    :func:`spec_slots` writes ``new[b, j]`` at logical position t of lane
    b (page ``block_tables[b, t // P]``, the page index clipped to the
    table as the JAX package clips it); invalid slots write nothing.
    pool (N, P, ·) layer slice; new (B, C, D)."""
    b, j, t = (s.to(new.device) for s in slots)
    P = pool.page_size
    idx = (t // P).clamp(max=block_tables.shape[1] - 1)
    pages = block_tables.long()[b, idx]
    offs = t % P
    if pool.fmt == "none":
        pool.codes[pages, offs] = new[b, j].to(pool.codes.dtype)
        return pool
    c, s = kv_codes(new[b, j][None], pool.fmt)
    pool.codes[pages, offs] = c[0]
    pool.scales[pages, offs] = s[0]
    return pool


def split_heads(t, n: int, dh: int):
    """(B, S, n*dh) -> (B, S, n, dh). Under a mesh the feature axis stays
    split over "model" only where the head count divides by it (a split
    inside a head cannot be unflattened); otherwise it is gathered first."""
    B, S = t.shape[0], t.shape[1]
    ax = pctx.resolve("model")
    if ax is not None and n % pctx.axis_size(ax) != 0:
        t = pctx.shard(t, "batch", None, None)
    return t.reshape(B, S, n, dh)


def merge_heads(t):
    """(B, S, n, dh) -> (B, S, n*dh). Under a mesh whose "model" axis does
    not divide the head count the heads are made whole on every rank, and
    so is the gradient the reshape's backward hands them (DTensor cannot
    split a split feature axis into heads)."""
    B, S, n, dh = t.shape
    ax = pctx.resolve("model")
    if ax is not None and n % pctx.axis_size(ax) != 0:
        t = pctx.shard(t, "batch", None, None, None)
        return pctx.grad_like(t.reshape(B, S, n * dh))
    return t.reshape(B, S, n * dh)


def kv_heads_view(c, kvh: int, dh: int):
    """(B, S, kv_dim) cache leaf -> the (B, S, K, Dh) view attention takes.
    A ``PackedKV`` passes through: attention dispatches on it."""
    if isinstance(c, PackedKV):
        return c
    return split_heads(c, kvh, dh)


def shard_kv(c, *names):
    """``pctx.shard`` over a cache leaf; a ``PackedKV`` shards its
    children (codes and E8M0 bytes share the leading axes, and the
    feature axis is each one's last)."""
    if isinstance(c, PackedKV):
        return PackedKV(pctx.shard(c.codes, *names),
                        pctx.shard(c.scales, *names), c.fmt, c.dtype)
    return pctx.shard(c, *names)


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


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor,
                   eps: float = 1e-5):
    """Mamba2's gated norm: rmsnorm(x * silu(z)) * gamma."""
    return rms_norm(x * F.silu(z.float()).to(x.dtype), gamma, eps)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) in the JAX package's form (``jax.nn.softplus``,
    ``logaddexp(x, 0)``): no threshold past which x is returned as is."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


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
                      k_start, window, kv_len, k_positions, chunk, backend):
    """Attention over a contiguous MX-packed cache. Under
    ``backend='fused'`` the single-token decode contract (Sq == 1, causal,
    keys from position 0, a known fill) runs ``ops.mx_flash_decode``;
    everything else — chunked prefill, ring-buffer caches (``k_positions``),
    the 'ref' backend — decodes the cache in place and runs the dense
    :func:`attention` on the same values (the JAX package has no kernel
    there either)."""
    B, Sq, H, Dh = q.shape
    if (backend == "fused" and Sq == 1 and causal and k_positions is None
            and k_start == 0 and kv_len is not None):
        qp = torch.as_tensor(q_pos)
        qpv = qp[:, 0] if qp.ndim == 2 else qp.reshape(-1)
        out = ops.mx_flash_decode(
            q.reshape(B, H, Dh), k.codes, k.scales, v.codes, v.scales, qpv,
            torch.as_tensor(kv_len).reshape(-1), k.fmt, window=window)
        return out.reshape(B, Sq, H, Dh).to(q.dtype)
    kvh = k.shape[-1] // Dh
    kd = kv_heads_view(kv_dense(k), kvh, Dh)
    vd = kv_heads_view(kv_dense(v), kvh, Dh)
    return attention(q, kd, vd, causal=causal, q_pos=q_pos,
                     k_start=k_start, window=window, kv_len=kv_len,
                     k_positions=k_positions, chunk=chunk)


def _head_names(H: int, K: int) -> tuple:
    """Logical names of a (B, S, heads, Dh) attention operand: heads over
    "model" only where both the query and the KV head counts divide by it
    (so each rank's query heads meet their own KV heads)."""
    ax = pctx.resolve("model")
    size = 1 if ax is None else pctx.axis_size(ax)
    split = ax is not None and H % size == 0 and K % size == 0
    return ("batch", None, "model" if split else None, None)


def attention(q: torch.Tensor, k, v, *, causal: bool, q_pos,
              k_start: int = 0, window: int = 0, kv_len=None,
              k_positions=None, chunk: int = 1024,
              backend: str = "ref") -> torch.Tensor:
    """Memory-bounded attention. q (B, Sq, H, Dh); k, v (B, Sk, K, Dh)
    with H % K == 0 — or ``PackedKV`` leaves of logical shape (B, Sk,
    K*Dh), dispatched by :func:`_attention_packed`; q_pos (Sq,) shared or
    (B, Sq) per-row absolute positions; k_start the position of k[:, 0];
    window > 0 masks keys at pos <= q_pos - window; kv_len masks key
    indices >= kv_len (a scalar or a (B,) vector); k_positions (Sk,)
    gives each key slot its position instead (a ring buffer), entries < 0
    invalid. Output (B, Sq, H, Dh)."""
    if isinstance(k, PackedKV):
        return _attention_packed(q, k, v, causal=causal, q_pos=q_pos,
                                 k_start=k_start, window=window,
                                 kv_len=kv_len, k_positions=k_positions,
                                 chunk=chunk, backend=backend)
    if pctx.is_dtensor(q) or pctx.is_dtensor(k):
        # under a mesh each rank attends its own lanes and heads
        lane = lambda t: (None if t is None or torch.as_tensor(t).ndim == 0
                          or torch.as_tensor(t).shape[0] != q.shape[0]
                          or torch.as_tensor(t).ndim > 2 else
                          ("batch",) + (None,) * (torch.as_tensor(t).ndim - 1))
        qpt = torch.as_tensor(q_pos, device=q.device)
        klt = None if kv_len is None else torch.as_tensor(kv_len,
                                                          device=q.device)
        heads = _head_names(q.shape[2], k.shape[2])
        qpn = lane(qpt) if qpt.ndim == 2 else None
        kln = None if klt is None else lane(klt)
        return pctx.local(
            lambda q, k, v, qp, kl: attention(
                q, k, v, causal=causal, q_pos=qp, k_start=k_start,
                window=window, kv_len=kl, k_positions=k_positions,
                chunk=chunk),
            (q, k, v, qpt, klt), (heads, heads, heads, qpn, kln))
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
    kpos = (None if k_positions is None else
            torch.as_tensor(k_positions, device=q.device).long())

    m = torch.full((B, Sq, K, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Sq, K, G), device=q.device)
    acc = torch.zeros((B, Sq, K, G, Dh), device=q.device)
    for i in range(Sk // chunk):
        kci = k[:, i * chunk:(i + 1) * chunk]
        vci = v[:, i * chunk:(i + 1) * chunk]
        kp = (k_start + i * chunk + torch.arange(chunk, device=q.device)
              if kpos is None else kpos[i * chunk:(i + 1) * chunk])
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
# Flash-style differentiable attention: the backward recomputes the scores
# chunk by chunk from (q, k, v, out, lse), so training keeps O(S·d) and not
# the per-chunk score residuals autograd would save.
# ---------------------------------------------------------------------------

def _fa_mask(q_pos, k_pos, causal: bool, window: int):
    ok = k_pos[None, :] >= 0
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return ok[None, :, None, None, :]                  # (1, Sq, 1, 1, c)


def _fa_forward(qg, k, v, causal, window, chunk, scale):
    """qg (B, Sq, K, G, Dh); k, v (B, Sk, K, Dh), keys at 0..Sk-1 and
    queries at 0..Sq-1. Returns (out (B, Sq, K, G, Dh) f32, lse (B, Sq, K,
    G)). Unlike :func:`attention`, p stays f32 in the value product."""
    B, Sq, K, G, Dh = qg.shape
    dev = qg.device
    q_pos = torch.arange(Sq, device=dev)
    qf = qg.float()
    m = torch.full((B, Sq, K, G), NEG_INF, device=dev)
    l = torch.zeros((B, Sq, K, G), device=dev)
    acc = torch.zeros((B, Sq, K, G, Dh), device=dev)
    for i in range(k.shape[1] // chunk):
        kp = i * chunk + torch.arange(chunk, device=dev)
        ok = _fa_mask(q_pos, kp, causal, window)
        s = torch.einsum("bqkgd,bckd->bqkgc", qf,
                         k[:, i * chunk:(i + 1) * chunk].float()) * scale
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p, v[:, i * chunk:(i + 1) * chunk].float())
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    return acc / lc[..., None], m + torch.log(lc)


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``flash_attention`` custom VJP: the forward saves
    (q, k, v, out, lse); the backward walks the KV chunks again."""

    @staticmethod
    def forward(ctx, qg, k, v, causal, window, chunk, scale):
        out, lse = _fa_forward(qg, k, v, causal, window, chunk, scale)
        ctx.save_for_backward(qg, k, v, out, lse)
        ctx.args = (causal, window, chunk, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, out, lse = ctx.saved_tensors
        causal, window, chunk, scale = ctx.args
        dev = qg.device
        q_pos = torch.arange(qg.shape[1], device=dev)
        qf, do = qg.float(), dout.float()
        delta = (do * out).sum(dim=-1)                  # (B, Sq, K, G)
        dq = torch.zeros(qg.shape, device=dev)
        dks, dvs = [], []
        for i in range(k.shape[1] // chunk):
            kci = k[:, i * chunk:(i + 1) * chunk].float()
            vci = v[:, i * chunk:(i + 1) * chunk].float()
            kp = i * chunk + torch.arange(chunk, device=dev)
            ok = _fa_mask(q_pos, kp, causal, window)
            s = torch.einsum("bqkgd,bckd->bqkgc", qf, kci) * scale
            p = torch.where(ok, torch.exp(s - lse[..., None]),
                            torch.zeros_like(s))
            dvs.append(torch.einsum("bqkgc,bqkgd->bckd", p, do))
            dp = torch.einsum("bqkgd,bckd->bqkgc", do, vci)
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bqkgc,bckd->bqkgd", ds, kci)
            dks.append(torch.einsum("bqkgc,bqkgd->bckd", ds, qf))
        return (dq.to(qg.dtype), torch.cat(dks, dim=1).to(k.dtype),
                torch.cat(dvs, dim=1).to(v.dtype), None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, chunk: int) -> torch.Tensor:
    """Differentiable memory-efficient attention for full-sequence training
    and prefill: q (B, Sq, H, Dh) at positions 0..Sq-1, k, v (B, Sk, K, Dh)
    contiguous from position 0. Output (B, Sq, H, Dh) in q's dtype."""
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if Sk % chunk != 0 or Sk <= chunk:
        chunk = Sk

    def run(q, k, v):           # on each rank's lanes and heads
        b, sq, h, dh = q.shape
        kv = k.shape[2]
        out = _FlashAttention.apply(q.reshape(b, sq, kv, h // kv, dh), k, v,
                                    causal, window, chunk, sm_scale(Dh))
        return out.reshape(b, sq, h, dh).to(q.dtype)
    heads = _head_names(H, K)
    return pctx.local(run, (q, k, v), (heads,) * 3)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def gated_mlp(x: torch.Tensor, wg, wu, wd, qm: QuantMode, act: str = "silu",
              bg=None, bu=None, bd=None) -> torch.Tensor:
    """SwiGLU / GeGLU: down(act(x @ wg) * (x @ wu)); GeGLU's GELU is the
    tanh form (``jax.nn.gelu``'s default). Under the fused backend the down
    projection's online T3 runs in the GEMM prologue."""
    g = qlinear(x, wg, bg, qm, "ffn_in")
    u = qlinear(x, wu, bu, qm, "ffn_in")
    h = (F.silu(g.float()) if act == "silu"
         else F.gelu(g.float(), approximate="tanh")).to(x.dtype) * u
    return qlinear(h, wd, bd, qm, "ffn_down")


# ---------------------------------------------------------------------------
# Depthwise causal conv (the Griffin and Mamba2 temporal conv)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """x (B, L, C); w (C, K) depthwise; left-padded by K - 1 (causal)."""
    K, L = w.shape[-1], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    views = torch.stack([xp[:, i:i + L] for i in range(K)], dim=-1)
    y = torch.einsum("blck,ck->blc", views, w.to(x.dtype))
    return y if b is None else y + b.to(x.dtype)


def conv1d_step(conv_state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
                b):
    """One decode step. conv_state (B, C, K-1) the previous inputs, x_t
    (B, C). Returns (y_t (B, C), the new state)."""
    full = torch.cat([conv_state, x_t[:, :, None]], dim=-1)      # (B, C, K)
    y = torch.einsum("bck,ck->bc", full, w.to(x_t.dtype))
    if b is not None:
        y = y + b.to(x_t.dtype)
    return y, full[:, :, 1:]


def embed_lookup(table, ids):
    """``table[ids]`` (rows of the token embedding), laid out over the
    batch under a mesh: each rank looks its lanes' tokens up in the whole
    table (DTensor's own rule for a row lookup in a vocab-split table did
    not survive its backward in every torch release)."""
    ids = ids.long()
    if not pctx.is_dtensor(table):
        return table[ids]
    names = ("batch",) + (None,) * (ids.ndim - 1)
    return pctx.local(lambda t, i: t[i], (table, ids),
                      ((None, None), names), out_like=1)


def shard_batch(x, *rest):
    """Annotate a (B, ...) activation with batch sharding."""
    return pctx.shard(x, "batch", *rest)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0, device="cpu") -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return (w * (scale / d_in ** 0.5)).to(dtype)
