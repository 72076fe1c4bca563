"""Dense transformer (llama-style: pre-RMSNorm, GQA + RoPE, SwiGLU) — the
port of ``repro.models.transformer``: training forward, serving, and the
norm and transform folds of the PTQ pipeline. It serves the families
``dense``, ``encoder`` (``causal=False``, no decode path) and ``vlm``
(``embed_inputs=False``: a stub front end gives (B, S, d) embeddings, and
the PTQ fold leaves T1 as ``params["input_transform"]``).

Parameters are the JAX package's nested dict with layer-stacked leaves
(``blocks/wq`` is ``(L, d, q_dim)``, a ``PackedWeight`` when served from an
artifact); the layers run as a Python loop over the leading axis. The
contiguous cache is ``{"k", "v"}`` of ``(L, B, S, kv_dim)`` dense tensors or
``PackedKV``; the paged KV pool is ``{"k": PagedKV, "v": PagedKV}`` of
``(L, N, P, ·)``. Both are updated in place.
"""
from __future__ import annotations

import math

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import devices
from repro_torch.configs.base import ArchConfig
from repro_torch.core import folding as fold_lib
from repro_torch.core.quantize import QuantMode
from repro_torch.kernels import ops
from repro_torch.kernels.packing import PackedKV, PagedKV

from repro_torch.launch import pcontext as pctx

from .layers import (apply_rope, attention, attention_paged, dense_init,
                     embed_lookup, flash_attention, gated_mlp, kv_heads_view,
                     kv_pack, kv_scatter_chunk_paged, kv_write_chunk_paged,
                     kv_write_rows, kv_write_slice, kv_write_spec,
                     kv_write_spec_paged, kv_write_token_paged, merge_heads,
                     qlinear, rms_norm, shard_batch, shard_kv, spec_slots,
                     split_heads)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None, place=lambda name, t: t):
    """Seeded random parameters at ``cfg``'s widths (the JAX package's
    layout and scales; ``torch.Generator`` draws, so the values differ);
    ``place`` as :func:`repro_torch.models.api.init` takes it."""
    device = gen.device if device is None else device
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    qd, kd = cfg.q_dim, cfg.kv_dim

    def stack(din, dout, scale=1.0, name=""):
        return place(name, torch.stack([
            dense_init(gen, din, dout, dtype, scale, device)
            for _ in range(L)]))

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    out_scale = 1.0 / math.sqrt(2.0 * L)
    blocks = {"ln1": full((L, d), 1.0), "wq": stack(d, qd, name="wq"),
              "wk": stack(d, kd, name="wk"), "wv": stack(d, kd, name="wv"),
              "wo": stack(qd, d, out_scale, "wo"), "ln2": full((L, d), 1.0),
              "wg": stack(d, f, name="wg"), "wu": stack(d, f, name="wu"),
              "wd": stack(f, d, out_scale, "wd")}
    if cfg.qkv_bias:
        blocks["bq"] = full((L, qd), 0.0)
        blocks["bk"] = full((L, kd), 0.0)
        blocks["bv"] = full((L, kd), 0.0)
    params = {"blocks": blocks, "ln_f": full((d,), 1.0)}
    if cfg.embed_inputs:
        params["embed"] = place("embed", (torch.randn(
            (cfg.vocab_size, d), generator=gen, device=device) * 0.02
        ).to(dtype))
        if not cfg.tie_embeddings:
            params["head"] = place("head", dense_init(
                gen, d, cfg.vocab_size, dtype, device=device))
    else:
        params["head"] = place("head", dense_init(
            gen, d, cfg.vocab_size, dtype, device=device))
    return params


def head_matrix(params, cfg: ArchConfig):
    if "head" in params:
        return params["head"]
    return params["embed"].T  # tied


def head_out(x, params, cfg: ArchConfig, qm: QuantMode):
    return qlinear(x, head_matrix(params, cfg), params.get("bhead"), qm,
                   "head")


def _layer(blocks: dict, i: int) -> dict:
    return {k: v[i] for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Block sublayers
# ---------------------------------------------------------------------------

def _qkv(x, p, cfg: ArchConfig, qm: QuantMode, pos):
    B, S, _ = x.shape
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = qlinear(h, p["wq"], p.get("bq"), qm, "qkv")
    k = qlinear(h, p["wk"], p.get("bk"), qm, "qkv")
    v = qlinear(h, p["wv"], p.get("bv"), qm, "qkv")
    q = pctx.shard(q, "batch", None, "model")
    q = apply_rope(split_heads(q, cfg.n_heads, cfg.head_dim), pos,
                   cfg.rope_theta)
    kh = apply_rope(split_heads(k, cfg.n_kv_heads, cfg.head_dim), pos,
                    cfg.rope_theta)
    return q, kh.reshape(B, S, cfg.kv_dim), v


def attn_sublayer(x, p, cfg: ArchConfig, qm: QuantMode, pos,
                  window: int = 0):
    """Full-sequence attention (train / prefill, no cache) through
    :func:`flash_attention`, whose backward recomputes the scores per KV
    chunk. Returns (x', k, v)."""
    B, S, _ = x.shape
    q, k, v = _qkv(x, p, cfg, qm, pos)
    kh = split_heads(k, cfg.n_kv_heads, cfg.head_dim)
    vh = split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    repeat = cfg.attn_repeat_kv and pctx.active()
    if repeat:
        # under a mesh, materialize kv to H heads: every attention tensor
        # then carries a TP-divisible head axis, so the attention stays
        # head-sharded instead of replicated (the JAX package's §Perf
        # layout; the repeat is exact, so the values do not move)
        g = cfg.n_heads // cfg.n_kv_heads
        kh = torch.repeat_interleave(kh, g, dim=2)
        vh = torch.repeat_interleave(vh, g, dim=2)
        q = pctx.shard(q, "batch", None, "model", None)
        kh = pctx.shard(kh, "batch", None, "model", None)
        vh = pctx.shard(vh, "batch", None, "model", None)
    out = flash_attention(q, kh, vh, causal=cfg.causal, window=window,
                          chunk=cfg.attn_chunk)
    if repeat:
        out = pctx.shard(out, "batch", None, "model", None)
    out = qlinear(merge_heads(out), p["wo"], p.get("bo"), qm, "attn_out")
    return x + out, k, v


def attn_sublayer_decode(x, p, cfg: ArchConfig, qm: QuantMode, cache_k,
                         cache_v, cur_len, window: int = 0):
    """One-token attention against a layer-sliced contiguous cache. x (B, 1,
    d); cache_k/v (B, S, kv_dim) dense or ``PackedKV``. ``cur_len`` is an
    int shared by the lanes (the wave scheduler: the new k/v land at row
    cur_len of every lane) or a (B,) tensor of per-lane fills (the
    continuous scheduler). Under the fused backend a packed cache is
    attended by the flash-decode kernel."""
    B = x.shape[0]
    dev = x.device
    if isinstance(cur_len, torch.Tensor) and cur_len.ndim == 1:
        cl = cur_len.to(dev).long()
        pos = cl[:, None]                                  # (B, 1)
        q, k, v = _qkv(x, p, cfg, qm, pos)
        kv_write_rows(cache_k, k, cl)
        kv_write_rows(cache_v, v, cl)
        kv_len = cl + 1
    else:
        cl = int(cur_len)
        pos = torch.full((1,), cl, dtype=torch.long, device=dev)
        q, k, v = _qkv(x, p, cfg, qm, pos)
        kv_write_slice(cache_k, k, cl)
        kv_write_slice(cache_v, v, cl)
        kv_len = pos + 1
    cache_k = shard_kv(cache_k, "batch", None, "model")
    cache_v = shard_kv(cache_v, "batch", None, "model")
    out = attention(q, kv_heads_view(cache_k, cfg.n_kv_heads, cfg.head_dim),
                    kv_heads_view(cache_v, cfg.n_kv_heads, cfg.head_dim),
                    causal=True, q_pos=pos, kv_len=kv_len, window=window,
                    chunk=cfg.attn_chunk, backend=qm.backend)
    out = qlinear(out.reshape(B, 1, cfg.q_dim), p["wo"], p.get("bo"), qm,
                  "attn_out")
    return x + out, cache_k, cache_v


def attn_sublayer_chunk(x, p, cfg: ArchConfig, qm: QuantMode, cache_k,
                        cache_v, pos, kv_len, window: int = 0):
    """Chunked-prefill attention against a layer-sliced contiguous cache:
    C tokens at positions ``pos`` (C,), contiguous from pos[0], are written
    at those rows, then attend the cache up to the fill ``kv_len`` (an int,
    pos[-1] + 1). A packed cache is decoded in place (the chunk attends the
    round trip of its own quantized rows)."""
    B, C = x.shape[0], x.shape[1]
    q, k, v = _qkv(x, p, cfg, qm, pos)
    start = int(kv_len) - C
    kv_write_slice(cache_k, k, start)
    kv_write_slice(cache_v, v, start)
    cache_k = shard_kv(cache_k, "batch", None, "model")
    cache_v = shard_kv(cache_v, "batch", None, "model")
    out = attention(q, kv_heads_view(cache_k, cfg.n_kv_heads, cfg.head_dim),
                    kv_heads_view(cache_v, cfg.n_kv_heads, cfg.head_dim),
                    causal=True, q_pos=pos, kv_len=kv_len, window=window,
                    chunk=cfg.attn_chunk, backend=qm.backend)
    out = qlinear(out.reshape(B, C, cfg.q_dim), p["wo"], p.get("bo"), qm,
                  "attn_out")
    return x + out, cache_k, cache_v


def attn_sublayer_decode_paged(x, p, cfg: ArchConfig, qm: QuantMode,
                               cache_k: PagedKV, cache_v: PagedKV,
                               block_tables, cur_len, window: int = 0):
    """One-token attention against a layer-sliced paged pool. x (B, 1, d);
    cur_len (B,) per-lane fills. The new k/v land at page
    ``block_tables[b, cur_len[b] // P]``, row ``cur_len[b] % P``; under the
    fused backend attention is the paged flash-decode kernel."""
    B = x.shape[0]
    cl = torch.as_tensor(cur_len, device=x.device).long()
    pos = cl[:, None]
    q, k, v = _qkv(x, p, cfg, qm, pos)
    P = cache_k.page_size
    pages = torch.take_along_dim(block_tables.long(), (cl // P)[:, None],
                                 dim=1)[:, 0]
    offs = cl % P
    kv_write_token_paged(cache_k, k, pages, offs)
    kv_write_token_paged(cache_v, v, pages, offs)
    out = attention_paged(q, cache_k, cache_v, block_tables, causal=True,
                          q_pos=pos, kv_len=cl + 1, window=window,
                          chunk=cfg.attn_chunk, backend=qm.backend)
    out = qlinear(out.reshape(B, 1, cfg.q_dim), p["wo"], p.get("bo"), qm,
                  "attn_out")
    return x + out, cache_k, cache_v


def attn_sublayer_chunk_paged(x, p, cfg: ArchConfig, qm: QuantMode,
                              cache_k: PagedKV, cache_v: PagedKV,
                              block_tables, pos, kv_len, window: int = 0):
    """Chunked-prefill attention against a paged pool. ``pos`` is (C,)
    positions shared by the lanes or (B, C) per lane; ``kv_len`` a scalar
    or (B,). With a quantized pool under the fused backend the step is
    ``ops.mx_flash_prefill`` (prefix pages through the block table, the
    chunk quantized in-kernel) and its chunk bytes are scattered into the
    pool; otherwise the chunk is quantized on append and attention runs on
    the gathered pages."""
    B, C = x.shape[0], x.shape[1]
    q, k, v = _qkv(x, p, cfg, qm, pos)
    posm = torch.as_tensor(pos, device=x.device)
    start = posm[:, 0] if posm.ndim == 2 else posm[0]
    if qm.backend == "fused" and cache_k.fmt != "none" and kv_len is not None:
        startv = start.reshape(-1).expand(B)
        klv = torch.as_tensor(kv_len, device=x.device).reshape(-1).expand(B)
        out, kc, ksb, vc, vsb = ops.mx_flash_prefill(
            q, k, v, cache_k.codes, cache_k.scales, cache_v.codes,
            cache_v.scales, block_tables, startv, klv, cache_k.fmt,
            window=window)
        kv_scatter_chunk_paged(cache_k, kc, ksb, block_tables, startv)
        kv_scatter_chunk_paged(cache_v, vc, vsb, block_tables, startv)
        out = out.to(x.dtype)
    else:
        kv_write_chunk_paged(cache_k, k, block_tables, start)
        kv_write_chunk_paged(cache_v, v, block_tables, start)
        out = attention_paged(q, cache_k, cache_v, block_tables,
                              causal=True, q_pos=pos, kv_len=kv_len,
                              window=window, chunk=cfg.attn_chunk,
                              backend=qm.backend)
    out = qlinear(out.reshape(B, C, cfg.q_dim), p["wo"], p.get("bo"), qm,
                  "attn_out")
    return x + out, cache_k, cache_v


def attn_sublayer_verify(x, p, cfg: ArchConfig, qm: QuantMode, cache_k,
                         cache_v, pos, n_valid, slots: tuple,
                         window: int = 0):
    """Multi-token verify attention of speculative decoding against a
    layer-sliced contiguous cache: lane b carries C tokens (its current
    token and C - 1 drafts) at positions ``pos[b] .. pos[b] + C - 1``; the
    first ``n_valid[b]`` are written (``slots``, from :func:`spec_slots`)
    and every row attends its own causal prefix, so slot j sees what a
    decode step at ``pos[b] + j`` would see. Attention is the plain version
    under both backends, as in the JAX package (its kernels take one query
    row)."""
    B, C = x.shape[0], x.shape[1]
    dev = x.device
    cl = torch.as_tensor(pos).long()
    nv = torch.as_tensor(n_valid, device=cl.device).long()
    qpos = cl.to(dev)[:, None] + torch.arange(C, device=dev)[None, :]
    q, k, v = _qkv(x, p, cfg, qm, qpos)
    kv_write_spec(cache_k, k, slots)
    kv_write_spec(cache_v, v, slots)
    cache_k = shard_kv(cache_k, "batch", None, "model")
    cache_v = shard_kv(cache_v, "batch", None, "model")
    out = attention(q, kv_heads_view(cache_k, cfg.n_kv_heads, cfg.head_dim),
                    kv_heads_view(cache_v, cfg.n_kv_heads, cfg.head_dim),
                    causal=True, q_pos=qpos, kv_len=(cl + nv).to(dev),
                    window=window, chunk=cfg.attn_chunk, backend=qm.backend)
    out = qlinear(out.reshape(B, C, cfg.q_dim), p["wo"], p.get("bo"), qm,
                  "attn_out")
    return x + out, cache_k, cache_v


def attn_sublayer_verify_paged(x, p, cfg: ArchConfig, qm: QuantMode,
                               cache_k: PagedKV, cache_v: PagedKV,
                               block_tables, pos, n_valid, slots: tuple,
                               window: int = 0):
    """Paged form of :func:`attn_sublayer_verify`: the valid slots write
    through the block tables and attention reads the gathered pages (the
    paged kernels take one query row)."""
    B, C = x.shape[0], x.shape[1]
    dev = x.device
    cl = torch.as_tensor(pos).long()
    nv = torch.as_tensor(n_valid, device=cl.device).long()
    qpos = cl.to(dev)[:, None] + torch.arange(C, device=dev)[None, :]
    q, k, v = _qkv(x, p, cfg, qm, qpos)
    kv_write_spec_paged(cache_k, k, block_tables, slots)
    kv_write_spec_paged(cache_v, v, block_tables, slots)
    out = attention_paged(q, cache_k, cache_v, block_tables, causal=True,
                          q_pos=qpos, kv_len=(cl + nv).to(dev),
                          window=window, chunk=cfg.attn_chunk,
                          backend=qm.backend)
    out = qlinear(out.reshape(B, C, cfg.q_dim), p["wo"], p.get("bo"), qm,
                  "attn_out")
    return x + out, cache_k, cache_v


def ffn_sublayer(x, p, cfg: ArchConfig, qm: QuantMode):
    """The dense SwiGLU sublayer. The loops below take it as ``ffn``; the
    MoE family (``models/moe.py``) runs them with its routed one."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(h, p["wg"], p["wu"], p["wd"], qm, bg=p.get("bg"),
                         bu=p.get("bu"), bd=p.get("bd"))


# ---------------------------------------------------------------------------
# Forward / caches / prefill / decode, contiguous and paged
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ArchConfig, inputs):
    """Tokens (..., S) through the embedding table, or — the stub-frontend
    families — (..., S, d) embeddings as given, through the folded T1
    (``x @ a + v``) once PTQ has left one in ``params``."""
    if cfg.embed_inputs:
        return pctx.shard(embed_lookup(params["embed"], inputs), "batch", None,
                          None)
    if "input_transform" in params:
        t = params["input_transform"]
        return pctx.shard(inputs @ t["a"].to(inputs.dtype)
                          + t["v"].to(inputs.dtype), "batch", None, None)
    return pctx.shard(inputs, "batch", None, None)


def forward(params, cfg: ArchConfig, inputs,
            qm: QuantMode = QuantMode.off(), ffn=ffn_sublayer):
    """inputs (B, S) int tokens or (B, S, d) embeddings -> logits (B, S,
    V). Under autograd with ``cfg.remat`` each block is recomputed in the
    backward (``torch.utils.checkpoint``), as the JAX package's
    ``jax.checkpoint`` of its scan body."""
    x = embed_inputs(params, cfg, inputs)
    pos = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()

    def block(x, p):
        # a sequence-parallel residual (split over "seq" between blocks)
        # is gathered at the block's entry, so the block computes on
        # whole rows
        x = pctx.shard(x, "batch", None, None)
        x, _, _ = attn_sublayer(x, p, cfg, qm, pos, window=cfg.window)
        return pctx.shard(ffn(x, p, cfg, qm), "batch", "seq", None)

    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        if remat:
            x = _ckpt.checkpoint(block, x, p, use_reentrant=False)
        else:
            x = block(x, p)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return pctx.shard(head_out(x, params, cfg, qm), "batch", None, "model")


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, kv_quant=None, device=None):
    """The contiguous decode cache, (L, batch, max_len, kv_dim) per K and
    V: ``PackedKV`` when ``kv_quant`` is given, dense ``dtype`` otherwise.
    ``device`` None means the CUDA card."""
    dev = devices.resolve(device)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_dim)
    if kv_quant is not None:
        return {"k": PackedKV.zeros(shape, kv_quant.fmt, dtype, dev),
                "v": PackedKV.zeros(shape, kv_quant.fmt, dtype, dev)}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def init_cache_paged(cfg: ArchConfig, n_pages: int, page_size: int,
                     dtype=torch.float32, kv_quant=None, device=None):
    """A paged KV pool of N pages of P tokens per layer; MX-packed (codes +
    E8M0 bytes) when ``kv_quant`` is given, dense ``dtype`` otherwise.
    ``device`` None means the CUDA card."""
    dev = devices.resolve(device)
    fmt = kv_quant.fmt if kv_quant is not None else "none"
    shape = (cfg.n_layers, n_pages, page_size, cfg.kv_dim)
    return {"k": PagedKV.zeros(shape, fmt, dtype, dev),
            "v": PagedKV.zeros(shape, fmt, dtype, dev)}


def prefill(params, cfg: ArchConfig, inputs, qm: QuantMode = QuantMode.off(),
            max_len: int | None = None, kv_quant=None, ffn=ffn_sublayer):
    """Run the prompt (B, S) at positions 0..S-1 and return (last-position
    logits (B, V), cache). ``max_len`` sizes the cache for the decode steps
    that follow (rows past S are zeros); ``kv_quant`` stores it MX-packed —
    ``PackedKV.from_dense`` of the padded cache, so the prompt attends its
    own dense k/v and quantization applies to what decode reads back."""
    x = embed_inputs(params, cfg, inputs)
    B, S = x.shape[0], x.shape[1]
    pos = torch.arange(S, device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        x, k, v = attn_sublayer(x, p, cfg, qm, pos, window=cfg.window)
        x = pctx.shard(ffn(x, p, cfg, qm), "batch", "seq", None)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    logits = head_out(x[:, 0], params, cfg, qm)
    ks, vs = torch.stack(ks), torch.stack(vs)
    if max_len is not None and max_len > S:
        pad = ks.new_zeros((cfg.n_layers, B, max_len - S, cfg.kv_dim))
        ks = torch.cat([ks, pad], dim=2)
        vs = torch.cat([vs, pad], dim=2)
    if kv_quant is not None:
        ks = kv_pack(ks, kv_quant.fmt, lanes=1)
        vs = kv_pack(vs, kv_quant.fmt, lanes=1)
    return logits, {"k": shard_kv(ks, None, "batch", None, "model"),
                    "v": shard_kv(vs, None, "batch", None, "model")}


def prefill_chunk(params, cfg: ArchConfig, cache, inputs, start: int,
                  last_idx: int, qm: QuantMode = QuantMode.off(),
                  ffn=ffn_sublayer):
    """Chunked prefill against the contiguous cache: C tokens (B, C) at
    positions start..start+C-1, written at those rows of every lane;
    ``last_idx`` is the index within the chunk of the last real prompt
    token (trailing pads write rows that stay masked until decode
    overwrites them). Returns (logits (B, V) at last_idx, cache)."""
    x = embed_inputs(params, cfg, inputs)
    C = x.shape[1]
    pos = start + torch.arange(C, device=x.device)
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        x, _, _ = attn_sublayer_chunk(x, p, cfg, qm, cache["k"][i],
                                      cache["v"][i], pos, start + C,
                                      window=cfg.window)
        x = ffn(x, p, cfg, qm)
    xl = rms_norm(x[:, last_idx:last_idx + 1], params["ln_f"], cfg.norm_eps)
    return head_out(xl[:, 0], params, cfg, qm), cache


def decode(params, cfg: ArchConfig, cache, inputs, cur_len,
           qm: QuantMode = QuantMode.off(), ffn=ffn_sublayer):
    """One decode step over the contiguous cache. inputs (B,) tokens;
    cur_len the cache fill — an int shared by the lanes (wave scheduler) or
    a (B,) tensor of per-lane fills (continuous scheduler). A stub-frontend
    family takes (B, d) embeddings, cast to the cache's dtype as the JAX
    package casts them. Returns (logits (B, V), cache)."""
    x = embed_inputs(params, cfg, inputs[:, None])
    if not cfg.embed_inputs:
        ck = cache["k"]
        x = x.to(getattr(torch, ck.dtype) if isinstance(ck, PackedKV)
                 else ck.dtype)
    x = shard_batch(x, None, None)
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        x, _, _ = attn_sublayer_decode(x, p, cfg, qm, cache["k"][i],
                                       cache["v"][i], cur_len,
                                       window=cfg.window)
        x = ffn(x, p, cfg, qm)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return head_out(x[:, 0], params, cfg, qm), cache


def prefill_chunk_paged(params, cfg: ArchConfig, cache, block_tables,
                        inputs, start, last_idx,
                        qm: QuantMode = QuantMode.off(), ffn=ffn_sublayer):
    """Chunked prefill against a paged pool: C tokens per lane at positions
    start..start+C-1, written through ``block_tables`` (B, maxp). ``start``
    and ``last_idx`` (index within the chunk of the last real token) are
    ints shared by the lanes or (B,) per-lane tensors. Returns (logits
    (B, V) at last_idx, cache)."""
    x = embed_inputs(params, cfg, inputs)
    dev = x.device
    C = x.shape[1]
    st = torch.as_tensor(start, device=dev).long()
    ar = torch.arange(C, device=dev)
    pos = st[:, None] + ar[None, :] if st.ndim == 1 else st + ar
    bt = torch.as_tensor(block_tables, device=dev).to(torch.int32)
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        x, _, _ = attn_sublayer_chunk_paged(
            x, p, cfg, qm, cache["k"][i], cache["v"][i], bt, pos, st + C,
            window=cfg.window)
        x = ffn(x, p, cfg, qm)
    li = torch.as_tensor(last_idx, device=dev).long()
    if li.ndim == 1:
        xl = torch.take_along_dim(x, li[:, None, None], dim=1)
    else:
        xl = x[:, li][:, None]
    xl = rms_norm(xl, params["ln_f"], cfg.norm_eps)
    return head_out(xl[:, 0], params, cfg, qm), cache


def decode_paged(params, cfg: ArchConfig, cache, inputs, cur_len,
                 block_tables, qm: QuantMode = QuantMode.off(),
                 ffn=ffn_sublayer):
    """One decode step over a paged pool. inputs (B,) tokens; cur_len (B,)
    per-lane fills; block_tables (B, maxp). Returns (logits (B, V),
    cache)."""
    x = shard_batch(embed_inputs(params, cfg, inputs[:, None]), None, None)
    bt = torch.as_tensor(block_tables, device=x.device).to(torch.int32)
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        x, _, _ = attn_sublayer_decode_paged(
            x, p, cfg, qm, cache["k"][i], cache["v"][i], bt, cur_len,
            window=cfg.window)
        x = ffn(x, p, cfg, qm)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return head_out(x[:, 0], params, cfg, qm), cache


def verify(params, cfg: ArchConfig, cache, inputs, pos, n_valid,
           qm: QuantMode = QuantMode.off(), ffn=ffn_sublayer):
    """Speculative verify step over the contiguous cache. inputs (B, C)
    tokens — each lane's current token followed by C - 1 drafts; pos (B,)
    each lane's next cache row; n_valid (B,) its real token count (1 +
    drafts; 0 idles the lane, which then writes nothing). ``pos`` and
    ``n_valid`` may be host tensors (no device sync). Returns (logits
    (B, C, V), cache): logits[:, j] follows input token j, as a sequential
    :func:`decode` of the same tokens would."""
    x = embed_inputs(params, cfg, inputs)
    C = x.shape[1]
    cl = torch.as_tensor(pos).long()
    nv = torch.as_tensor(n_valid, device=cl.device).long()
    slots = tuple(t.to(x.device)
                  for t in spec_slots(cl, nv, C, cache["k"].shape[2]))
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        x, _, _ = attn_sublayer_verify(x, p, cfg, qm, cache["k"][i],
                                       cache["v"][i], cl, nv, slots,
                                       window=cfg.window)
        x = ffn(x, p, cfg, qm)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return head_out(x, params, cfg, qm), cache


def verify_paged(params, cfg: ArchConfig, cache, inputs, pos, n_valid,
                 block_tables, qm: QuantMode = QuantMode.off(),
                 ffn=ffn_sublayer):
    """Speculative verify step over a paged pool — the contract of
    :func:`verify` with rows resolved through ``block_tables`` (B, maxp).
    The engine reserves every page a request can reach at admission, so a
    rejected draft rolls back by rewinding the lane's position: its stale
    rows stay masked until a later step overwrites them."""
    x = embed_inputs(params, cfg, inputs)
    C = x.shape[1]
    cl = torch.as_tensor(pos).long()
    nv = torch.as_tensor(n_valid, device=cl.device).long()
    slots = tuple(t.to(x.device) for t in spec_slots(cl, nv, C))
    bt = torch.as_tensor(block_tables, device=x.device).to(torch.int32)
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        x, _, _ = attn_sublayer_verify_paged(
            x, p, cfg, qm, cache["k"][i], cache["v"][i], bt, cl, nv, slots,
            window=cfg.window)
        x = ffn(x, p, cfg, qm)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return head_out(x, params, cfg, qm), cache


# ---------------------------------------------------------------------------
# PTQ integration: norm folding + transform folding (Appendix C)
# ---------------------------------------------------------------------------

def fold_norms(params, cfg: ArchConfig):
    """Fold the RMSNorm γ's into the adjacent linears (exact). The head
    becomes its own leaf (a tied head is untied)."""
    p = dict(params)
    b = dict(p["blocks"])
    b["ln1"], (b["wq"], b["wk"], b["wv"]) = fold_lib.fold_norm_into(
        b["ln1"], b["wq"], b["wk"], b["wv"])
    b["ln2"], (b["wg"], b["wu"]) = fold_lib.fold_norm_into(
        b["ln2"], b["wg"], b["wu"])
    p["ln_f"], (p["head"],) = fold_lib.fold_norm_into(
        p["ln_f"], head_matrix(params, cfg))
    p["blocks"] = b
    return p


def fold(params, cfg: ArchConfig, tset: fold_lib.TransformSet):
    """Fold T1/T2 (and the T3 inverse) into the weights; differentiable —
    the LATMiX student runs this inside its loss. Requires
    :func:`fold_norms` first. Every linear but ``wd`` gains a bias, and the
    head gains ``bhead``. T1 folds into the embedding table, or — the
    stub-frontend families — stays as ``input_transform`` ({"a": A1, "v":
    v1}), applied to the embeddings the front end gives."""
    p = dict(params)
    b = dict(p["blocks"])
    a1i = tset.a1_inv
    a2i = tset.a2_inv()
    b["wq"], b["bq"] = fold_lib.fold_read(b["wq"], b.get("bq"), a1i, tset.v1)
    b["wk"], b["bk"] = fold_lib.fold_read(b["wk"], b.get("bk"), a1i, tset.v1)
    bv = b.get("bv")
    if bv is None:
        bv = torch.zeros_like(b["wk"][..., 0, :])
    b["wv"], b["bv"] = fold_lib.fold_value(b["wv"], bv, a1i, tset.v1,
                                           tset.a2, tset.v2, cfg.n_kv_heads)
    b["wo"], b["bo"] = fold_lib.fold_attn_out(b["wo"], None, tset.a1, a2i,
                                              tset.v2, cfg.n_heads)
    b["wg"], b["bg"] = fold_lib.fold_read(b["wg"], None, a1i, tset.v1)
    b["wu"], b["bu"] = fold_lib.fold_read(b["wu"], None, a1i, tset.v1)
    wd, _ = fold_lib.fold_write(b["wd"], None, tset.a1)
    if tset.t3_block:
        wd = fold_lib.fold_t3(wd, tset.t3_block)
    b["wd"] = wd
    if cfg.embed_inputs:
        p["embed"] = fold_lib.fold_embed(p["embed"], tset.a1, tset.v1)
    else:
        p["input_transform"] = {"a": tset.a1, "v": tset.v1}
    p["head"], p["bhead"] = fold_lib.fold_read(head_matrix(params, cfg), None,
                                               a1i, tset.v1)
    p["blocks"] = b
    return p
