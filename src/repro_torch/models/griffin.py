"""Griffin / RecurrentGemma hybrid — the port of ``repro.models.griffin``:
RG-LRU recurrent blocks and local (MQA) attention in a (rec, rec, attn)
pattern, each followed by a GeGLU MLP.

26 layers = 8 super-blocks of (rec, rec, attn) + 2 trailing recurrent
layers. RG-LRU:

    r_t = σ(w_a ⊙ u_t + b_a);  i_t = σ(w_x ⊙ u_t + b_x)
    log a_t = −c · softplus(Λ) · r_t           (c = 8)
    h_t = a_t h_{t−1} + √(1 − a_t²) · (i_t ⊙ u_t)

over the sequence by :func:`associative_scan`, the log-depth recursion of
``jax.lax.associative_scan`` (the same association order, so the same
sums). Decode keeps a ring-buffer KV cache of the window's size for the
attention layers (slot = position % A, attended through explicit key
positions, so a packed ring never reaches the flash-decode kernel) and
O(1) recurrent state for the RG-LRU layers.

Parameters are the JAX package's tree: ``super/{r1, r2, at}`` stacked over
the super-blocks, ``tail`` over the trailing recurrent layers. The cache
is ``{"attn_k", "attn_v"}`` (ns, B, A, kv_dim) dense or ``PackedKV``,
``rec_h`` (ns, 2, B, lru) f32, ``rec_conv`` (ns, 2, B, lru, K-1), and
``tail_h`` / ``tail_conv`` for the tail; decode updates it in place.
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
from repro_torch.kernels.packing import PackedKV, torch_dtype
from repro_torch.launch import pcontext as pctx

from .layers import (attention, causal_conv1d, conv1d_step, dense_init,
                     embed_lookup, flash_attention, gated_mlp, kv_heads_view,
                     kv_pack, kv_write_slice, merge_heads, qlinear,
                     rms_norm, softplus, split_heads)
from .transformer import _layer, _qkv, head_matrix, head_out

C_RGLRU = 8.0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _rec_layer(gen, cfg: ArchConfig, dtype, device):
    d, lru, K = cfg.d_model, cfg.lru_width, cfg.conv_kernel
    out_scale = 1.0 / math.sqrt(2.0 * cfg.n_layers)
    # Λ such that a^(c·r) with r ≈ 0.5 sits in [0.9, 0.999]
    a0 = 0.9 + 0.099 * torch.rand((lru,), generator=gen, device=device)
    lam = torch.log(torch.expm1(-torch.log(a0) / (C_RGLRU * 0.5)))

    def full(shape, v, dt=dtype):
        return torch.full(shape, v, dtype=dt, device=device)

    return {
        "ln1": full((d,), 1.0),
        "wx": dense_init(gen, d, lru, dtype, device=device),
        "wy": dense_init(gen, d, lru, dtype, device=device),
        "conv_w": (torch.randn((lru, K), generator=gen, device=device)
                   * 0.1).to(dtype),
        "conv_b": full((lru,), 0.0),
        "lam": lam.float(),
        "ga_w": full((lru,), 1.0, torch.float32),
        "ga_b": full((lru,), 0.0, torch.float32),
        "gx_w": full((lru,), 1.0, torch.float32),
        "gx_b": full((lru,), 0.0, torch.float32),
        "wor": dense_init(gen, lru, d, dtype, out_scale, device),
        "ln2": full((d,), 1.0),
        "wg": dense_init(gen, d, cfg.d_ff, dtype, device=device),
        "wu": dense_init(gen, d, cfg.d_ff, dtype, device=device),
        "wd": dense_init(gen, cfg.d_ff, d, dtype, out_scale, device),
    }


def _attn_layer(gen, cfg: ArchConfig, dtype, device):
    d = cfg.d_model
    out_scale = 1.0 / math.sqrt(2.0 * cfg.n_layers)
    ones = torch.ones((d,), dtype=dtype, device=device)
    return {
        "ln1": ones,
        "wq": dense_init(gen, d, cfg.q_dim, dtype, device=device),
        "wk": dense_init(gen, d, cfg.kv_dim, dtype, device=device),
        "wv": dense_init(gen, d, cfg.kv_dim, dtype, device=device),
        "wo": dense_init(gen, cfg.q_dim, d, dtype, out_scale, device),
        "ln2": ones.clone(),
        "wg": dense_init(gen, d, cfg.d_ff, dtype, device=device),
        "wu": dense_init(gen, d, cfg.d_ff, dtype, device=device),
        "wd": dense_init(gen, cfg.d_ff, d, dtype, out_scale, device),
    }


def _stack(maker, gen, n, cfg, dtype, device, place=lambda name, t: t):
    layers = [maker(gen, cfg, dtype, device) for _ in range(n)]
    return {k: place(k, torch.stack([lyr.pop(k) for lyr in layers]))
            for k in list(layers[0])}


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None, place=lambda name, t: t):
    """Seeded random parameters at ``cfg``'s widths (the JAX package's
    layout and scales; ``torch.Generator`` draws, so the values differ);
    ``place`` as :func:`repro_torch.models.api.init` takes it (a sub-layer
    kind's layers are drawn whole, then laid out leaf by leaf)."""
    device = gen.device if device is None else device
    ns, nt = cfg.n_super_blocks, cfg.n_tail_rec
    stack = lambda maker, n: _stack(maker, gen, n, cfg, dtype, device, place)
    params = {
        "super": {"r1": stack(_rec_layer, ns), "r2": stack(_rec_layer, ns),
                  "at": stack(_attn_layer, ns)},
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "embed": place("embed", (torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=gen, device=device)
            * 0.02).to(dtype)),
    }
    if not cfg.tie_embeddings:
        params["head"] = place("head", dense_init(
            gen, cfg.d_model, cfg.vocab_size, dtype, device=device))
    if nt:
        params["tail"] = stack(_rec_layer, nt)
    return params


# ---------------------------------------------------------------------------
# RG-LRU sublayer
# ---------------------------------------------------------------------------

def _combine(a1, b1, a2, b2):
    """The linear recurrence's operator: (a1, b1) then (a2, b2)."""
    return a1 * a2, b1 * a2 + b2


def _interleave(e, o):
    """e[0], o[0], e[1], o[1], ... along axis 1 (len(e) - len(o) is 0 or
    1)."""
    n = o.shape[1]
    out = torch.stack([e[:, :n], o], dim=2).flatten(1, 2)
    return out if e.shape[1] == n else torch.cat([out, e[:, n:]], dim=1)


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 (from h = 0),
    as the pair (prod a, h). The recursion of ``jax.lax.associative_scan``:
    combine adjacent pairs, scan the half-length sequence (the odd
    results), then combine each odd result with the next even element — so
    every output is the same tree of products and sums, in log-depth of S
    launches."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2],
                      b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rglru_gates(u, p):
    uf = u.float()
    r = torch.sigmoid(uf * p["ga_w"] + p["ga_b"])
    i = torch.sigmoid(uf * p["gx_w"] + p["gx_b"])
    log_a = -C_RGLRU * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * (i * uf)


def _gelu(x):
    return F.gelu(x.float(), approximate="tanh")


def rec_sublayer(x, p, cfg: ArchConfig, qm: QuantMode):
    """x (B, S, d). Returns (x', (h_last (B, lru) f32, conv_tail (B, lru,
    K-1)))."""
    K = cfg.conv_kernel
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    u = qlinear(h, p["wx"], p.get("bx"), qm, "rec_in")
    gate = _gelu(qlinear(h, p["wy"], p.get("by"), qm, "rec_in"))
    conv_tail = u[:, -(K - 1):, :].transpose(1, 2)

    def recur(u, conv_w, conv_b, ga_w, ga_b, gx_w, gx_b, lam):
        # the conv and the RG-LRU act channel by channel: under a mesh
        # each rank runs its lanes and its "model" share of the channels
        u = causal_conv1d(u, conv_w, conv_b)
        a, b = _rglru_gates(u, {"ga_w": ga_w, "ga_b": ga_b, "gx_w": gx_w,
                                "gx_b": gx_b, "lam": lam})
        return associative_scan(a, b)[1]
    # the channels follow the conv weight's layout (split over "model"
    # under tensor parallelism, whole where the weights are)
    split = pctx.is_dtensor(p["conv_w"]) and any(
        q.is_shard() for q in p["conv_w"].placements)
    ch = ("model" if split else None,)
    hs = pctx.local(recur, (u, p["conv_w"], p["conv_b"], p["ga_w"],
                            p["ga_b"], p["gx_w"], p["gx_b"], p["lam"]),
                    (("batch", None) + ch, ch + (None,)) + (ch,) * 6)
    out = (hs * gate).to(x.dtype)
    out = qlinear(out, p["wor"], p.get("bor"), qm, "rec_out")
    return x + out, (hs[:, -1], conv_tail)


def rec_sublayer_decode(x, p, cfg: ArchConfig, qm: QuantMode, h_state,
                        conv_state):
    """x (B, 1, d); h_state (B, lru) f32; conv_state (B, lru, K-1).
    Returns (x', h_new, conv_state')."""
    h = rms_norm(x[:, 0], p["ln1"], cfg.norm_eps)
    u = qlinear(h, p["wx"], p.get("bx"), qm, "rec_in")
    gate = _gelu(qlinear(h, p["wy"], p.get("by"), qm, "rec_in"))
    u, conv_state = conv1d_step(conv_state, u, p["conv_w"], p["conv_b"])
    a, b = _rglru_gates(u, p)
    h_new = a * h_state + b
    out = (h_new * gate).to(x.dtype)
    out = qlinear(out, p["wor"], p.get("bor"), qm, "rec_out")
    return x + out[:, None, :], h_new, conv_state


def mlp_sublayer(x, p, cfg: ArchConfig, qm: QuantMode):
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(h, p["wg"], p["wu"], p["wd"], qm, act="gelu",
                         bg=p.get("bg"), bu=p.get("bu"))


# ---------------------------------------------------------------------------
# Local attention sublayer (MQA, windowed): full sequence and ring decode
# ---------------------------------------------------------------------------

def attn_sublayer(x, p, cfg: ArchConfig, qm: QuantMode, pos):
    """Full-sequence windowed attention through :func:`flash_attention`.
    Returns (x', k (B, S, kv_dim) after RoPE, v)."""
    B, S, _ = x.shape
    q, k, v = _qkv(x, p, cfg, qm, pos)
    out = flash_attention(q, split_heads(k, cfg.n_kv_heads, cfg.head_dim),
                          split_heads(v, cfg.n_kv_heads, cfg.head_dim),
                          causal=True, window=cfg.window,
                          chunk=cfg.attn_chunk)
    out = qlinear(merge_heads(out), p["wo"], p.get("bo"), qm, "attn_out")
    return x + out, k, v


def ring_positions(cur_len: int, A: int, device) -> torch.Tensor:
    """The absolute position slot s of an A-slot ring holds once position
    ``cur_len`` is written: cur_len - ((cur_len - s) mod A), or -1 (never
    written)."""
    s = torch.arange(A, device=device)
    kp = cur_len - torch.remainder(cur_len - s, A)
    return torch.where(kp >= 0, kp, torch.full_like(kp, -1))


def attn_sublayer_decode(x, p, cfg: ArchConfig, qm: QuantMode, ck, cv,
                         cur_len: int):
    """Ring-buffer decode. ck/cv (B, A, kv_dim) dense or ``PackedKV``
    (quantized on append), written in place at slot cur_len % A; attention
    reads the ring through its explicit key positions."""
    B = x.shape[0]
    A = ck.shape[1]
    pos = torch.full((1,), cur_len, dtype=torch.long, device=x.device)
    q, k, v = _qkv(x, p, cfg, qm, pos)
    slot = cur_len % A
    kv_write_slice(ck, k, slot)
    kv_write_slice(cv, v, slot)
    out = attention(q, kv_heads_view(ck, cfg.n_kv_heads, cfg.head_dim),
                    kv_heads_view(cv, cfg.n_kv_heads, cfg.head_dim),
                    causal=True, q_pos=pos, window=cfg.window,
                    k_positions=ring_positions(cur_len, A, x.device),
                    chunk=cfg.attn_chunk, backend=qm.backend)
    out = qlinear(out.reshape(B, 1, cfg.q_dim), p["wo"], p.get("bo"), qm,
                  "attn_out")
    return x + out


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------

def _super_fwd(x, pl, cfg, qm, pos):
    x, _ = rec_sublayer(x, pl["r1"], cfg, qm)
    x = mlp_sublayer(x, pl["r1"], cfg, qm)
    x, _ = rec_sublayer(x, pl["r2"], cfg, qm)
    x = mlp_sublayer(x, pl["r2"], cfg, qm)
    x, _, _ = attn_sublayer(x, pl["at"], cfg, qm, pos)
    return mlp_sublayer(x, pl["at"], cfg, qm)


def _tail_fwd(x, pl, cfg, qm):
    x, _ = rec_sublayer(x, pl, cfg, qm)
    return mlp_sublayer(x, pl, cfg, qm)


def _super(params, i: int) -> dict:
    return {n: _layer(params["super"][n], i) for n in ("r1", "r2", "at")}


def forward(params, cfg: ArchConfig, inputs,
            qm: QuantMode = QuantMode.off()):
    """inputs (B, S) tokens -> logits (B, S, V). Under autograd with
    ``cfg.remat`` each super-block (and each tail layer) is recomputed in
    the backward, as the JAX package's ``jax.checkpoint`` of its scan
    body."""
    x = pctx.shard(embed_lookup(params["embed"], inputs), "batch", None, None)
    pos = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, *args):
        if remat:
            return _ckpt.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    for i in range(cfg.n_super_blocks):
        # a sequence-parallel residual is gathered at the block's entry
        x = run(lambda x, pl: _super_fwd(pctx.shard(x, "batch", None, None),
                                         pl, cfg, qm, pos), x,
                _super(params, i))
        x = pctx.shard(x, "batch", "seq", None)
    for i in range(cfg.n_tail_rec):
        x = run(lambda x, pl: _tail_fwd(pctx.shard(x, "batch", None, None),
                                        pl, cfg, qm), x,
                _layer(params["tail"], i))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return head_out(x, params, cfg, qm)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, kv_quant=None, device=None):
    """An empty decode cache: the ring of min(max_len, window) slots per
    attention layer (``PackedKV`` when ``kv_quant`` is given) and zero
    recurrent state. ``device`` None means the CUDA card."""
    dev = devices.resolve(device)
    ns, nt = cfg.n_super_blocks, cfg.n_tail_rec
    A = min(max_len, cfg.window)
    lru, K = cfg.lru_width, cfg.conv_kernel
    kv_shape = (ns, batch, A, cfg.kv_dim)
    if kv_quant is not None:
        ck = PackedKV.zeros(kv_shape, kv_quant.fmt, dtype, dev)
        cv = PackedKV.zeros(kv_shape, kv_quant.fmt, dtype, dev)
    else:
        ck = torch.zeros(kv_shape, dtype=dtype, device=dev)
        cv = torch.zeros(kv_shape, dtype=dtype, device=dev)
    cache = {"attn_k": ck, "attn_v": cv,
             "rec_h": torch.zeros((ns, 2, batch, lru), device=dev),
             "rec_conv": torch.zeros((ns, 2, batch, lru, K - 1),
                                     dtype=dtype, device=dev)}
    if nt:
        cache["tail_h"] = torch.zeros((nt, batch, lru), device=dev)
        cache["tail_conv"] = torch.zeros((nt, batch, lru, K - 1),
                                         dtype=dtype, device=dev)
    return cache


def prefill(params, cfg: ArchConfig, inputs, qm: QuantMode = QuantMode.off(),
            max_len: int | None = None, kv_quant=None):
    """Run the prompt (B, S) and return (last-position logits (B, V),
    cache). The ring holds min(max(S, max_len), window) slots; the last
    min(S, A) keys are packed at slot = position % A, the rest stay zero
    (never-written slots are masked by their negative position)."""
    x = pctx.shard(embed_lookup(params["embed"], inputs), "batch", None, None)
    B, S = x.shape[0], x.shape[1]
    dev = x.device
    pos = torch.arange(S, device=dev)
    A = min(max(S, max_len or S), cfg.window)
    W = min(S, A)
    slots = torch.arange(S - W, S, device=dev) % A

    def ring(t):
        # the last W keys at slot = position % A (each rank its lanes)
        out = t.new_zeros((t.shape[0], A, t.shape[2]))
        out[:, slots] = t[:, S - W:]
        return out
    cks, cvs, hs, cs = [], [], [], []
    for i in range(cfg.n_super_blocks):
        pl = _super(params, i)
        x, (h1, c1) = rec_sublayer(x, pl["r1"], cfg, qm)
        x = mlp_sublayer(x, pl["r1"], cfg, qm)
        x, (h2, c2) = rec_sublayer(x, pl["r2"], cfg, qm)
        x = mlp_sublayer(x, pl["r2"], cfg, qm)
        x, k, v = attn_sublayer(x, pl["at"], cfg, qm, pos)
        x = mlp_sublayer(x, pl["at"], cfg, qm)
        x = pctx.shard(x, "batch", "seq", None)
        ck, cv = pctx.local(lambda k, v: (ring(k), ring(v)), (k, v),
                            (("batch", None, None),) * 2, out_like=(0, 1))
        x = pctx.shard(x, "batch", None, None)
        cks.append(ck)
        cvs.append(cv)
        hs.append(torch.stack([h1, h2]))
        cs.append(torch.stack([c1, c2]))
    ck, cv = torch.stack(cks), torch.stack(cvs)
    if kv_quant is not None:
        ck = kv_pack(ck, kv_quant.fmt, lanes=1)
        cv = kv_pack(cv, kv_quant.fmt, lanes=1)
    cache = {"attn_k": ck, "attn_v": cv,
             "rec_h": torch.stack(hs).float(), "rec_conv": torch.stack(cs)}
    if cfg.n_tail_rec:
        th, tc = [], []
        for i in range(cfg.n_tail_rec):
            x, (h, c) = rec_sublayer(x, _layer(params["tail"], i), cfg, qm)
            x = mlp_sublayer(x, _layer(params["tail"], i), cfg, qm)
            th.append(h)
            tc.append(c)
        cache["tail_h"] = torch.stack(th).float()
        cache["tail_conv"] = torch.stack(tc)
    x = rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return head_out(x[:, 0], params, cfg, qm), cache


def decode(params, cfg: ArchConfig, cache, inputs, cur_len,
           qm: QuantMode = QuantMode.off()):
    """One decode step at the position ``cur_len`` shared by the lanes (the
    wave scheduler's; the recurrent families take no per-lane fills).
    inputs (B,) tokens. Returns (logits (B, V), cache), the cache updated
    in place."""
    cl = int(cur_len)
    ck = cache["attn_k"]
    dt = torch_dtype(ck.dtype) if isinstance(ck, PackedKV) else ck.dtype
    x = pctx.shard(embed_lookup(params["embed"], inputs[:, None]).to(dt),
                   "batch", None, None)
    hs, cs = cache["rec_h"], cache["rec_conv"]
    for i in range(cfg.n_super_blocks):
        pl = _super(params, i)
        for j, name in enumerate(("r1", "r2")):
            x, h, c = rec_sublayer_decode(x, pl[name], cfg, qm, hs[i, j],
                                          cs[i, j])
            hs[i, j], cs[i, j] = h, c
            x = mlp_sublayer(x, pl[name], cfg, qm)
        x = attn_sublayer_decode(x, pl["at"], cfg, qm, cache["attn_k"][i],
                                 cache["attn_v"][i], cl)
        x = mlp_sublayer(x, pl["at"], cfg, qm)
    for i in range(cfg.n_tail_rec):
        pl = _layer(params["tail"], i)
        x, h, c = rec_sublayer_decode(x, pl, cfg, qm, cache["tail_h"][i],
                                      cache["tail_conv"][i])
        cache["tail_h"][i], cache["tail_conv"][i] = h, c
        x = mlp_sublayer(x, pl, cfg, qm)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return head_out(x[:, 0], params, cfg, qm), cache


# ---------------------------------------------------------------------------
# PTQ integration
# ---------------------------------------------------------------------------

def _fold_norms_rec(p):
    p = dict(p)
    p["ln1"], (p["wx"], p["wy"]) = fold_lib.fold_norm_into(
        p["ln1"], p["wx"], p["wy"])
    p["ln2"], (p["wg"], p["wu"]) = fold_lib.fold_norm_into(
        p["ln2"], p["wg"], p["wu"])
    return p


def _fold_norms_attn(p):
    p = dict(p)
    p["ln1"], (p["wq"], p["wk"], p["wv"]) = fold_lib.fold_norm_into(
        p["ln1"], p["wq"], p["wk"], p["wv"])
    p["ln2"], (p["wg"], p["wu"]) = fold_lib.fold_norm_into(
        p["ln2"], p["wg"], p["wu"])
    return p


def fold_norms(params, cfg: ArchConfig):
    """Fold every RMSNorm γ into the linears it feeds (exact); the head
    becomes its own leaf."""
    p = dict(params)
    sup = dict(p["super"])
    sup["r1"] = _fold_norms_rec(sup["r1"])
    sup["r2"] = _fold_norms_rec(sup["r2"])
    sup["at"] = _fold_norms_attn(sup["at"])
    p["super"] = sup
    if "tail" in p:
        p["tail"] = _fold_norms_rec(p["tail"])
    p["ln_f"], (p["head"],) = fold_lib.fold_norm_into(p["ln_f"],
                                                       head_matrix(p, cfg))
    return p


def _fold_mlp(p, a1, a1i, v1, t3_block):
    p["wg"], p["bg"] = fold_lib.fold_read(p["wg"], None, a1i, v1)
    p["wu"], p["bu"] = fold_lib.fold_read(p["wu"], None, a1i, v1)
    wd, _ = fold_lib.fold_write(p["wd"], None, a1)
    if t3_block:
        wd = fold_lib.fold_t3(wd, t3_block)
    p["wd"] = wd
    return p


def _fold_rec(p, a1, a1i, v1, t3_block):
    p = dict(p)
    p["wx"], p["bx"] = fold_lib.fold_read(p["wx"], None, a1i, v1)
    p["wy"], p["by"] = fold_lib.fold_read(p["wy"], None, a1i, v1)
    p["wor"], p["bor"] = fold_lib.fold_write(
        p["wor"], torch.zeros_like(p["wor"][..., 0, :]), a1)
    return _fold_mlp(p, a1, a1i, v1, t3_block)


def _fold_attn(p, cfg, tset, a1i, a2i):
    p = dict(p)
    p["wq"], p["bq"] = fold_lib.fold_read(p["wq"], None, a1i, tset.v1)
    p["wk"], p["bk"] = fold_lib.fold_read(p["wk"], None, a1i, tset.v1)
    p["wv"], p["bv"] = fold_lib.fold_value(
        p["wv"], torch.zeros_like(p["wk"][..., 0, :]), a1i, tset.v1,
        tset.a2, tset.v2, cfg.n_kv_heads)
    p["wo"], p["bo"] = fold_lib.fold_attn_out(p["wo"], None, tset.a1, a2i,
                                              tset.v2, cfg.n_heads)
    return _fold_mlp(p, tset.a1, a1i, tset.v1, tset.t3_block)


def fold(params, cfg: ArchConfig, tset: fold_lib.TransformSet):
    """T1 everywhere; T2 on the attention layers (``a2`` stacked over the
    super-blocks). Differentiable; requires :func:`fold_norms` first."""
    p = dict(params)
    a1i = tset.a1_inv
    sup = dict(p["super"])
    for n in ("r1", "r2"):
        sup[n] = _fold_rec(sup[n], tset.a1, a1i, tset.v1, tset.t3_block)
    sup["at"] = _fold_attn(sup["at"], cfg, tset, a1i, tset.a2_inv())
    p["super"] = sup
    if "tail" in p:
        p["tail"] = _fold_rec(p["tail"], tset.a1, a1i, tset.v1,
                              tset.t3_block)
    head0 = head_matrix(p, cfg)
    p["embed"] = fold_lib.fold_embed(p["embed"], tset.a1, tset.v1)
    p["head"], p["bhead"] = fold_lib.fold_read(head0, None, a1i, tset.v1)
    return p
