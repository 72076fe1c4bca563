"""Mixture-of-Experts transformer (Qwen1.5-MoE / Moonlight style) — the
port of ``repro.models.moe``: GQA attention + top-k routed experts with
capacity-based dispatch and optional shared experts.

Routing is grouped (``cfg.moe_groups``): the T tokens split into G groups,
each with its own capacity buffer. Dispatch and combine are static-shaped
gathers (capacity-dropped overflow), and the experts run as expert-batched
``qeinsum`` calls: under the fused backend one packed GEMM launch covers all
E experts. The attention sublayers, caches and serving loops are the dense
family's (``transformer``), run with this family's FFN.

Three places keep the JAX package's arithmetic where PyTorch's defaults
would not: the top-k order among equal probabilities (lower index first, as
``jax.lax.top_k``), the combine (a token's K contributions added in slot
order from zero, as the JAX scatter-add sums them, by gathers rather than
atomics, so the card repeats a step bit for bit), and the dispatch (a token
dropped by capacity contributes nothing, as the reference's clipped slot
times zero).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import folding as fold_lib
from repro_torch.core.quantize import QuantMode, qeinsum
from repro_torch.launch import pcontext as pctx

from . import transformer as dense
from .layers import gated_mlp, qlinear, rms_norm


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None, place=lambda name, t: t):
    """Seeded random parameters at ``cfg``'s widths: the dense family's
    attention, embeddings and norms, with the dense FFN replaced by a
    router (L, d, E), experts ``eg``/``eu`` (L, E, d, f) and ``ed`` (L, E,
    f, d), and the shared experts fused into one wide FFN ``sg``/``su``
    (L, d, ns·f) and ``sd`` (the JAX package's layout and scales;
    ``torch.Generator`` draws)."""
    device = gen.device if device is None else device
    L, d, fe = cfg.n_layers, cfg.d_model, cfg.d_ff
    E, ns = cfg.n_experts, cfg.n_shared_experts
    params = dense.init(gen, cfg, dtype, device, place)
    b = dict(params["blocks"])
    for k in ("wg", "wu", "wd"):
        del b[k]
    std_in = 1.0 / d ** 0.5
    std_out = 1.0 / fe ** 0.5 / (2.0 * L) ** 0.5

    def randn(name, shape, scale):
        return place(name, (torch.randn(shape, generator=gen, device=device)
                            * scale).to(dtype))

    b["router"] = randn("router", (L, d, E), 0.02)
    b["eg"] = randn("eg", (L, E, d, fe), std_in)
    b["eu"] = randn("eu", (L, E, d, fe), std_in)
    b["ed"] = randn("ed", (L, E, fe, d), std_out)
    if ns:
        fs = ns * fe
        b["sg"] = randn("sg", (L, d, fs), std_in)
        b["su"] = randn("su", (L, d, fs), std_in)
        b["sd"] = randn("sd", (L, fs, d), std_out)
    params["blocks"] = b
    return params


# ---------------------------------------------------------------------------
# Routed FFN
# ---------------------------------------------------------------------------

def capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    c = int(cfg.capacity_factor * tokens_per_group * cfg.top_k
            / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest in descending
    order, the lower index first among equal values (a stable sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, p, cfg: ArchConfig, qm: QuantMode):
    """The router of :func:`moe_ffn` on x (G, Tg, d): (top_p (G, Tg, K)
    renormalised, top_i, probs (G, Tg, E), logits (G, Tg, E) f32)."""
    logits = qlinear(x, p["router"], p.get("brouter"), qm,
                     "router").float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, cfg.top_k)
    return top_p / top_p.sum(-1, keepdim=True), top_i, probs, logits


def positions(top_i: torch.Tensor, n_experts: int, C: int):
    """Capacity positions: each (token, slot)'s rank inside its expert, in
    (token, slot) order. Returns (flat_e (G, Tg·K), pos, keep mask)."""
    G = top_i.shape[0]
    flat_e = top_i.reshape(G, -1)
    oh = F.one_hot(flat_e, n_experts)                         # (G, TK, E)
    pos = torch.take_along_dim(oh.cumsum(1) - 1, flat_e[..., None],
                               dim=-1)[..., 0]
    return flat_e, pos, pos < C


def moe_ffn(x: torch.Tensor, p, cfg: ArchConfig, qm: QuantMode):
    """x (B, S, d) -> ((B, S, d) routed expert mix, (load-balance loss,
    router z-loss)).

    Expert weights may be expert-stacked ``PackedWeight`` leaves ((E, d,
    f) once the layer is sliced): under the fused backend ``qeinsum`` runs
    each of the three expert projections as one packed GEMM launch."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G = min(cfg.moe_groups, T)
    while T % G != 0:
        G -= 1
    Tg = T // G
    C = capacity(cfg, Tg)
    dev = x.device

    xt = pctx.shard(x.reshape(G, Tg, d), "batch", None, None)
    router = (p["router"], p.get("brouter"))

    def dispatch(xt, w, b):
        # routing and the capacity dispatch of each token group (local to
        # its groups under a mesh: the expert axis stays whole here)
        top_p, top_i, probs, logits = route(xt, {"router": w,
                                                  "brouter": b}, cfg, qm)
        frac_tokens = F.one_hot(top_i, E).float().sum(2).mean(1)  # (G, E)
        flat_e, pos, kept = positions(top_i, E, C)
        # each kept (token, slot) owns its own slot, so the buffer is a
        # gather of the tokens (slot -> token; Tg, a zero row, where no
        # token landed); dropped ones write a spare column C
        tok = torch.arange(Tg, device=dev).repeat_interleave(K)  # (TK,)
        slot = torch.full((xt.shape[0], E * (C + 1)), Tg, dtype=torch.long,
                          device=dev)
        slot.scatter_(1, flat_e * (C + 1) + torch.where(kept, pos, C),
                      tok.expand(xt.shape[0], -1))
        slot = slot.view(-1, E, C + 1)[:, :, :C].reshape(-1, E * C, 1)
        xpad = torch.cat([xt, xt.new_zeros(xt.shape[0], 1, d)], dim=1)
        buf = torch.take_along_dim(xpad, slot, dim=1).reshape(-1, E, C, d)
        # combine weights: a (token, slot)'s flat buffer index and gate
        idx = flat_e * C + pos.clamp(0, C - 1)
        gate = top_p.reshape(xt.shape[0], Tg * K).to(x.dtype) * kept.to(
            x.dtype)
        return (buf, idx, gate, frac_tokens, probs.mean(1),
                torch.logsumexp(logits, dim=-1))

    grp = ("batch", None, None)
    buf, idx, gate, frac_tokens, frac_probs, lse = pctx.local(
        dispatch, (xt, *router), (grp, None if router[0] is None else
                                  (None, None),
                                  None if router[1] is None else (None,)),
        out_like=(0, 0, 0, 0, 0, 0))

    # aux losses (Switch LBL + z-loss)
    lbl = E * (frac_tokens * frac_probs).sum(-1).mean()
    zloss = (lse ** 2).mean()

    # expert compute: the buffer moves to the expert-parallel layout (the
    # expert axis over "model"), and back for the combine
    buf = pctx.shard(buf, "batch", "model", None, None)

    def experts(buf, eg, eu, ed, beg, beu):
        # each rank runs its groups through its share of the experts
        g = qeinsum("gecd,edf->gecf", buf, eg, qm, "ffn_in")
        u = qeinsum("gecd,edf->gecf", buf, eu, qm, "ffn_in")
        if beg is not None:  # folded-transform biases (per expert)
            g = g + beg[None, :, None, :].to(g.dtype)
            u = u + beu[None, :, None, :].to(u.dtype)
        h = F.silu(g.float()).to(x.dtype) * u
        return qeinsum("gecf,efd->gecd", h, ed, qm, "ffn_down")
    ep = ("model", None, None)
    eo = pctx.local(experts, (buf, p["eg"], p["eu"], p["ed"], p.get("beg"),
                              p.get("beu")),
                    (("batch", "model", None, None), ep, ep, ep,
                     ("model", None), ("model", None)))
    eo = pctx.shard(eo, "batch", "model", None, None)
    eo = pctx.shard(eo, "batch", None, None, None)     # gather for combine

    def combine(eo, idx, gate):
        # a token's K contributions in slot order, from zero
        gathered = torch.take_along_dim(eo.reshape(eo.shape[0], E * C, d),
                                        idx[..., None], dim=1)
        contrib = (gathered * gate[..., None]).reshape(-1, Tg, K, d)
        out = torch.zeros((eo.shape[0], Tg, d), dtype=x.dtype, device=dev)
        for k in range(K):
            out = out + contrib[:, :, k]
        return out

    out = pctx.local(combine, (eo, idx, gate), (grp + (None, None), grp[:2],
                                                grp[:2]))
    out = pctx.shard(out, "batch", None, None)
    return out.reshape(B, S, d), (lbl, zloss)


def ffn_sublayer(x, p, cfg: ArchConfig, qm: QuantMode):
    """Pre-norm routed FFN (+ the shared experts as one wide SwiGLU).
    Returns (x', (lbl, zloss))."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = moe_ffn(h, p, cfg, qm)
    if "sg" in p:
        y = y + gated_mlp(h, p["sg"], p["su"], p["sd"], qm,
                          bg=p.get("bsg"), bu=p.get("bsu"))
    return x + y, aux


def _ffn(x, p, cfg: ArchConfig, qm: QuantMode):
    """The serving loops' FFN: router aux losses are dropped."""
    return ffn_sublayer(x, p, cfg, qm)[0]


# ---------------------------------------------------------------------------
# Forward / caches / prefill / decode / verify (the dense loops)
# ---------------------------------------------------------------------------

def forward(params, cfg: ArchConfig, inputs,
            qm: QuantMode = QuantMode.off(), return_aux: bool = False):
    """inputs (B, S) tokens -> logits (B, S, V); with ``return_aux`` also
    the layer means of the load-balance and z losses."""
    x = dense.embed_inputs(params, cfg, inputs)
    pos = torch.arange(x.shape[1], device=x.device)
    lbl = zl = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        p = dense._layer(params["blocks"], i)
        x, _, _ = dense.attn_sublayer(x, p, cfg, qm, pos)
        x, (l1, z1) = ffn_sublayer(x, p, cfg, qm)
        lbl, zl = lbl + l1, zl + z1
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = dense.head_out(x, params, cfg, qm)
    if return_aux:
        return logits, (lbl / cfg.n_layers, zl / cfg.n_layers)
    return logits


init_cache = dense.init_cache
init_cache_paged = dense.init_cache_paged


def prefill(params, cfg: ArchConfig, inputs, qm: QuantMode = QuantMode.off(),
            max_len: int | None = None, kv_quant=None):
    return dense.prefill(params, cfg, inputs, qm, max_len=max_len,
                         kv_quant=kv_quant, ffn=_ffn)


def prefill_chunk(params, cfg: ArchConfig, cache, inputs, start: int,
                  last_idx: int, qm: QuantMode = QuantMode.off()):
    """Chunked prefill (see :func:`transformer.prefill_chunk`). The expert
    capacity is sized from the chunk's token count, so capacity drops can
    differ from a full-sequence prefill under extreme routing imbalance."""
    return dense.prefill_chunk(params, cfg, cache, inputs, start, last_idx,
                               qm, ffn=_ffn)


def prefill_chunk_paged(params, cfg: ArchConfig, cache, block_tables,
                        inputs, start, last_idx,
                        qm: QuantMode = QuantMode.off()):
    """Chunked prefill against a paged pool (see
    :func:`transformer.prefill_chunk_paged`, (B,) vector starts included),
    with :func:`prefill_chunk`'s capacity caveat."""
    return dense.prefill_chunk_paged(params, cfg, cache, block_tables,
                                     inputs, start, last_idx, qm, ffn=_ffn)


def decode(params, cfg: ArchConfig, cache, inputs, cur_len,
           qm: QuantMode = QuantMode.off()):
    return dense.decode(params, cfg, cache, inputs, cur_len, qm, ffn=_ffn)


def decode_paged(params, cfg: ArchConfig, cache, inputs, cur_len,
                 block_tables, qm: QuantMode = QuantMode.off()):
    return dense.decode_paged(params, cfg, cache, inputs, cur_len,
                              block_tables, qm, ffn=_ffn)


def verify(params, cfg: ArchConfig, cache, inputs, pos, n_valid,
           qm: QuantMode = QuantMode.off()):
    """Speculative verify step (see :func:`transformer.verify`)."""
    return dense.verify(params, cfg, cache, inputs, pos, n_valid, qm,
                        ffn=_ffn)


def verify_paged(params, cfg: ArchConfig, cache, inputs, pos, n_valid,
                 block_tables, qm: QuantMode = QuantMode.off()):
    """Speculative verify step over a paged pool (see
    :func:`transformer.verify_paged`)."""
    return dense.verify_paged(params, cfg, cache, inputs, pos, n_valid,
                              block_tables, qm, ffn=_ffn)


# ---------------------------------------------------------------------------
# PTQ integration
# ---------------------------------------------------------------------------

def fold_norms(params, cfg: ArchConfig):
    """Fold the RMSNorm γ's into the adjacent linears; the router, the
    experts (an extra E axis) and the shared experts read through ln2."""
    p = dict(params)
    b = dict(p["blocks"])
    b["ln1"], (b["wq"], b["wk"], b["wv"]) = fold_lib.fold_norm_into(
        b["ln1"], b["wq"], b["wk"], b["wv"])
    g2 = b["ln2"]
    b["router"] = b["router"] * g2[:, :, None].to(b["router"].dtype)
    b["eg"] = b["eg"] * g2[:, None, :, None].to(b["eg"].dtype)
    b["eu"] = b["eu"] * g2[:, None, :, None].to(b["eu"].dtype)
    if "sg" in b:
        b["sg"] = b["sg"] * g2[:, :, None].to(b["sg"].dtype)
        b["su"] = b["su"] * g2[:, :, None].to(b["su"].dtype)
    b["ln2"] = torch.ones_like(g2)
    p["ln_f"], (p["head"],) = fold_lib.fold_norm_into(
        p["ln_f"], dense.head_matrix(params, cfg))
    p["blocks"] = b
    return p


def fold(params, cfg: ArchConfig, tset: fold_lib.TransformSet):
    """Fold T1/T2 (and the T3 inverse) into the weights, the expert axis
    broadcast by the role folds; requires :func:`fold_norms` first."""
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
    b["router"], b["brouter"] = fold_lib.fold_read(b["router"], None, a1i,
                                                   tset.v1)
    b["eg"], b["beg"] = fold_lib.fold_read(b["eg"], None, a1i, tset.v1)
    b["eu"], b["beu"] = fold_lib.fold_read(b["eu"], None, a1i, tset.v1)
    ed, _ = fold_lib.fold_write(b["ed"], None, tset.a1)
    if tset.t3_block:
        ed = fold_lib.fold_t3(ed, tset.t3_block)
    b["ed"] = ed
    if "sg" in b:
        b["sg"], b["bsg"] = fold_lib.fold_read(b["sg"], None, a1i, tset.v1)
        b["su"], b["bsu"] = fold_lib.fold_read(b["su"], None, a1i, tset.v1)
        sd, _ = fold_lib.fold_write(b["sd"], None, tset.a1)
        if tset.t3_block:
            sd = fold_lib.fold_t3(sd, tset.t3_block)
        b["sd"] = sd
    p["embed"] = fold_lib.fold_embed(p["embed"], tset.a1, tset.v1)
    p["head"], p["bhead"] = fold_lib.fold_read(
        dense.head_matrix(params, cfg), None, a1i, tset.v1)
    p["blocks"] = b
    return p
