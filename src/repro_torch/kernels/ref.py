"""Plain PyTorch versions of the kernels (the port of
``repro.kernels.ref``). The CPU path of every wrapper in ``ops`` runs
these; on the card ``chip_smoke.py`` holds each CUDA kernel against them."""
from __future__ import annotations

import torch

from repro_torch.core import mx as mxlib
from repro_torch.core import transforms as tfm
from repro_torch.kernels import packing

NEG_INF = -1e30


def mx_quant_ref(x: torch.Tensor, fmt: str = "mxfp4", block: int = 32):
    """(M, K) -> (codes uint8 (M, K), scales f32 (M, K//block))."""
    return mxlib.encode(x, mxlib.MXConfig(fmt=fmt, block_size=block))


def mx_dequant_ref(codes, scales, fmt: str = "mxfp4", block: int = 32,
                   dtype=torch.float32):
    return mxlib.decode(codes, scales,
                        mxlib.MXConfig(fmt=fmt, block_size=block), dtype)


def mx_matmul_ref(x: torch.Tensor, w_codes: torch.Tensor,
                  w_scales: torch.Tensor, fmt: str = "mxfp4",
                  block: int = 32) -> torch.Tensor:
    """y = Q_mx(x) @ dequant(w), f32. x (*lead, M, K); w_codes (*lead, K, N)
    uint8; w_scales (*lead, K//block, N) f32."""
    cfg = mxlib.MXConfig(fmt=fmt, block_size=block)
    xq = mxlib.quantize(x.float(), cfg)
    w = mx_dequant_ref(w_codes.mT, w_scales.mT, fmt, block).mT
    return xq @ w


def hadamard_quant_ref(x: torch.Tensor, fmt: str = "mxfp4",
                       block: int = 32):
    """Online T3: block-Hadamard rotate then MX-encode."""
    h = tfm.hadamard_matrix(block, device=x.device)
    return mx_quant_ref(tfm.apply_blockwise(x.float(), h), fmt, block)


def mx_matmul_packed_ref(x: torch.Tensor, w_packed: torch.Tensor,
                         w_scales_e8m0: torch.Tensor, fmt: str = "mxfp4",
                         t3: bool = False) -> torch.Tensor:
    """Plain version of the packed-native GEMM:
    y = Q_mx(T3?(x)) @ dequant(w), f32. x (M, K); w_packed (K//2, N) uint8
    nibble-packed along K; w_scales_e8m0 (K//32, N) uint8 — or all three
    with the same leading (layer) axes."""
    codes = packing.unpack_codes(w_packed.mT).mT
    scales = packing.unpack_scales_e8m0(w_scales_e8m0)
    xf = x.float()
    if t3:
        xf = tfm.apply_blockwise(xf, tfm.hadamard_matrix(32, device=x.device))
    return mx_matmul_ref(xf, codes, scales, fmt)


def sm_scale(dh: int) -> float:
    """Softmax scale 1/sqrt(Dh), rounded as f32 arithmetic rounds it (the
    JAX package and the CUDA kernels compute ``1.0f / sqrtf(Dh)``)."""
    return (1.0 / torch.sqrt(torch.tensor(float(dh)))).item()


def _bcast(v, B: int, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64,
                           device=device).reshape(-1).expand(B)


def _attend(qg: torch.Tensor, blocks) -> torch.Tensor:
    """Masked online softmax of qg (B, Q, K, G, Dh) over key blocks, in
    order: ``blocks`` yields (k, v (B, c, K, Dh), ok (B, Q, c)). Masked
    scores sit at NEG_INF, masked probabilities are 0 and the normaliser is
    clamped at 1e-30, as in the kernels; a fully masked block is an exact
    no-op. With page-sized blocks this is the kernels' order of
    accumulation and the arithmetic of ``models.layers.attention``, so the
    fused path on the CPU matches the reference path value for value."""
    B, Q, K, G, Dh = qg.shape
    scale = sm_scale(Dh)
    m = torch.full((B, Q, K, G), NEG_INF, device=qg.device)
    l = torch.zeros((B, Q, K, G), device=qg.device)
    acc = torch.zeros((B, Q, K, G, Dh), device=qg.device)
    for k, v, ok in blocks:
        okb = ok[:, :, None, None, :]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, k) * scale
        s = torch.where(okb, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(okb, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, v)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _mask(kp, qp, kl, window: int):
    """(B, Q, c) key validity: causal, fill and sliding window. kp (c,) or
    (B, c) key positions; qp (B, Q) query positions; kl (B,) fills."""
    kp = kp if kp.ndim == 2 else kp[None, :]
    ok = (kp[:, None, :] <= qp[:, :, None]) & (kp[:, None, :] < kl[:, None,
                                                                    None])
    if window:
        ok = ok & (kp[:, None, :] > qp[:, :, None] - window)
    return ok


def mx_attention_ref(q: torch.Tensor, k_codes: torch.Tensor,
                     k_scales: torch.Tensor, v_codes: torch.Tensor,
                     v_scales: torch.Tensor, q_pos, kv_len,
                     fmt: str = "mxfp8", window: int = 0,
                     block: int | None = None) -> torch.Tensor:
    """Decode attention over a contiguous packed cache (B, S, ·): decode
    the cache and attend it in key blocks of ``block`` rows (default: one
    block of S). q (B, H, Dh) -> (B, H, Dh) f32."""
    B, H, Dh = q.shape
    k = packing.kv_decode(k_codes, k_scales, fmt)
    v = packing.kv_decode(v_codes, v_scales, fmt)
    S, D = k.shape[1], k.shape[2]
    kvh = D // Dh
    qg = q.float().reshape(B, 1, kvh, H // kvh, Dh)
    kh = k.reshape(B, S, kvh, Dh)
    vh = v.reshape(B, S, kvh, Dh)
    qp = _bcast(q_pos, B, q.device)[:, None]
    kl = _bcast(kv_len, B, q.device)
    bs = S if block is None else block
    kp = torch.arange(S, device=q.device)
    out = _attend(qg, ((kh[:, i:i + bs], vh[:, i:i + bs],
                        _mask(kp[i:i + bs], qp, kl, window))
                       for i in range(0, S, bs)))
    return out.reshape(B, H, Dh)


def mx_attention_paged_ref(q, k_codes, k_scales, v_codes, v_scales,
                           block_tables, q_pos, kv_len, fmt: str = "mxfp8",
                           window: int = 0) -> torch.Tensor:
    """Plain version of the paged flash-decode kernel: gather each lane's
    pages into the contiguous layout and attend it page by page
    (:func:`mx_attention_ref` with one block per page)."""
    bt = block_tables.long()
    B, maxp = bt.shape
    P = k_codes.shape[1]

    def flat(pool):
        return pool[bt].reshape(B, maxp * P, pool.shape[-1])

    return mx_attention_ref(q, flat(k_codes), flat(k_scales),
                            flat(v_codes), flat(v_scales), q_pos, kv_len,
                            fmt, window, block=P)


def mx_prefill_ref(q, k_chunk, v_chunk, k_codes, k_scales, v_codes,
                   v_scales, block_tables, q_start, kv_len,
                   fmt: str = "mxfp8", window: int = 0):
    """Plain version of the paged flash-prefill kernel. The chunk is encoded
    with ``kv_encode`` (the byte outputs) and attended as the round trip
    of those bytes; the lane's pages come first, page by page, with pool
    rows valid only below q_start (the committed prefix), then the chunk,
    row i at q_start + i. Causal, fill and window masks per query row.
    Returns (out (B, C, H, Dh) f32, k_code_bytes, k_scale_bytes,
    v_code_bytes, v_scale_bytes)."""
    B, C, H, Dh = q.shape
    bt = block_tables.long()
    maxp = bt.shape[1]
    P = k_codes.shape[1]
    kc, ks = packing.kv_encode(k_chunk, fmt)
    vc, vs = packing.kv_encode(v_chunk, fmt)
    st = _bcast(q_start, B, q.device)
    kl = _bcast(kv_len, B, q.device)
    qp = st[:, None] + torch.arange(C, device=q.device)[None, :]   # (B, C)
    D = kc.shape[-1] * 8 // packing.kv_fmt_bits(fmt)
    kvh = D // Dh
    qg = q.float().reshape(B, C, kvh, H // kvh, Dh)

    def heads(x):
        return x.reshape(x.shape[0], x.shape[1], kvh, Dh)

    def blocks():
        for c in range(maxp):
            page = bt[:, c]
            kp = c * P + torch.arange(P, device=q.device)
            ok = _mask(kp, qp, kl, window) & (kp[None, None, :]
                                             < st[:, None, None])
            yield (heads(packing.kv_decode(k_codes[page], k_scales[page],
                                           fmt)),
                   heads(packing.kv_decode(v_codes[page], v_scales[page],
                                           fmt)), ok)
        yield (heads(packing.kv_decode(kc, ks, fmt)),
               heads(packing.kv_decode(vc, vs, fmt)),
               _mask(qp, qp, kl, window))

    out = _attend(qg, blocks())
    return out.reshape(B, C, H, Dh), kc, ks, vc, vs
