"""Public kernel wrappers of the port — the names, argument order and
contract checks of ``repro.kernels.ops`` (minus ``interpret`` and the TPU
tile knobs, which have no meaning here).

Dispatch: a tensor on the CPU runs the kernel's plain PyTorch version
(``ref``); a CUDA tensor launches the hand-written Hopper kernel (built
from ``csrc/`` at first use) or raises — there is no fallback. Inputs that
break the contract raise ``ValueError`` on every device, as in the JAX
package.

``launches`` counts, per wrapper, the calls that launched the CUDA kernel
(plain-version calls are not counted); :func:`reset_launches` zeroes it.
"""
from __future__ import annotations

import torch

from . import build, packing as _pk, ref

# element-format ids shared with csrc/mx_common.cuh (enum MxFmt)
_FMT = {"mxfp4": 0, "mxint4": 1, "mxfp8": 2, "mxint8": 3}

launches = {"mx_gemm_packed": 0, "mx_flash_decode_paged": 0,
            "mx_flash_prefill": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on_card(*ts) -> bool:
    """True when the inputs live on a CUDA device (all of them), False on
    the CPU; any other mix raises."""
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs must all be on the CPU or all on one "
                     f"CUDA device, got {sorted(devs)}")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _aligned(t: torch.Tensor, dtype) -> torch.Tensor:
    """Contiguous tensor of ``dtype`` whose data starts on a 16-byte
    boundary (the kernels load 16 bytes at a time)."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ----------------------------------------------------------------------
# Packed-native fused MX GEMM
# ----------------------------------------------------------------------

def _gemm_contract(x, w_packed, w_scales_e8m0, fmt) -> None:
    lead = w_packed.ndim - 2
    if x.ndim != lead + 2:
        raise ValueError(f"x rank {x.ndim} does not match weight batch "
                         f"rank {w_packed.ndim}")
    _pk._check_packable(fmt)
    K2, N = w_packed.shape[-2:]
    K = 2 * K2
    if (x.shape[-1] != K or K % 32 != 0
            or w_scales_e8m0.shape[-2:] != (K // 32, N)
            or w_packed.shape[:-2] != w_scales_e8m0.shape[:-2]
            or x.shape[:-2] != w_packed.shape[:-2]
            or w_packed.dtype != torch.uint8
            or w_scales_e8m0.dtype != torch.uint8):
        raise ValueError(
            f"mx_gemm_packed contract violation: x {tuple(x.shape)}, "
            f"w_packed {tuple(w_packed.shape)} {w_packed.dtype}, "
            f"w_scales_e8m0 {tuple(w_scales_e8m0.shape)}. Expected x "
            f"(*lead, M, K), uint8 w_packed (*lead, K//2, N) and uint8 "
            f"w_scales_e8m0 (*lead, K//32, N) with K % 32 == 0.")


def _gemm_2d(x, w_packed, w_scales_e8m0, fmt, t3):
    M, K = x.shape
    N = w_packed.shape[1]
    x = _aligned(x, torch.float32)
    wp = w_packed.contiguous()
    ws = w_scales_e8m0.contiguous()
    xq = torch.empty((M, K), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = build.kernel("mx_gemm")(_ptr(x), _ptr(xq), _ptr(wp), _ptr(ws),
                                 _ptr(y), M, N, K, _FMT[fmt], int(t3),
                                 _stream())
    _check(rc, "mx_gemm_packed")
    launches["mx_gemm_packed"] += 1
    return y


def mx_gemm_packed(x, w_packed, w_scales_e8m0, fmt: str = "mxfp4",
                   t3: bool = False) -> torch.Tensor:
    """Packed-native fused MX GEMM: y = Q_mx(x [· blockdiag(H32)]) @
    deq(w), f32 out.

    x (M, K) float; w_packed (K//2, N) uint8 (two 4-bit codes per byte
    along K, even index in the low nibble); w_scales_e8m0 (K//32, N) uint8.
    Stacked weights carry leading batch dims on all three operands, with x
    (*lead, M, K). ``t3=True`` rotates each activation 32-block by the
    Hadamard H32 before quantizing (the ``ffn_down`` call site). fmt is
    'mxfp4' or 'mxint4'. No dense weight is materialized on the card."""
    _gemm_contract(x, w_packed, w_scales_e8m0, fmt)
    if not _on_card(x, w_packed, w_scales_e8m0):
        return ref.mx_matmul_packed_ref(x, w_packed, w_scales_e8m0, fmt, t3)
    if w_packed.ndim == 2:
        return _gemm_2d(x, w_packed, w_scales_e8m0, fmt, t3)
    lead = w_packed.shape[:-2]
    xs = x.reshape(-1, *x.shape[-2:])
    wps = w_packed.reshape(-1, *w_packed.shape[-2:])
    wss = w_scales_e8m0.reshape(-1, *w_scales_e8m0.shape[-2:])
    ys = [_gemm_2d(xs[i], wps[i], wss[i], fmt, t3) for i in range(len(xs))]
    return torch.stack(ys).reshape(*lead, *ys[0].shape)


# ----------------------------------------------------------------------
# Paged flash decode
# ----------------------------------------------------------------------

def _flash_decode_paged_contract(q, k_codes, k_scales, v_codes, v_scales,
                                 block_tables, fmt: str) -> bool:
    """Does the page pool meet the paged flash-decode kernel contract?"""
    if fmt not in _pk.KV_FMTS:
        return False
    if (q.ndim != 3 or k_codes.ndim != 3 or k_scales.ndim != 3
            or block_tables.ndim != 2):
        return False
    B, H, Dh = q.shape
    bits = _pk.kv_fmt_bits(fmt)
    N, P = k_codes.shape[0], k_codes.shape[1]
    D = k_codes.shape[2] * 8 // bits
    if D % 32 != 0 or Dh == 0 or D % Dh != 0 or H % (D // Dh) != 0:
        return False
    return (block_tables.shape[0] == B
            and tuple(k_scales.shape) == (N, P, D // 32)
            and v_codes.shape == k_codes.shape
            and v_scales.shape == k_scales.shape)


def _lane_vec(v, B: int, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(torch.int32).reshape(
        -1).expand(B).contiguous()


def mx_flash_decode_paged(q, k_codes, k_scales, v_codes, v_scales,
                          block_tables, q_pos, kv_len, fmt: str = "mxfp8",
                          window: int = 0) -> torch.Tensor:
    """Flash-decode attention over a paged packed MX KV pool.

    q (B, H, Dh) float; k/v_codes (N, P, D*bits/8) uint8 and k/v_scales
    (N, P, D//32) uint8 — the ``PagedKV`` pool; block_tables (B, maxp)
    int32 (lane b's chunk c reads page ``block_tables[b, c]``, positions
    [c*P, (c+1)*P)); q_pos / kv_len (B,) int32 (scalars broadcast).
    Returns (B, H, Dh) float32. ``window`` > 0 masks keys at
    ``pos <= q_pos - window``. Table slots past a lane's fill must hold
    valid page ids (the engine parks them on its scrap page)."""
    if not _flash_decode_paged_contract(q, k_codes, k_scales, v_codes,
                                        v_scales, block_tables, fmt):
        raise ValueError(
            f"mx_flash_decode_paged contract violation: q {tuple(q.shape)}, "
            f"k_codes {tuple(k_codes.shape)}, k_scales "
            f"{tuple(k_scales.shape)}, v_codes {tuple(v_codes.shape)}, "
            f"v_scales {tuple(v_scales.shape)}, block_tables "
            f"{tuple(block_tables.shape)}, fmt={fmt!r}. Expected q (B, H, "
            f"Dh); a (N, P, D*bits/8) page pool with D % 32 == 0, "
            f"D % Dh == 0 and H divisible by the kv-head count D/Dh; scales "
            f"(N, P, D//32); V shapes matching K; block_tables (B, maxp) "
            f"int32; fmt one of {_pk.KV_FMTS}.")
    if not _on_card(q, k_codes, k_scales, v_codes, v_scales, block_tables):
        return ref.mx_attention_paged_ref(q, k_codes, k_scales, v_codes,
                                          v_scales, block_tables, q_pos,
                                          kv_len, fmt, window)
    B, H, Dh = q.shape
    N, P, _ = k_codes.shape
    D = k_scales.shape[2] * 32
    dev = q.device
    qf = q.float().contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    qp = _lane_vec(q_pos, B, dev)
    kl = _lane_vec(kv_len, B, dev)
    kc, ks, vc, vs = (t.contiguous() for t in (k_codes, k_scales, v_codes,
                                                v_scales))
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=dev)
    rc = build.kernel("mx_decode_paged")(
        _ptr(qf), _ptr(kc), _ptr(ks), _ptr(vc), _ptr(vs), _ptr(bt),
        _ptr(qp), _ptr(kl), _ptr(out), B, H, Dh, D, P, bt.shape[1],
        _FMT[fmt], int(window), _stream())
    _check(rc, "mx_flash_decode_paged")
    launches["mx_flash_decode_paged"] += 1
    return out


# ----------------------------------------------------------------------
# Paged flash prefill with the fused quantize-on-append
# ----------------------------------------------------------------------

def _flash_prefill_contract(q, k_chunk, v_chunk, k_codes, k_scales,
                            v_codes, v_scales, block_tables,
                            fmt: str) -> bool:
    """Does the input meet the paged flash-prefill kernel contract?"""
    if fmt not in _pk.KV_FMTS:
        return False
    if (q.ndim != 4 or k_chunk.ndim != 3 or k_codes.ndim != 3
            or k_scales.ndim != 3 or block_tables.ndim != 2):
        return False
    B, C, H, Dh = q.shape
    bits = _pk.kv_fmt_bits(fmt)
    N, P = k_codes.shape[0], k_codes.shape[1]
    D = k_codes.shape[2] * 8 // bits
    if D % 32 != 0 or Dh == 0 or D % Dh != 0 or H % (D // Dh) != 0:
        return False
    return (block_tables.shape[0] == B and block_tables.shape[1] >= 1
            and tuple(k_chunk.shape) == (B, C, D)
            and v_chunk.shape == k_chunk.shape
            and tuple(k_scales.shape) == (N, P, D // 32)
            and v_codes.shape == k_codes.shape
            and v_scales.shape == k_scales.shape)


def mx_flash_prefill(q, k_chunk, v_chunk, k_codes, k_scales, v_codes,
                     v_scales, block_tables, q_start, kv_len,
                     fmt: str = "mxfp8", window: int = 0):
    """Flash-prefill attention over a paged packed MX KV pool, fused with
    the quantize-on-append of the chunk.

    q (B, C, H, Dh) float; k/v_chunk (B, C, D) float; the (N, P, ·) pool
    and block tables as in :func:`mx_flash_decode_paged`; q_start / kv_len
    (B,) int32 — chunk start and valid-key bound per lane (pool rows
    ``kp < q_start`` are the committed prefix).

    Returns ``(out (B, C, H, Dh) f32, k_code_bytes (B, C, D*bits/8) u8,
    k_scale_bytes (B, C, D//32) u8, v_code_bytes, v_scale_bytes)``; the
    byte outputs equal ``packing.kv_encode`` of the chunk and attention
    reads their round trip, so scattering them into the pool is
    write-then-read exact."""
    if not _flash_prefill_contract(q, k_chunk, v_chunk, k_codes, k_scales,
                                   v_codes, v_scales, block_tables, fmt):
        raise ValueError(
            f"mx_flash_prefill contract violation: q {tuple(q.shape)}, "
            f"k_chunk {tuple(k_chunk.shape)}, v_chunk "
            f"{tuple(v_chunk.shape)}, k_codes {tuple(k_codes.shape)}, "
            f"k_scales {tuple(k_scales.shape)}, v_codes "
            f"{tuple(v_codes.shape)}, v_scales {tuple(v_scales.shape)}, "
            f"block_tables {tuple(block_tables.shape)}, fmt={fmt!r}. "
            f"Expected q (B, C, H, Dh); dense chunk K/V (B, C, D) with "
            f"D % 32 == 0, D % Dh == 0 and H divisible by the kv-head "
            f"count D/Dh; a (N, P, D*bits/8) page pool with scales (N, P, "
            f"D//32); V shapes matching K; block_tables (B, maxp) int32 "
            f"with maxp >= 1; fmt one of {_pk.KV_FMTS}.")
    if not _on_card(q, k_chunk, v_chunk, k_codes, k_scales, v_codes,
                    v_scales, block_tables):
        return ref.mx_prefill_ref(q, k_chunk, v_chunk, k_codes, k_scales,
                                  v_codes, v_scales, block_tables, q_start,
                                  kv_len, fmt, window)
    B, C, H, Dh = q.shape
    N, P, db = k_codes.shape
    D = k_scales.shape[2] * 32
    dev = q.device
    qf = q.float().contiguous()
    kd = k_chunk.float().contiguous()
    vd = v_chunk.float().contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    st = _lane_vec(q_start, B, dev)
    kl = _lane_vec(kv_len, B, dev)
    kcp, ksp, vcp, vsp = (t.contiguous() for t in (k_codes, k_scales,
                                                    v_codes, v_scales))
    out = torch.empty((B, C, H, Dh), dtype=torch.float32, device=dev)
    kc = torch.empty((B, C, db), dtype=torch.uint8, device=dev)
    ks = torch.empty((B, C, D // 32), dtype=torch.uint8, device=dev)
    vc = torch.empty_like(kc)
    vs = torch.empty_like(ks)
    rc = build.kernel("mx_prefill")(
        _ptr(qf), _ptr(kd), _ptr(vd), _ptr(kcp), _ptr(ksp), _ptr(vcp),
        _ptr(vsp), _ptr(bt), _ptr(st), _ptr(kl), _ptr(out), _ptr(kc),
        _ptr(ks), _ptr(vc), _ptr(vs), B, C, H, Dh, D, P, bt.shape[1],
        _FMT[fmt], int(window), _stream())
    _check(rc, "mx_flash_prefill")
    launches["mx_flash_prefill"] += 1
    return out, kc, ks, vc, vs

