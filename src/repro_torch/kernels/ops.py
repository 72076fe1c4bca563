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

Dispatch instrumentation, as in the JAX package (``docs/observability.md``):
after :func:`instrument`, every public wrapper records its calls and their
cumulative host-side dispatch time into an ``obs.MetricsRegistry``
(``kernel_dispatch_calls_total`` / ``kernel_dispatch_seconds_total``,
labeled by ``op`` and ``traced``), with a ``dispatch:<op>`` span (cat
``kernel``) per call when a tracer is given, and the fused-or-reference
decisions of ``core.quantize`` land in ``quant_dispatch_total{op, path,
role}``. In the JAX package ``traced="true"`` marks a call made inside an
enclosing ``jax.jit`` trace, which runs once per compile rather than once
per step. The port traces nothing, so every call is a real dispatch and
carries ``traced="false"``; a call counts whichever route it takes (the
plain version on the CPU, the kernel on the card), where ``launches``
counts kernel launches only. The timer spans the host's side of the call:
no synchronisation, no ``.item()`` and no copy to the host is added, so
on the card the kernel's own time is not in it. Uninstrumented (the
default), a call costs one ``is None`` check and one Python call more.

Under a mesh (``launch/pcontext.py``) an operand may be a ``DTensor``. The
launches take raw pointers, so a ``DTensor`` never reaches them: the
wrapper runs through :func:`on_whole` — every ``DTensor`` operand
redistributed to ``Replicate()``, the wrapper run on the local tensors,
its outputs wrapped back as ``Replicate()``. Each such call counts in
``quant_paths`` under (name, "replicated", ""), and once, under the
wrapper's name, in the dispatch counters.
"""
from __future__ import annotations

import functools
import time

import torch

from repro_torch.core import mx as _mx

from . import build, packing as _pk, ref

# element-format ids shared with csrc/mx_common.cuh (enum MxFmt), keyed by
# the element format's name so both spellings ('mxfp4', 'fp4_e2m1') resolve
_FMT_IDS = {"fp4_e2m1": 0, "int4": 1, "fp8_e4m3": 2, "int8": 3, "fp6_e2m3": 4}

launches = {"mx_gemm_packed": 0, "mx_flash_decode_paged": 0,
            "mx_flash_prefill": 0, "mx_flash_decode": 0, "mx_quantize": 0,
            "t3_quantize": 0, "mx_gemm": 0}


def _fmt_id(fmt: str) -> int:
    return _FMT_IDS[_mx.FORMATS[fmt].name]


# (op, path, role) -> calls: ``core.quantize``'s fused-or-reference
# decisions (``qlinear`` / ``qeinsum``), the JAX package's
# ``quant_dispatch_total`` counter; counted per call (the JAX package counts
# per traced call site)
quant_paths: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    quant_paths.clear()


# ----------------------------------------------------------------------
# Dispatch instrumentation
# ----------------------------------------------------------------------

_instr = None       # (registry, tracer) when instrumented


def instrument(registry, tracer=None) -> None:
    """Start recording kernel-dispatch metrics into ``registry`` (an
    ``obs.MetricsRegistry``); with an ``obs.Tracer`` also emit a
    ``dispatch:<op>`` span per call. Global (module-level): one
    instrumentation target at a time; :func:`uninstrument` stops."""
    global _instr
    _instr = (registry, tracer)


def uninstrument() -> None:
    global _instr
    _instr = None


def _record(op: str, dt: float) -> None:
    registry, _ = _instr
    labels = {"op": op, "traced": "false"}
    registry.counter(
        "kernel_dispatch_calls_total", labels,
        help="public kernel-wrapper invocations (the port traces nothing: "
             "every call is a real dispatch, traced=false)").inc()
    registry.counter(
        "kernel_dispatch_seconds_total", labels, unit="s",
        help="cumulative host-side dispatch wall time (asynchronous "
             "device work excluded; on the CPU the plain version's whole "
             "time)").inc(dt)


def _dispatch(op: str, fn, *args, **kwargs):
    """Call ``fn``, timing its host-side dispatch when instrumented. The
    timer does not wait for the card: instrumentation adds no
    synchronisation to a serving loop. An exception propagates unrecorded."""
    ins = _instr
    if ins is None:
        return fn(*args, **kwargs)
    _, tracer = ins
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    dt = time.perf_counter() - t0
    _record(op, dt)
    if tracer is not None:
        tracer.complete(f"dispatch:{op}", t0, t0 + dt, cat="kernel")
    return out


def record_quant_path(op: str, path: str, role: str = "") -> None:
    """Count one dispatch decision of ``core.quantize`` in ``quant_paths``
    and, when instrumented, in ``quant_dispatch_total{op, path, role}``."""
    key = (op, path, role)
    quant_paths[key] = quant_paths.get(key, 0) + 1
    ins = _instr
    if ins is not None:
        ins[0].counter(
            "quant_dispatch_total", {"op": op, "path": path, "role": role},
            help="qlinear/qeinsum execution-path decisions (per "
                 "call)").inc()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_tree_map(fn, v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree)


def on_whole(fn, *trees):
    """``fn(*trees)`` on whole tensors: each ``DTensor`` leaf (in nested
    dicts, tuples and lists) is gathered to ``Replicate()`` and passed as
    its local tensor, and each tensor leaf of the result comes back as a
    replicated ``DTensor`` — what GSPMD does with a custom call it cannot
    partition. Gradients flow through it. With no ``DTensor`` leaf it is
    ``fn(*trees)``."""
    found = []
    _tree_map(lambda x: found.append(x) if _is_dtensor(x) else None, trees)
    if not found:
        return fn(*trees)
    from torch.distributed.tensor import DTensor, Replicate
    dm = found[0].device_mesh
    rep = [Replicate()] * dm.ndim
    local = lambda x: (x.redistribute(dm, rep).to_local()
                       if _is_dtensor(x) else x)
    back = lambda x: (DTensor.from_local(x, dm, rep, run_check=False)
                      if isinstance(x, torch.Tensor) else x)
    return _tree_map(back, fn(*_tree_map(local, trees)))


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _public(fn):
    """The public wrapper of ``fn``: timed by :func:`_dispatch` under
    ``fn``'s name, and run through :func:`on_whole` when any positional
    operand is a ``DTensor`` (see the module doc)."""
    op = fn.__name__

    def run(*args, **kwargs):
        if not any(_is_dtensor(a) for a in args):
            return fn(*args, **kwargs)
        record_quant_path(op, "replicated")
        return on_whole(functools.partial(fn, **kwargs), *args)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return _dispatch(op, run, *args, **kwargs)
    return wrapper


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


def _lane_vec(v, B: int, device) -> torch.Tensor:
    """Per-lane int32 vector (B,) of a scalar or (B,) ``v`` on ``device``."""
    return torch.as_tensor(v, device=device).to(torch.int32).reshape(
        -1).expand(B).contiguous()


# ----------------------------------------------------------------------
# Standalone MX quantizers and the unpacked-layout GEMM
# ----------------------------------------------------------------------

def _quant_contract(x, fmt: str, name: str) -> None:
    if (x.ndim != 2 or x.shape[1] % 32 != 0 or x.shape[1] == 0
            or fmt not in _mx.FORMATS):
        raise ValueError(
            f"{name} contract violation: x {tuple(x.shape)}, fmt={fmt!r}. "
            f"Expected x (M, K) with K a positive multiple of 32 and fmt "
            f"one of {sorted(_mx.FORMATS)}.")


def _quantize(x, fmt: str, t3: bool):
    name = "t3_quantize" if t3 else "mx_quantize"
    _quant_contract(x, fmt, name)
    if not _on_card(x):
        xf = x.float()
        return (ref.hadamard_quant_ref(xf, fmt) if t3
                else ref.mx_quant_ref(xf, fmt))
    M, K = x.shape
    xf = _aligned(x, torch.float32)
    codes = torch.empty((M, K), dtype=torch.uint8, device=x.device)
    scales = torch.empty((M, K // 32), dtype=torch.float32, device=x.device)
    rc = build.kernel("hadamard_quant" if t3 else "mx_quant")(
        _ptr(xf), _ptr(codes), _ptr(scales), M, K, _fmt_id(fmt), _stream())
    _check(rc, name)
    launches[name] += 1
    return codes, scales


@_public
def mx_quantize(x, fmt: str = "mxfp4"):
    """MX-encode x (M, K) float, K % 32 == 0, per 32-block along K: returns
    (codes uint8 (M, K), one symmetric code per byte; scales float32
    (M, K//32), powers of two). Every MX format (mxfp4, mxint4, mxfp6,
    mxfp8, mxint8)."""
    return _quantize(x, fmt, False)


@_public
def t3_quantize(x, fmt: str = "mxfp4"):
    """The online T3: rotate each 32-block of x (M, K) by the Hadamard H32,
    then MX-encode as :func:`mx_quantize` — (codes uint8 (M, K), scales
    float32 (M, K//32))."""
    return _quantize(x, fmt, True)


@_public
def mx_gemm(x, w_codes, w_scales, fmt: str = "mxfp4") -> torch.Tensor:
    """Fused MX GEMM over the unpacked weight layout: y = Q_mx(x) @
    deq(w), f32 out.

    x (M, K) float, quantized per row in 32-blocks to ``fmt``; w_codes
    (K, N) uint8, one code per byte; w_scales (K//32, N) float32 (the
    ``mx_quantize`` layout of w transposed). K % 32 == 0; every MX
    format."""
    if (x.ndim != 2 or w_codes.ndim != 2 or w_scales.ndim != 2
            or x.shape[1] != w_codes.shape[0] or x.shape[1] % 32 != 0
            or tuple(w_scales.shape) != (x.shape[1] // 32, w_codes.shape[1])
            or w_codes.dtype != torch.uint8 or not w_scales.is_floating_point()
            or fmt not in _mx.FORMATS):
        raise ValueError(
            f"mx_gemm contract violation: x {tuple(x.shape)}, w_codes "
            f"{tuple(w_codes.shape)} {w_codes.dtype}, w_scales "
            f"{tuple(w_scales.shape)} {w_scales.dtype}, fmt={fmt!r}. "
            f"Expected x (M, K), uint8 w_codes (K, N) and float w_scales "
            f"(K//32, N) with K % 32 == 0; fmt one of "
            f"{sorted(_mx.FORMATS)}.")
    if not _on_card(x, w_codes, w_scales):
        return ref.mx_matmul_ref(x, w_codes, w_scales.float(), fmt)
    M, K = x.shape
    N = w_codes.shape[1]
    xf = _aligned(x, torch.float32)
    wc = w_codes.contiguous()
    ws = w_scales.float().contiguous()
    xq = torch.empty((M, K), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = build.kernel("mx_gemm")(_ptr(xf), _ptr(xq), _ptr(wc), _ptr(ws),
                                 _ptr(y), M, N, K, _fmt_id(fmt), _stream())
    _check(rc, "mx_gemm")
    launches["mx_gemm"] += 1
    return y


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


# csrc/mx_gemm.cu: M up to this runs the small-M (decode) kernel
GEMV_MAX_M = 16


def _gemm_scratch_bytes(E: int, M: int, K: int) -> int:
    """Bytes of ``mx_gemm_packed_launch``'s scratch: the encoded
    activations (E, M, K), bf16 for the tile path and f32 for the small-M
    kernel's prepass (the route is chosen by M, the rows of one expert)."""
    return (4 if M <= GEMV_MAX_M else 2) * E * M * K


def _gemm_batched(x, w_packed, w_scales_e8m0, fmt, t3):
    """One launch over E stacked products: x (E, M, K), w_packed (E, K//2,
    N), w_scales_e8m0 (E, K//32, N) -> (E, M, N); E = 1 is the 2-D call."""
    E, M, K = x.shape
    N = w_packed.shape[-1]
    x = _aligned(x, torch.float32)
    wp = w_packed.contiguous()
    ws = w_scales_e8m0.contiguous()
    xq = torch.empty(_gemm_scratch_bytes(E, M, K), dtype=torch.uint8,
                     device=x.device)
    y = torch.empty((E, M, N), dtype=torch.float32, device=x.device)
    rc = build.kernel("mx_gemm_packed")(_ptr(x), _ptr(xq), _ptr(wp),
                                        _ptr(ws), _ptr(y), E, M, N, K,
                                        _fmt_id(fmt), int(t3), _stream())
    _check(rc, "mx_gemm_packed")
    launches["mx_gemm_packed"] += 1
    return y


@_public
def mx_gemm_packed(x, w_packed, w_scales_e8m0, fmt: str = "mxfp4",
                   t3: bool = False) -> torch.Tensor:
    """Packed-native fused MX GEMM: y = Q_mx(x [· blockdiag(H32)]) @
    deq(w), f32 out.

    x (M, K) float; w_packed (K//2, N) uint8 (two 4-bit codes per byte
    along K, even index in the low nibble); w_scales_e8m0 (K//32, N) uint8.
    Stacked (layer- or expert-batched) weights carry leading batch dims on
    all three operands, with x (*lead, M, K): on the card the stacked
    products run as one launch, the flattened leading axes a grid axis of
    the kernels. ``t3=True`` rotates each activation 32-block by the
    Hadamard H32 before quantizing (the ``ffn_down`` call site). fmt is
    'mxfp4' or 'mxint4'. No dense weight is materialized on the card."""
    _gemm_contract(x, w_packed, w_scales_e8m0, fmt)
    if not _on_card(x, w_packed, w_scales_e8m0):
        return ref.mx_matmul_packed_ref(x, w_packed, w_scales_e8m0, fmt, t3)
    lead = w_packed.shape[:-2]
    y = _gemm_batched(x.reshape(-1, *x.shape[-2:]),
                      w_packed.reshape(-1, *w_packed.shape[-2:]),
                      w_scales_e8m0.reshape(-1, *w_scales_e8m0.shape[-2:]),
                      fmt, t3)
    return y.reshape(*lead, *y.shape[-2:])


# ----------------------------------------------------------------------
# Flash decode: the split of a lane's keys over blocks
# ----------------------------------------------------------------------

DECODE_TILE = 64       # csrc/mx_decode.cuh TK: keys per tile


def decode_splits(limit: int, B: int, kvh: int, sms: int):
    """Split of each lane's keys for the flash-decode kernels: ``(nsplit,
    chunk)`` with keys [s*chunk, (s+1)*chunk) in split s, ``chunk`` a
    multiple of DECODE_TILE and ``nsplit * chunk >= limit`` (no split past
    the last row). ``limit`` is the layout's row count per lane (S of the
    contiguous cache, maxp * P of the pool). Chosen from these static sizes
    only, never from the fills, which live on the card: about two blocks
    (lane, KV head, split) per SM, at least one tile per split."""
    tiles = max(1, -(-limit // DECODE_TILE))
    want = max(1, -(-2 * sms // (B * kvh)))
    chunk = DECODE_TILE * -(-tiles // min(want, tiles))
    return max(1, -(-limit // chunk)), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_scratch(limit, B, H, Dh, kvh, dev):
    """(nsplit, chunk, f32 scratch of the per-split partials)."""
    nsplit, chunk = decode_splits(limit, B, kvh, _sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    part = torch.empty(B * H * nsplit * (Dh + 2), dtype=torch.float32,
                       device=dev)
    return nsplit, chunk, part


# ----------------------------------------------------------------------
# Flash decode over the contiguous packed cache
# ----------------------------------------------------------------------

def _flash_decode_contract(q, k_codes, k_scales, v_codes, v_scales,
                           fmt: str) -> bool:
    """Does the packed KV meet the flash-decode kernel contract?"""
    if fmt not in _pk.KV_FMTS:
        return False
    if q.ndim != 3 or k_codes.ndim != 3 or k_scales.ndim != 3:
        return False
    B, H, Dh = q.shape
    bits = _pk.kv_fmt_bits(fmt)
    D = k_codes.shape[2] * 8 // bits
    if D % 32 != 0 or Dh == 0 or D % Dh != 0 or H % (D // Dh) != 0:
        return False
    return (k_codes.shape[0] == B
            and tuple(k_scales.shape) == (B, k_codes.shape[1], D // 32)
            and v_codes.shape == k_codes.shape
            and v_scales.shape == k_scales.shape)


@_public
def mx_flash_decode(q, k_codes, k_scales, v_codes, v_scales, q_pos, kv_len,
                    fmt: str = "mxfp8", window: int = 0) -> torch.Tensor:
    """Flash-decode attention over a contiguous packed MX KV cache.

    q (B, H, Dh) float — one decode token per lane; k/v_codes (B, S,
    D*bits/8) uint8 and k/v_scales (B, S, D//32) uint8 E8M0 bytes — the
    ``PackedKV`` layout (D = n_kv_heads * Dh); q_pos / kv_len (B,) int32
    (scalars broadcast). Keys are contiguous from position 0. Returns
    (B, H, Dh) float32. ``window`` > 0 masks keys at ``pos <= q_pos -
    window``. The plain version attends the cache as one block (the
    Pallas kernel's default under interpret mode)."""
    if not _flash_decode_contract(q, k_codes, k_scales, v_codes, v_scales,
                                  fmt):
        raise ValueError(
            f"mx_flash_decode contract violation: q {tuple(q.shape)}, "
            f"k_codes {tuple(k_codes.shape)}, k_scales "
            f"{tuple(k_scales.shape)}, v_codes {tuple(v_codes.shape)}, "
            f"v_scales {tuple(v_scales.shape)}, fmt={fmt!r}. Expected q "
            f"(B, H, Dh); codes (B, S, D*bits/8) with D % 32 == 0, "
            f"D % Dh == 0 and H divisible by the kv-head count D/Dh; "
            f"scales (B, S, D//32); V shapes matching K; fmt one of "
            f"{_pk.KV_FMTS}.")
    if not _on_card(q, k_codes, k_scales, v_codes, v_scales):
        return ref.mx_attention_ref(q, k_codes, k_scales, v_codes, v_scales,
                                    q_pos, kv_len, fmt, window)
    B, H, Dh = q.shape
    S = k_codes.shape[1]
    D = k_scales.shape[2] * 32
    dev = q.device
    qf = q.float().contiguous()
    qp = _lane_vec(q_pos, B, dev)
    kl = _lane_vec(kv_len, B, dev)
    kc, vc = _aligned(k_codes, torch.uint8), _aligned(v_codes, torch.uint8)
    ks, vs = k_scales.contiguous(), v_scales.contiguous()
    nsplit, chunk, part = _decode_scratch(S, B, H, Dh, D // Dh, dev)
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=dev)
    rc = build.kernel("mx_flash_decode")(
        _ptr(qf), _ptr(kc), _ptr(ks), _ptr(vc), _ptr(vs), _ptr(qp),
        _ptr(kl), _ptr(part), _ptr(out), B, H, Dh, D, S, _fmt_id(fmt),
        int(window), chunk, nsplit, _stream())
    _check(rc, "mx_flash_decode")
    launches["mx_flash_decode"] += 1
    return out


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


@_public
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
    kc, vc = _aligned(k_codes, torch.uint8), _aligned(v_codes, torch.uint8)
    ks, vs = k_scales.contiguous(), v_scales.contiguous()
    maxp = bt.shape[1]
    nsplit, chunk, part = _decode_scratch(maxp * P, B, H, Dh, D // Dh, dev)
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=dev)
    rc = build.kernel("mx_flash_decode_paged")(
        _ptr(qf), _ptr(kc), _ptr(ks), _ptr(vc), _ptr(vs), _ptr(bt),
        _ptr(qp), _ptr(kl), _ptr(part), _ptr(out), B, H, Dh, D, P, maxp,
        _fmt_id(fmt), int(window), chunk, nsplit, _stream())
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


@_public
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
    write-then-read exact.

    On the card one call launches three kernels (``csrc/mx_prefill.cu``):
    ``kv_quant_kernel`` twice, encoding the chunk's K and V into the byte
    outputs, then ``flash_prefill_kernel``, the attention on the tensor
    cores. It takes Dh a multiple of 16 up to 128, at most 128 query heads
    per KV head and pages of a multiple of 16 rows, and raises on any other
    shape."""
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
    qf = _aligned(q, torch.float32)
    kd, vd = _aligned(k_chunk, torch.float32), _aligned(v_chunk,
                                                         torch.float32)
    bt = block_tables.to(torch.int32).contiguous()
    st = _lane_vec(q_start, B, dev)
    kl = _lane_vec(kv_len, B, dev)
    kcp, vcp = _aligned(k_codes, torch.uint8), _aligned(v_codes, torch.uint8)
    ksp, vsp = _aligned(k_scales, torch.uint8), _aligned(v_scales,
                                                          torch.uint8)
    out = torch.empty((B, C, H, Dh), dtype=torch.float32, device=dev)
    kc = torch.empty((B, C, db), dtype=torch.uint8, device=dev)
    ks = torch.empty((B, C, D // 32), dtype=torch.uint8, device=dev)
    vc = torch.empty_like(kc)
    vs = torch.empty_like(ks)
    rc = build.kernel("mx_flash_prefill")(
        _ptr(qf), _ptr(kd), _ptr(vd), _ptr(kcp), _ptr(ksp), _ptr(vcp),
        _ptr(vsp), _ptr(bt), _ptr(st), _ptr(kl), _ptr(out), _ptr(kc),
        _ptr(ks), _ptr(vc), _ptr(vs), B, C, H, Dh, D, P, bt.shape[1],
        _fmt_id(fmt), int(window), _stream())
    _check(rc, "mx_flash_prefill")
    launches["mx_flash_prefill"] += 1
    return out, kc, ks, vc, vs


# re-exported oracle
quantize_weight_for_kernel = ref.quantize_weight_for_kernel
