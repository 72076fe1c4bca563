#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order (each raises on failure; nothing is caught):

1. card facts: ``nvidia-smi`` name and power limit, torch / CUDA versions,
   the build of the six CUDA sources in ``src/repro_torch/kernels/csrc``;
2. kernels: each of the seven kernels against its plain PyTorch version on
   the card, at the Qwen2-0.5B shapes of the serving path (the packed GEMM
   at the decode shape M = 4, the prefill shape M = 4096, and the main
   path's chunk and wave prefill rows, M = 1024 and 5296, at (896, 4864);
   the flash-prefill on 1024-row and on 64-row pages, and again at
   Qwen2-7B's heads, 28 over 4 KV heads of 128), with the times of
   the kernel, the plain version and one PyTorch library
   call (where one computes the same function) — device time from
   ``torch.profiler``, and per call with the wrapper included by CUDA
   events — and the least time the card could take (``bound_ms``);
3. end to end: Qwen2-0.5B at its published widths (24 layers, random
   weights from a seed, RTN mxfp4 with the T3 rotation) exported as an
   artifact and served by ``Engine.from_artifact`` (fused backend, mxfp8
   KV cache, 4 lanes) three ways, each with the launch counts zeroed just
   before and read just after: the engine's default path (wave scheduler,
   contiguous cache), the continuous scheduler on the contiguous cache,
   and the continuous scheduler on the paged cache with two requests that
   share a one-page prefix. A ``torch.profiler`` breakdown of a wave run
   and of a paged run; the host and device time of a decode step and of
   a full prefill at the wave's shape; the first prefill and one decode
   step of each
   layout again with every kernel call held against its plain version on
   the same inputs; the paged path's fused logits and greedy tokens
   compared with the reference backend's. Then a fourth path: Qwen2-7B at
   its published widths, its depth cut to 4 of 28 layers, served the same
   way on the paged cache (continuous scheduler), with the same checks, a
   profile and a prefill and decode step held call by call against the
   plain versions;
4. the standalone kernel entry points (``ops.mx_quantize``,
   ``ops.t3_quantize``, ``ops.mx_gemm``) driven as a caller would, on a
   weight and activations of the served model's widths;
5. sampling and speculative decoding on phase 3's Qwen2-0.5B engines:
   the threefry integers and uniforms on the card bitwise equal to the
   CPU's; temperature 0 giving phase 3's greedy tokens on all three
   paths; a seeded sampled run (temperature 0.8, top-k 50, top-p 0.95)
   replayed token for token on the paged path; spec decoding at k = 3
   (verify M = 16) and k = 4 (M = 20) on both continuous layouts against
   non-spec greedy on repetition-friendly prompts (first divergence and
   its top-2 margin, acceptance, tok/s, GEMM launches per verify step),
   the verify logits against a sequential decode of the same tokens
   (bar: 1e-2 of max |logit|), and the packed GEMM timed at M = 16 and
   20 (run beside phase 2, while the profiler records every event).

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside this file, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FP8 = 1979e12               # dense tensor-core rates, H100 SXM
PEAK_BF16 = 989e12

PEAK_F32 = 67e12                 # CUDA cores, outside the tensor cores

TPU_KERNEL = {   # the Pallas kernel each CUDA kernel replaces (def line)
    "mx_gemm_packed": "src/repro/kernels/mx_matmul.py:170",
    "mx_flash_prefill": "src/repro/kernels/mx_attention.py:478",
    "mx_flash_decode_paged": "src/repro/kernels/mx_attention.py:270",
    "mx_flash_decode": "src/repro/kernels/mx_attention.py:180",
    "mx_quantize": "src/repro/kernels/mx_quant.py:72",
    "t3_quantize": "src/repro/kernels/hadamard_quant.py:46",
    "mx_gemm": "src/repro/kernels/mx_matmul.py:96",
}
SOURCE = {
    "mx_gemm_packed": "src/repro_torch/kernels/csrc/mx_gemm.cu",
    "mx_flash_prefill": "src/repro_torch/kernels/csrc/mx_prefill.cu",
    "mx_flash_decode_paged": "src/repro_torch/kernels/csrc/mx_decode_paged.cu",
    "mx_flash_decode": "src/repro_torch/kernels/csrc/mx_decode.cu",
    "mx_quantize": "src/repro_torch/kernels/csrc/mx_quant.cu",
    "t3_quantize": "src/repro_torch/kernels/csrc/mx_quant.cu",
    "mx_gemm": "src/repro_torch/kernels/csrc/mx_matmul.cu",
}
MX_FMTS = ("mxfp4", "mxint4", "mxfp6", "mxfp8", "mxint8")
PAGED_KERNELS = ("mx_gemm_packed", "mx_flash_prefill", "mx_flash_decode_paged")
# the port's CUDA kernels as the profiler names them
PORT_KERNELS = ("mxgemv::", "mxgemm::", "mxdecode::", "flash_prefill_kernel",
                "kv_quant_kernel")


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events (warm L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(torch, fn, iters: int, warmup: int = 3,
              exact: bool = True) -> float:
    """Mean device milliseconds per call of ``fn``: the durations
    ``torch.profiler`` records for the CUDA kernels (and memory copies and
    sets) that ``iters`` calls launched, summed, over ``iters``. Unlike
    :func:`cuda_ms` this leaves out the host's time between launches. With
    ``exact``, every call launches the same kernels, so a record whose
    count of device events is not a multiple of ``iters`` lost some: it is
    taken again. A whole decode step is thousands of operations, of which
    the profiler may drop a few (seen on an H100: 27711 to 27714 events for
    10 steps); it passes ``exact=False`` and takes the sum as recorded."""
    return sum(device_split(torch, fn, iters, warmup, exact).values())


def device_split(torch, fn, iters: int, warmup: int = 3,
                 exact: bool = True) -> dict:
    """:func:`device_ms` by kernel: {short kernel name (no namespace,
    template arguments or parameters): mean device ms per call}."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    counts = []
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        counts.append(len(dev))
        if dev and (not exact or len(dev) % iters == 0):
            out: dict = {}
            for e in dev:
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].split("<")[0].split("::")[-1]
                name = name.split()[-1] if name.split() else e.name
                out[name] = (out.get(name, 0.0)
                             + e.device_time_total / 1e3 / iters)
            return out
    raise AssertionError(f"the profiler's device events ({counts}) are not "
                         f"a multiple of the {iters} calls")


def measure(torch, fn, iters: int):
    """(device ms per call, ms per call with the wrapper included). The
    kernels of one stream cannot take longer than the wall time of their
    calls, so a device reading above the events' figure by more than 2% is
    a bad record: it is logged and both are taken again, and three bad
    pairs in a row fail the run."""
    for _ in range(3):
        wall = cuda_ms(torch, fn, iters)
        dev = device_ms(torch, fn, iters)
        if dev <= 1.02 * wall:
            return dev, wall
        log(f"  discarded: device reading {dev:.4f} ms per call above the "
            f"{wall:.4f} ms per call by events")
    raise AssertionError("three device readings above their calls' wall "
                         "time: the profiler's record is not usable")


def timed(torch, label, kernel, plain, library, iters, plain_iters):
    """Time a kernel call, its plain version and (where there is one) the
    library call both ways; logs them, returns the JSON fields."""
    ms, ms_w = measure(torch, kernel, iters)
    pl, pl_w = measure(torch, plain, plain_iters)
    lib, lib_w = (None, None) if library is None else measure(
        torch, library, iters)
    fmt = lambda v: "none" if v is None else f"{v:.4f}"  # noqa: E731
    log(f"{label}: device kernel_ms {ms:.4f} plain_ms {pl:.4f} library_ms "
        f"{fmt(lib)}; per call, wrapper included: kernel {ms_w:.4f} plain "
        f"{pl_w:.4f} library {fmt(lib_w)}")
    return {"ms": ms, "plain_ms": pl, "library_ms": lib,
            "wrapper_ms": {"kernel": ms_w, "plain": pl_w, "library": lib_w}}


def bound_ms(nbytes: float, flops: float, peak: float):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# phase 1: card facts and the kernel build
# ---------------------------------------------------------------------------

def card_facts(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        f"(per source: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in build.build_seconds.items()) + ")")
    return card


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_gemm(torch, dev, gen):
    cases = [(m, k, n, t3) for m in (4, 4096)
             for (k, n, t3) in ((896, 896, False), (896, 128, False),
                                (896, 4864, False), (4864, 896, True))]
    # the main path's continuous chunk and wave (4 lanes x 1324) prefills
    cases += [(1024, 896, 4864, False), (5296, 896, 4864, False)]
    entries = []
    for M, K, N, t3 in cases:
        e = gemm_case(torch, dev, gen, M, K, N, t3)
        if (K, N) == (896, 4864) and M in (4, 4096):
            entries.append(e)
    return entries


def gemm_case(torch, dev, gen, M, K, N, t3):
    """mx_gemm_packed at one shape: checked against its plain version (and
    a second call, bitwise), timed beside the plain version and f32
    ``torch.matmul``; returns its ``kernels`` entry."""
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels import ops, packing, ref
    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
    pw = packing.PackedWeight.from_dense(w)
    y = ops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
    y2 = ops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
    yp = ref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
    torch.cuda.synchronize()
    err = (y - yp).abs().max().item()
    tol = 1e-4 * yp.abs().max().item()
    same = torch.equal(y, y2)
    log(f"gemm M={M} K={K} N={N} t3={t3}: max_abs_err {err:.3e} "
        f"(tol {tol:.3e}); two calls bitwise equal: {same}")
    if not err <= tol:
        raise AssertionError(f"mx_gemm_packed disagrees with its plain "
                             f"version at M={M} K={K} N={N} t3={t3}")
    if not same:
        raise AssertionError(f"mx_gemm_packed is not repeatable at M={M} "
                             f"K={K} N={N}")
    iters = 200 if M == 4 else 20
    xq = mxlib.quantize(x)
    wd = pw.to_dense()
    t = timed(torch, f"gemm M={M} K={K} N={N} t3={t3}",
              lambda: ops.mx_gemm_packed(x, pw.codes_packed,
                                         pw.scales_e8m0, t3=t3),
              lambda: ref.mx_matmul_packed_ref(
                  x, pw.codes_packed, pw.scales_e8m0, t3=t3),
              lambda: torch.matmul(xq, wd), iters, max(iters // 4, 5))
    nbytes = M * K * 4 + K * N // 2 + K * N // 32 + M * N * 4
    b, by = bound_ms(nbytes, 2.0 * M * N * K, PEAK_FP8)
    log(f"gemm M={M} K={K} N={N} t3={t3}: bound_ms {b:.4f} ({by}), "
        f"share of the bound {b / t['ms']:.3f}")
    return {"name": "mx_gemm_packed", "shape": f"M={M} K={K} N={N} t3={t3}",
            "max_abs_err": err, **t, "bound_ms": b, "bound_by": by}


def _paged_pool(torch, dev, gen, n_pages, P, D, fmt):
    from repro_torch.kernels import packing
    k = torch.randn(n_pages, P, D, generator=gen, device=dev)
    v = torch.randn(n_pages, P, D, generator=gen, device=dev)
    kc, ks = packing.kv_encode(k, fmt)
    vc, vs = packing.kv_encode(v, fmt)
    return kc, ks, vc, vs


def _tables(torch, dev, gen, B, maxp, n_pages, fills, P):
    """Scattered page ids per lane; slots past a lane's fill park on the
    scrap page 0, as the engine's tables do."""
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm[:B * maxp].reshape(B, maxp).to(torch.int32)
    for b, f in enumerate(fills):
        bt[b, -(-f // P):] = 0
    return bt.contiguous()


def _sdpa_inputs(torch, kc, ks, vc, vs, bt, fmt, kvh, Dh, G):
    from repro_torch.kernels import packing
    k = packing.PagedKV(kc, ks, fmt).gather_dense(bt)
    v = packing.PagedKV(vc, vs, fmt).gather_dense(bt)
    B, S, _ = k.shape

    def heads(t):
        t = t.reshape(B, S, kvh, Dh).transpose(1, 2)
        return t.repeat_interleave(G, dim=1).contiguous()
    return heads(k), heads(v)


def check_decode(torch, dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, packing, ref
    B, H, kvh, Dh, P, maxp = 4, 14, 2, 64, 1024, 2
    D, G, n_pages = kvh * Dh, H // kvh, 1 + 4 * maxp
    kv_len = [1330, 1180, 250, 140]
    bt = _tables(torch, dev, gen, B, maxp, n_pages, kv_len, P)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qp = kl - 1
    q = torch.randn(B, H, Dh, generator=gen, device=dev)
    entry = None
    for fmt in ("mxfp8", "mxint8", "mxfp4", "mxint4"):
        kc, ks, vc, vs = _paged_pool(torch, dev, gen, n_pages, P, D, fmt)
        for window in (0, 300):
            out = ops.mx_flash_decode_paged(q, kc, ks, vc, vs, bt, qp, kl,
                                            fmt, window=window)
            outp = ref.mx_attention_paged_ref(q, kc, ks, vc, vs, bt, qp, kl,
                                              fmt, window=window)
            torch.cuda.synchronize()
            err = (out - outp).abs().max().item()
            log(f"decode {fmt} window={window}: max_abs_err {err:.3e}")
            if not err <= 1e-4:
                raise AssertionError(f"mx_flash_decode_paged disagrees with "
                                     f"its plain version ({fmt}, window "
                                     f"{window})")
            if window:
                continue
            kd, vd = _sdpa_inputs(torch, kc, ks, vc, vs, bt, fmt, kvh, Dh, G)
            S = kd.shape[2]
            kp = torch.arange(S, device=dev)
            mask = (kp[None, :] < kl[:, None].long())[:, None, None, :]
            q4 = q[:, :, None, :].contiguous()
            t = timed(torch, f"decode {fmt} B={B} kv_len={kv_len}",
                      lambda: ops.mx_flash_decode_paged(
                          q, kc, ks, vc, vs, bt, qp, kl, fmt),
                      lambda: ref.mx_attention_paged_ref(
                          q, kc, ks, vc, vs, bt, qp, kl, fmt),
                      lambda: F.scaled_dot_product_attention(
                          q4, kd, vd, attn_mask=mask), 200, 20)
            row = D * packing.kv_fmt_bits(fmt) // 8 + D // 32
            nbytes = (2 * B * H * Dh * 4 + 2 * sum(kv_len) * row
                      + bt.numel() * 4 + 2 * B * 4)
            b, by = bound_ms(nbytes, 4.0 * H * Dh * sum(kv_len), PEAK_BF16)
            log(f"decode {fmt} B={B} kv_len={kv_len}: bound_ms {b:.4f} "
                f"({by})")
            if fmt == "mxfp8":
                entry = {"name": "mx_flash_decode_paged",
                         "shape": f"B={B} H={H} kvh={kvh} Dh={Dh} P={P} "
                                  f"kv_len={kv_len} {fmt}",
                         "max_abs_err": err, **t, "bound_ms": b,
                         "bound_by": by}
    return entry


def check_prefill(torch, dev, gen, seed: int):
    """The flash-prefill at Qwen2-0.5B's heads (14 over 2 KV heads of 64) on
    1024-row pages (2 table slots, the served model's page at attn_chunk
    1024) and on 64-row pages (32 slots, the engine's page at attn_chunk
    64), then at Qwen2-7B's (28 over 4 KV heads of 128) on both. The second
    draws from its own generator and the two at Qwen2-7B's heads from
    another, so every check after keeps its inputs."""
    gen64 = torch.Generator(device=dev).manual_seed(seed + 64)
    gen7b = torch.Generator(device=dev).manual_seed(seed + 128)
    return [_prefill_pages(torch, dev, gen, 1024, 2),
            _prefill_pages(torch, dev, gen64, 64, 32),
            _prefill_pages(torch, dev, gen7b, 1024, 2, H=28, kvh=4, Dh=128),
            _prefill_pages(torch, dev, gen7b, 64, 32, H=28, kvh=4, Dh=128)]


def _prefill_pages(torch, dev, gen, P, maxp, H=14, kvh=2, Dh=64):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B, C = 4, 1024
    D, G, n_pages = kvh * Dh, H // kvh, 1 + 4 * maxp
    entry = None
    for fmt, starts in (("mxfp8", [0, 1024, 0, 0]), ("mxfp8", [512, 0, 0, 7]),
                        ("mxint8", [0, 1024, 0, 0]), ("mxfp4", [0, 1024, 0, 0]),
                        ("mxint4", [0, 1024, 0, 0])):
        kc, ks, vc, vs = _paged_pool(torch, dev, gen, n_pages, P, D, fmt)
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        kl = st + C
        bt = _tables(torch, dev, gen, B, maxp, n_pages,
                     [s + C for s in starts], P)
        q = torch.randn(B, C, H, Dh, generator=gen, device=dev)
        kd = torch.randn(B, C, D, generator=gen, device=dev)
        vd = torch.randn(B, C, D, generator=gen, device=dev)
        outs = ops.mx_flash_prefill(q, kd, vd, kc, ks, vc, vs, bt, st, kl, fmt)
        plains = ref.mx_prefill_ref(q, kd, vd, kc, ks, vc, vs, bt, st, kl, fmt)
        torch.cuda.synchronize()
        err = (outs[0] - plains[0]).abs().max().item()
        same = all(torch.equal(a, b) for a, b in zip(outs[1:], plains[1:]))
        log(f"prefill {fmt} q_start={starts} P={P} Dh={Dh}: max_abs_err "
            f"{err:.3e}, chunk bytes equal to kv_encode: {same}")
        if not (err <= 1e-4 and same):
            raise AssertionError(f"mx_flash_prefill disagrees with its plain "
                                 f"version ({fmt}, q_start {starts}, P {P}, "
                                 f"Dh {Dh})")
        if fmt != "mxfp8" or starts[1] != 1024:
            continue
        # library yardstick: SDPA over the decoded logical cache, with the
        # chunk's round-tripped rows in place and a causal + fill mask
        from repro_torch.kernels import packing
        kcl, vcl = kc.clone(), vc.clone()
        ksl, vsl = ks.clone(), vs.clone()
        from repro_torch.models.layers import kv_scatter_chunk_paged
        kv_scatter_chunk_paged(packing.PagedKV(kcl, ksl, fmt), outs[1],
                               outs[2], bt, st)
        kv_scatter_chunk_paged(packing.PagedKV(vcl, vsl, fmt), outs[3],
                               outs[4], bt, st)
        kh, vh = _sdpa_inputs(torch, kcl, ksl, vcl, vsl, bt, fmt, kvh, Dh, G)
        S = kh.shape[2]
        kp = torch.arange(S, device=dev)
        qpos = st[:, None].long() + torch.arange(C, device=dev)[None, :]
        mask = ((kp[None, None, :] <= qpos[:, :, None])
                & (kp[None, None, :] < kl[:, None, None].long()))[:, None]
        qh = q.transpose(1, 2).contiguous()
        t = timed(torch, f"prefill {fmt} B={B} C={C} H={H} kvh={kvh} "
                         f"Dh={Dh} q_start={starts} P={P}",
                  lambda: ops.mx_flash_prefill(q, kd, vd, kc, ks, vc, vs, bt,
                                               st, kl, fmt),
                  lambda: ref.mx_prefill_ref(q, kd, vd, kc, ks, vc, vs, bt,
                                             st, kl, fmt),
                  lambda: F.scaled_dot_product_attention(
                      qh, kh, vh, attn_mask=mask), 20, 3)
        row = D + D // 32
        nbytes = (2 * B * C * H * Dh * 4 + 2 * B * C * D * 4
                  + 2 * B * C * row + 2 * sum(starts) * row + bt.numel() * 4)
        keys = sum(C * s + C * (C + 1) // 2 for s in starts)
        b, by = bound_ms(nbytes, 4.0 * H * Dh * keys, PEAK_BF16)
        log(f"prefill {fmt} B={B} C={C} H={H} kvh={kvh} Dh={Dh} "
            f"q_start={starts} P={P}: bound_ms {b:.4f} ({by}), share of the "
            f"bound {b / t['ms']:.3f}")
        # launches: those of the served path at these heads
        entry = {"name": "mx_flash_prefill",
                 "shape": f"B={B} C={C} H={H} kvh={kvh} Dh={Dh} P={P} "
                          f"q_start={starts} {fmt}",
                 "max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
                 "path": "paged" if Dh == 64 else "paged_qwen2_7b"}
    return entry


def check_flash_decode(torch, dev, gen):
    """The contiguous-cache flash decode at the paged check's shape: B = 4
    lanes of a 2048-row cache filled to [1330, 1180, 250, 140]."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, packing, ref
    B, H, kvh, Dh, S = 4, 14, 2, 64, 2048
    D, G = kvh * Dh, H // kvh
    kv_len = [1330, 1180, 250, 140]
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qp = kl - 1
    q = torch.randn(B, H, Dh, generator=gen, device=dev)
    entry = None
    for fmt in ("mxfp8", "mxint8", "mxfp4", "mxint4"):
        kc, ks = packing.kv_encode(torch.randn(B, S, D, generator=gen,
                                               device=dev), fmt)
        vc, vs = packing.kv_encode(torch.randn(B, S, D, generator=gen,
                                               device=dev), fmt)
        for window in (0, 300):
            out = ops.mx_flash_decode(q, kc, ks, vc, vs, qp, kl, fmt,
                                      window=window)
            outp = ref.mx_attention_ref(q, kc, ks, vc, vs, qp, kl, fmt,
                                        window=window)
            torch.cuda.synchronize()
            err = (out - outp).abs().max().item()
            log(f"flash_decode {fmt} window={window}: max_abs_err {err:.3e}")
            if not err <= 1e-5:
                raise AssertionError(f"mx_flash_decode disagrees with its "
                                     f"plain version ({fmt}, window "
                                     f"{window})")
            if window:
                continue

            def heads(c, sc):
                t = packing.kv_decode(c, sc, fmt).reshape(B, S, kvh, Dh)
                return t.transpose(1, 2).repeat_interleave(G, dim=1) \
                    .contiguous()
            kd, vd = heads(kc, ks), heads(vc, vs)
            kp = torch.arange(S, device=dev)
            mask = (kp[None, :] < kl[:, None].long())[:, None, None, :]
            q4 = q[:, :, None, :].contiguous()
            t = timed(torch, f"flash_decode {fmt} B={B} S={S} "
                             f"kv_len={kv_len}",
                      lambda: ops.mx_flash_decode(q, kc, ks, vc, vs, qp, kl,
                                                  fmt),
                      lambda: ref.mx_attention_ref(q, kc, ks, vc, vs, qp, kl,
                                                   fmt),
                      lambda: F.scaled_dot_product_attention(
                          q4, kd, vd, attn_mask=mask), 200, 20)
            row = D * packing.kv_fmt_bits(fmt) // 8 + D // 32
            nbytes = 2 * B * H * Dh * 4 + 2 * sum(kv_len) * row + 2 * B * 4
            b, by = bound_ms(nbytes, 4.0 * H * Dh * sum(kv_len), PEAK_BF16)
            log(f"flash_decode {fmt} B={B} S={S} kv_len={kv_len}: bound_ms "
                f"{b:.4f} ({by})")
            if fmt == "mxfp8":
                entry = {"name": "mx_flash_decode",
                         "shape": f"B={B} H={H} kvh={kvh} Dh={Dh} S={S} "
                                  f"kv_len={kv_len} {fmt}",
                         "max_abs_err": err, **t, "bound_ms": b,
                         "bound_by": by}
    return entry


def _spread(torch, gen, dev, M, K):
    """Normal values whose 32-blocks span several binades."""
    x = torch.randn(M, K, generator=gen, device=dev)
    e = torch.randint(-3, 6, (M, K // 32, 1), generator=gen,
                      device=dev).float()
    return (x.reshape(M, K // 32, 32) * torch.exp2(e)).reshape(M, K)


def check_quantizers(torch, dev, gen):
    """mx_quantize and t3_quantize at the ffn_down activation's widths,
    byte-equal to their plain versions in every MX format. No single
    PyTorch call computes an MX encode, so library_ms is null."""
    from repro_torch.kernels import ops, ref
    entries = []
    for name, kernel, plain_fn, t3 in (
            ("mx_quantize", ops.mx_quantize, ref.mx_quant_ref, False),
            ("t3_quantize", ops.t3_quantize, ref.hadamard_quant_ref, True)):
        for M, K in ((4096, 4864), (4, 4864)):
            x = _spread(torch, gen, dev, M, K)
            for fmt in MX_FMTS:
                c, sc = kernel(x, fmt)
                cp, sp = plain_fn(x, fmt)
                torch.cuda.synchronize()
                same = torch.equal(c, cp) and torch.equal(sc, sp)
                if not same:
                    n = int((c != cp).sum()) + int((sc != sp).sum())
                    raise AssertionError(f"{name} ({M}, {K}) {fmt}: {n} "
                                         f"bytes differ from the plain "
                                         f"version")
            iters = 200 if M == 4 else 20
            log(f"{name} ({M}, {K}): codes and scales byte-equal to the "
                f"plain version in {', '.join(MX_FMTS)}")
            t = timed(torch, f"{name} ({M}, {K}) mxfp4",
                      lambda: kernel(x, "mxfp4"),
                      lambda: plain_fn(x, "mxfp4"), None, iters,
                      max(iters // 4, 5))
            nbytes = M * K * 4 + M * K + M * (K // 32) * 4
            flops = M * K * (2 + (64 if t3 else 0))
            b, by = bound_ms(nbytes, flops, PEAK_F32)
            log(f"{name} ({M}, {K}): bound_ms {b:.4f} ({by})")
            if M == 4096:
                entries.append({
                    "name": name, "shape": f"M={M} K={K} mxfp4 (bytes "
                    f"checked in {'/'.join(MX_FMTS)})", "max_abs_err": 0.0,
                    **t, "bound_ms": b, "bound_by": by})
    return entries


def check_unpacked_gemm(torch, dev, gen):
    """mx_gemm (one code byte per weight, f32 scales) at M = 4 and 4096 with
    (K, N) = (896, 4864), mxfp4 and mxfp8, held within 1e-5 of max |y| of
    its plain version; library: torch.matmul on dequantized f32
    operands."""
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels import ops, ref
    K, N = 896, 4864
    entry = None
    for fmt in ("mxfp4", "mxfp8"):
        w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
        wc, ws = ref.mx_quant_ref(w.T.contiguous(), fmt)
        wc, ws = wc.T.contiguous(), ws.T.contiguous()
        for M in (4, 4096):
            x = torch.randn(M, K, generator=gen, device=dev)
            y = ops.mx_gemm(x, wc, ws, fmt)
            yp = ref.mx_matmul_ref(x, wc, ws, fmt)
            torch.cuda.synchronize()
            err = (y - yp).abs().max().item()
            tol = 1e-5 * yp.abs().max().item()
            log(f"mx_gemm M={M} K={K} N={N} {fmt}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"mx_gemm disagrees with its plain "
                                     f"version at M={M} {fmt}")
            iters = 200 if M == 4 else 20
            xq = mxlib.quantize(x, mxlib.MXConfig(fmt=fmt))
            wd = ref.mx_dequant_ref(wc.T, ws.T, fmt).T.contiguous()
            t = timed(torch, f"mx_gemm M={M} K={K} N={N} {fmt}",
                      lambda: ops.mx_gemm(x, wc, ws, fmt),
                      lambda: ref.mx_matmul_ref(x, wc, ws, fmt),
                      lambda: torch.matmul(xq, wd), iters,
                      max(iters // 4, 5))
            nbytes = M * K * 4 + K * N + (K // 32) * N * 4 + M * N * 4
            b, by = bound_ms(nbytes, 2.0 * M * N * K, PEAK_FP8)
            log(f"mx_gemm M={M} K={K} N={N} {fmt}: bound_ms {b:.4f} ({by}), "
                f"share of the bound {b / t['ms']:.3f}")
            if (M, fmt) == (4096, "mxfp4"):
                entry = {"name": "mx_gemm",
                         "shape": f"M={M} K={K} N={N} {fmt}",
                         "max_abs_err": err, **t, "bound_ms": b,
                         "bound_by": by}
    return entry


# ---------------------------------------------------------------------------
# phase 3: the serving path end to end at full width
# ---------------------------------------------------------------------------

def traffic(rng, vocab: int):
    """Four prompts: two share a 1024-token prefix (one page) with tails
    of 200 and 300 tokens, two stand alone at 150 and 250 tokens."""
    prefix = rng.integers(0, vocab, 1024).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, vocab, t)
                               .astype(np.int32)]) for t in (200, 300)]
    return prompts + [rng.integers(0, vocab, t).astype(np.int32)
                      for t in (150, 250)]


def profile_serving(torch, eng, Request, cfg, seed: int, label: str) -> None:
    """torch.profiler over a second serving run of the same shape (fresh
    prompts): device time by kernel name and the device's busy share of
    the wall time."""
    from torch.profiler import ProfilerActivity, profile
    reqs = [Request(prompt=p, max_new=32)
            for p in traffic(np.random.default_rng(seed + 1),
                             cfg.vocab_size)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(reqs)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile {label}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%), {len(rows)} kernel names")
    # the 15 largest, and every kernel of the port's below them
    for i, (ms, n, key) in enumerate(rows):
        if i < 15 or any(k in key for k in PORT_KERNELS):
            log(f"profile {label}: {ms:10.3f} ms {n:7d}x  {key[:90]}")


def decode_step_split(torch, transformer, params, cfg, qm, kv_quant, dev,
                      seed: int) -> None:
    """Host against device time of one decode step at the wave's shape:
    four lanes prefilled with 1324 tokens into a 2048-row cache, then
    fused decode steps. The wall time per step (synchronized after each)
    against the device time the profiler records per step: their
    difference is what the host adds."""
    rng = np.random.default_rng(seed + 2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 1324))
                           .astype(np.int32), device=dev)
    lg, cache = transformer.prefill(params, cfg, toks, qm, max_len=2048,
                                    kv_quant=kv_quant)
    state = {"tok": lg.argmax(dim=-1).to(torch.int32), "pos": 1324,
             "cache": cache}

    def step():
        lg, state["cache"] = transformer.decode(params, cfg, state["cache"],
                                                state["tok"], state["pos"],
                                                qm)
        state["tok"] = lg.argmax(dim=-1).to(torch.int32)
        state["pos"] += 1

    n = 10
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    busy = device_ms(torch, step, n, warmup=0, exact=False)
    log(f"decode step, wave shape (4 lanes at fill 1337+, contiguous mxfp8, "
        f"fused, {cfg.n_layers} layers): wall {wall:.3f} ms, device "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}% busy), host adds "
        f"{wall - busy:.3f} ms")


def prefill_step_split(torch, transformer, params, cfg, qm, kv_quant, dev,
                       seed: int) -> None:
    """Host against device time of one full prefill at the wave's shape:
    four lanes of 1324 tokens into a 2048-row contiguous cache, fused, all
    layers. The wall time per prefill (synchronized after each) against the
    device time the profiler records for it, and that device time by
    kernel name."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(seed + 3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 1324))
                           .astype(np.int32), device=dev)

    def run():
        transformer.prefill(params, cfg, toks, qm, max_len=2048,
                            kv_quant=kv_quant)

    n = 3
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    gemm = sum(r[0] for r in rows if "mxgemm::" in r[2])
    log(f"prefill step, wave shape (4 lanes x 1324 tokens, contiguous "
        f"mxfp8, fused, {cfg.n_layers} layers): wall {wall:.3f} ms, device "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}% busy), host adds "
        f"{wall - busy:.3f} ms; the packed GEMM's two kernels {gemm:.3f} ms")
    for ms, cnt, key in rows[:12]:
        log(f"prefill step: {ms:9.3f} ms {cnt:5d}x  {key[:90]}")


def serve(torch, Engine, Request, art, prompts, cfg, tag="", **kw):
    """One served run of ``prompts`` x 32 greedy tokens with the launch
    counts zeroed just before and read just after. Returns (engine,
    requests, launches, stats)."""
    from repro_torch.kernels import ops
    eng = Engine.from_artifact(art, backend="fused", **kw)
    reqs = [Request(prompt=p, max_new=32) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.launches)
    st = eng.stats()
    toks = sum(len(r.out) for r in reqs)
    label = f"{kw['scheduler']}/{kw['kv_layout']}{tag}"
    log(f"e2e {label}: {len(reqs)} requests, {toks} tokens in {dt:.3f} s = "
        f"{toks / dt:.1f} tok/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"e2e {label} stats: " + json.dumps({k: st[k] for k in (
        "admitted", "decode_steps", "slot_steps", "prefill_chunk_steps",
        "prefill_lane_steps", "prefill_batched_steps", "prefix_hit_tokens",
        "blocks_in_use")}) + f", kv_bytes_resident {eng.kv_bytes_resident()}")
    log(f"e2e {label} launches: {launches}")
    for r in reqs:
        if r.state.value != "finished" or len(r.out) != 32:
            raise AssertionError(f"request ended {r.state.value} with "
                                 f"{len(r.out)} tokens: {r.error}")
        if not ((r.out >= 0) & (r.out < cfg.vocab_size)).all():
            raise AssertionError("token ids outside the vocabulary")
    return eng, reqs, launches, st


def end_to_end(torch, dev, seed: int):
    import dataclasses

    from repro_torch import configs
    from repro_torch.artifacts import export_artifact, load_artifact
    from repro_torch.core import ptq
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine, Request

    cfg = configs.get("qwen2-0.5b")
    L = cfg.n_layers
    gemms_per_forward = 7 * L      # q, k, v, o, gate, up, down per layer
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = transformer.init(gen, cfg, device=dev)
    res = ptq.apply_method("rtn", params, cfg, fmt="mxfp4")
    # random weights carry no folded T3 inverse; the rotation still runs,
    # so the ffn_down prologue of the GEMM kernel is on the path
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    del params
    prompts = traffic(np.random.default_rng(seed), cfg.vocab_size)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        art = pathlib.Path(tmp) / "qwen2-0.5b-mxfp4"
        export_artifact(res, cfg, art)
        del res
        torch.cuda.synchronize()
        log(f"e2e: init + RTN + export {time.perf_counter() - t0:.1f} s "
            f"({L} layers)")
        params, _, qm = load_artifact(art, device=dev)
        common = dict(batch_size=4, max_len=2048, kv_cache="mxfp8",
                      device=dev)

        # the engine's default path: wave scheduler, contiguous cache
        eng, rw, lw, st = serve(torch, Engine, Request, art, prompts, cfg,
                               scheduler="wave", kv_layout="contiguous",
                               **common)
        check_contiguous_launches(lw, st, L, gemms_per_forward,
                                  1 + st["decode_steps"], "wave")
        launches["wave"] = lw
        profile_serving(torch, eng, Request, cfg, seed, "wave/contiguous")
        decode_step_split(torch, transformer, params, cfg,
                          qm.with_backend("fused"), eng.kv_quant, dev, seed)
        prefill_step_split(torch, transformer, params, cfg,
                           qm.with_backend("fused"), eng.kv_quant, dev, seed)
        del eng

        eng, rc, lc, st = serve(torch, Engine, Request, art, prompts, cfg,
                               scheduler="continuous",
                               kv_layout="contiguous", **common)
        check_contiguous_launches(
            lc, st, L, gemms_per_forward,
            st["prefill_chunk_steps"] + st["decode_steps"], "continuous")
        launches["continuous"] = lc
        del eng

        kw = dict(scheduler="continuous", kv_layout="paged", **common)
        eng, reqs, lp, st = serve(torch, Engine, Request, art, prompts, cfg,
                                  **kw)
        launches["paged"] = lp
    check_paged_run(eng, lp, st, L, "")
    profile_serving(torch, eng, Request, cfg, seed, "continuous/paged")

    # The first prefill and one decode step again, fused, with every kernel
    # call held against its plain version on the same inputs: the values
    # the reference backend computes at that call, at all layers.
    p0 = prompts[0]
    fused = qm.with_backend("fused")
    paged_teacher_forced(torch, transformer, params, cfg, qm, eng, p0, dev,
                         "")
    worst = teacher_forced(torch, ops, lambda q: contiguous_prefill_and_step(
        torch, transformer, params, cfg, q, eng.kv_quant, p0, dev), fused)
    log("e2e contiguous teacher-forced, worst error per kernel call: "
        + json.dumps(worst))
    ref_eng = Engine(params, cfg, qm.with_backend("ref"), **kw)
    ref_reqs = [Request(prompt=p, max_new=32) for p in prompts]
    ref_eng.generate(ref_reqs)
    agree = sum(int(a == b) for r, s in zip(reqs, ref_reqs)
                for a, b in zip(r.out.tolist(), s.out.tolist()))
    log(f"e2e: paged greedy tokens fused == ref: {agree}/"
        f"{sum(len(r.out) for r in reqs)}")
    del eng, ref_eng
    greedy = {name: [r.out for r in rs]
              for name, rs in (("wave", rw), ("continuous", rc),
                               ("paged", reqs))}
    launches["paged_qwen2_7b"] = qwen2_7b_path(torch, dev, seed)
    return launches, dict(params=params, cfg=cfg, qm=qm, prompts=prompts,
                          greedy=greedy)


def check_paged_run(eng, lp, st, L, tag):
    """A paged run served the shared prefix from cache, returned every page,
    launched each paged kernel, and the paged decode once per layer per
    decode step."""
    if st["prefix_hit_tokens"] <= 0:
        raise AssertionError(f"paged{tag}: the shared prefix was not served "
                             f"from cache")
    eng._alloc.check()
    if eng._alloc.in_use:
        raise AssertionError(f"paged{tag}: {eng._alloc.in_use} pages still "
                             f"in use")
    for name in PAGED_KERNELS:
        if lp[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"paged{tag} path")
    if lp["mx_flash_decode_paged"] != st["decode_steps"] * L:
        raise AssertionError(
            f"paged{tag}: decode kernel launched "
            f"{lp['mx_flash_decode_paged']}x, expected decode_steps x layers "
            f"= {st['decode_steps'] * L}")


def paged_teacher_forced(torch, transformer, params, cfg, qm, eng, prompt,
                         dev, tag):
    """The first prefill and one decode step of ``prompt`` on the paged
    cache, fused, with every kernel call held against its plain version;
    then the fused prefill logits against the reference backend's. An
    attention output that moves by 1e-7 flips an activation code at a grid
    midpoint downstream, and the flips compound layer by layer through
    random weights, so those logits are compared loosely (a wiring fault
    decorrelates them entirely)."""
    from repro_torch.kernels import ops
    P, C = eng.page_size, cfg.attn_chunk
    worst = teacher_forced(torch, ops, lambda q: prefill_and_step(
        torch, transformer, params, cfg, q, eng.kv_quant, P, C, prompt, dev),
        qm.with_backend("fused"))
    log(f"e2e paged{tag} teacher-forced, worst error per kernel call: "
        + json.dumps(worst))
    logits = {b: prefill_and_step(torch, transformer, params, cfg,
                                  qm.with_backend(b), eng.kv_quant, P, C,
                                  prompt, dev)[0] for b in ("fused", "ref")}
    diff = (logits["fused"] - logits["ref"]).abs().max().item()
    scale = logits["ref"].abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        logits["fused"], logits["ref"], dim=0).item()
    log(f"e2e{tag}: fused vs ref prefill logits max|diff| {diff:.4e}, "
        f"max|logit| {scale:.4e}, cosine {cos:.4f}, same argmax "
        f"{bool(logits['fused'].argmax() == logits['ref'].argmax())}")
    if not cos >= 0.5:
        raise AssertionError(f"paged{tag}: fused prefill logits are "
                             f"unrelated to ref")


QWEN2_7B_LAYERS = 4      # of its 28: the smoke's time and memory


def qwen2_7b_path(torch, dev, seed: int):
    """The paged path at Qwen2-7B's published widths (d_model 3584, 28 heads
    over 4 KV heads of 128, d_ff 18944, vocab 152064, untied head), its
    depth cut to QWEN2_7B_LAYERS: random weights from the seed, RTN mxfp4
    with the T3 rotation, exported and served by ``Engine.from_artifact``
    (continuous scheduler, paged mxfp8 cache, 4 lanes, max_len 2048) on
    ``traffic``'s prompts drawn from its vocabulary, 32 greedy tokens each,
    with the launch counts zeroed just before and read just after; the
    paged run's checks, a profile, and one prefill and decode step held
    call by call against the plain versions. Returns the launches."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.artifacts import export_artifact, load_artifact
    from repro_torch.core import ptq
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine, Request

    full = configs.get("qwen2-7b")
    cfg = dataclasses.replace(full, n_layers=QWEN2_7B_LAYERS)
    log(f"e2e qwen2-7b: reduced: depth {cfg.n_layers} of {full.n_layers} "
        f"layers (published widths otherwise)")
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    t0 = time.perf_counter()
    params = transformer.init(gen, cfg, device=dev)
    res = ptq.apply_method("rtn", params, cfg, fmt="mxfp4")
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    del params
    prompts = traffic(np.random.default_rng(seed), cfg.vocab_size)
    tag = " qwen2-7b"
    with tempfile.TemporaryDirectory() as tmp:
        art = pathlib.Path(tmp) / "qwen2-7b-mxfp4"
        export_artifact(res, cfg, art)
        del res
        torch.cuda.synchronize()
        log(f"e2e qwen2-7b: init + RTN + export "
            f"{time.perf_counter() - t0:.1f} s ({cfg.n_layers} layers)")
        params, _, qm = load_artifact(art, device=dev)
        eng, _, lp, st = serve(torch, Engine, Request, art, prompts, cfg,
                               tag=tag, scheduler="continuous",
                               kv_layout="paged", batch_size=4, max_len=2048,
                               kv_cache="mxfp8", device=dev)
    check_paged_run(eng, lp, st, cfg.n_layers, tag)
    profile_serving(torch, eng, Request, cfg, seed, "continuous/paged" + tag)
    paged_teacher_forced(torch, transformer, params, cfg, qm, eng,
                         prompts[0], dev, tag)
    return lp


def check_contiguous_launches(launches, st, L, gemms_per_forward, forwards,
                              label):
    """A contiguous run launches the contiguous flash decode once per layer
    per decode step, the packed GEMM 7 x layers times per forward, and
    nothing of the paged path or the standalone entry points."""
    want = {"mx_flash_decode": st["decode_steps"] * L,
            "mx_gemm_packed": gemms_per_forward * forwards}
    for name, n in launches.items():
        if launches[name] != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {n}x, expected "
                                 f"{want.get(name, 0)}")


def contiguous_prefill_and_step(torch, transformer, params, cfg, qm,
                                kv_quant, prompt, dev):
    """Full prefill of ``prompt`` into a fresh 2048-row contiguous cache,
    then one decode step of its greedy token at the shared position."""
    lg, cache = transformer.prefill(
        params, cfg, torch.as_tensor(prompt[None], device=dev), qm,
        max_len=2048, kv_quant=kv_quant)
    nxt = lg.argmax(dim=-1).to(torch.int32)
    lg2, _ = transformer.decode(params, cfg, cache, nxt, len(prompt), qm)
    return lg[0].float(), lg2[0].float()


def standalone_path(torch, dev, params):
    """The standalone entry points as a caller drives them: MX-encode the
    served model's first gate projection (896 x 4864, dequantized) into the
    unpacked layout with ``ops.mx_quantize``, multiply decode- and
    prefill-sized activations by it with ``ops.mx_gemm``, and run the
    online T3 quantizer on an ffn_down-wide activation. Counts zeroed just
    before, read just after."""
    from repro_torch.kernels import ops, ref
    w = params["blocks"]["wg"][0].to_dense()             # (K, N) f32
    gen = torch.Generator(device=dev).manual_seed(7)
    xs = [torch.randn(m, w.shape[0], generator=gen, device=dev)
          for m in (4, 4096)]
    h = torch.randn(4096, w.shape[1], generator=gen, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    codes, scales = ops.mx_quantize(w.T.contiguous(), "mxfp4")
    ys = [ops.mx_gemm(x, codes.T.contiguous(), scales.T.contiguous(),
                      "mxfp4") for x in xs]
    hc, hs = ops.t3_quantize(h, "mxfp4")
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    log(f"standalone path launches: {launches}")
    for name in ("mx_quantize", "t3_quantize", "mx_gemm"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on its path")
    # the artifact's weight is on the mxfp4 grid: re-encoding it is exact
    if not torch.equal(ref.mx_dequant_ref(codes, scales).T, w):
        raise AssertionError("mx_quantize did not reproduce the grid weight")
    for x, y in zip(xs, ys):
        yp = ref.mx_matmul_ref(x, codes.T, scales.T)
        if not (y - yp).abs().max() <= 1e-5 * yp.abs().max():
            raise AssertionError("mx_gemm on the model weight disagrees "
                                 "with its plain version")
    hcp, hsp = ref.hadamard_quant_ref(h, "mxfp4")
    if not (torch.equal(hc, hcp) and torch.equal(hs, hsp)):
        raise AssertionError("t3_quantize bytes differ from its plain "
                             "version")
    return launches


def prefill_and_step(torch, transformer, params, cfg, qm, kv_quant, P, C,
                     prompt, dev):
    """Chunked prefill of ``prompt`` into a fresh pool, then one decode
    step of its greedy token; returns (prefill logits, decode logits)."""
    cache = transformer.init_cache_paged(cfg, 3, P, kv_quant=kv_quant,
                                         device=dev)
    bt = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    for ci in range(-(-len(prompt) // C)):
        toks = np.zeros(C, np.int32)
        piece = prompt[ci * C:(ci + 1) * C]
        toks[:len(piece)] = piece
        lg, cache = transformer.prefill_chunk_paged(
            params, cfg, cache, bt, torch.as_tensor(toks[None], device=dev),
            ci * C, len(piece) - 1, qm)
    nxt = lg.argmax(dim=-1).to(torch.int32)
    lg2, _ = transformer.decode_paged(
        params, cfg, cache, nxt,
        torch.tensor([len(prompt)], dtype=torch.int32, device=dev), bt, qm)
    return lg[0].float(), lg2[0].float()


def teacher_forced(torch, ops, run, qm):
    """Run ``run(qm)`` with each kernel wrapper checked, call by call,
    against its plain version on the same inputs; raises on the first
    disagreement, returns the worst error seen per kernel called."""
    from repro_torch.kernels import ref
    plain = {"mx_gemm_packed": ref.mx_matmul_packed_ref,
             "mx_flash_prefill": ref.mx_prefill_ref,
             "mx_flash_decode_paged": ref.mx_attention_paged_ref,
             "mx_flash_decode": ref.mx_attention_ref}
    worst = {n: 0.0 for n in plain}
    saved = {n: getattr(ops, n) for n in plain}

    seen = set()

    def checked(name):
        def call(*a, **k):
            seen.add(name)
            out = saved[name](*a, **k)
            exp = plain[name](*a, **k)
            if name == "mx_flash_prefill":
                for x, y in zip(out[1:], exp[1:]):
                    if not torch.equal(x, y):
                        raise AssertionError("prefill chunk bytes differ "
                                             "from kv_encode")
                out0, exp0, tol = out[0], exp[0], 1e-4
            else:
                out0, exp0 = out, exp
                tol = (1e-4 * exp0.abs().max().item()
                       if name == "mx_gemm_packed" else 1e-4)
            err = (out0 - exp0).abs().max().item()
            worst[name] = max(worst[name], err)
            if not err <= tol:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on the served model "
                                     f"({err:.3e} > {tol:.3e})")
            return out
        return call

    for n in plain:
        setattr(ops, n, checked(n))
    try:
        run(qm)
    finally:
        for n, f in saved.items():
            setattr(ops, n, f)
    return {n: e for n, e in worst.items() if n in seen}


# ---------------------------------------------------------------------------
# phase 5: sampling and speculative decoding on the card
# ---------------------------------------------------------------------------

SPEC_KS = (3, 4)          # verify M = 4 lanes x (k + 1) = 16 and 20
VERIFY_BAR = 1e-2         # verify against sequential decode, of max |logit|


def threefry_on_card(torch, dev, sampling, n: int = 4096) -> None:
    """(a) keys, random bits and uniforms of n (seed, step, channel)
    triples, on the card and on the CPU: bitwise equal."""
    rng = np.random.default_rng(11)
    trip = [torch.as_tensor(a) for a in (
        rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.int64),
        rng.integers(0, 1 << 20, n), rng.integers(0, 2, n))]
    out = {}
    for where in ("cpu", dev):
        k = sampling._key(*(t.to(where) for t in trip))
        out[str(where)] = [k[0], k[1], sampling.random_bits(k, 64),
                           sampling.uniform(k).view(torch.int32)]
    same = all(torch.equal(a.cpu(), b) for a, b in
               zip(out[str(dev)], out["cpu"]))
    log(f"phase 5 (a): threefry keys, bits and uniforms of {n} triples on "
        f"the card bitwise equal to the CPU's: {same}")
    if not same:
        raise AssertionError("threefry on the card differs from the CPU")


def rep_prompts(rng, vocab: int, n: int = 4, length: int = 96):
    """Repetition-friendly prompts: random motifs of 3 to 6 tokens tiled."""
    out = []
    for i in range(n):
        motif = rng.integers(0, vocab, 3 + i)
        out.append(np.tile(motif, length // len(motif) + 1)[:length]
                   .astype(np.int32))
    return out


def _run(torch, eng, reqs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for r in reqs:
        if r.state.value != "finished" or len(r.out) != r.max_new:
            raise AssertionError(f"request ended {r.state.value} with "
                                 f"{len(r.out)} tokens: {r.error}")
    return [r.out for r in reqs], sum(len(r.out) for r in reqs) / dt


def _clone_cache(cache):
    return {k: type(v)(v.codes.clone(), v.scales.clone(), v.fmt, v.dtype)
            for k, v in cache.items()}


def verify_vs_sequential(torch, transformer, params, cfg, qm, kv_quant,
                         prompts, k, layout, page_size, dev):
    """Teacher-forced: four lanes' prompts prefilled, then the same k + 1
    tokens per lane through k + 1 sequential decode steps and through one
    verify step (M = 4 (k + 1)) from copies of that cache. Returns the
    worst |verify - decode| over max |logit|, and the packed GEMM's
    launches in the verify step."""
    from repro_torch.kernels import ops
    B, S, C = len(prompts), len(prompts[0]), cfg.attn_chunk
    chunk = np.zeros((B, C), np.int32)
    chunk[:, :S] = np.stack(prompts)
    toks = torch.as_tensor(chunk, device=dev)
    rng = np.random.default_rng(k)
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, k + 1))
                             .astype(np.int32), device=dev)
    pos = torch.full((B,), S, dtype=torch.int32)
    if layout == "paged":
        bt = torch.arange(1, B + 1, dtype=torch.int32, device=dev)[:, None]
        cache = transformer.init_cache_paged(cfg, B + 1, page_size,
                                             kv_quant=kv_quant, device=dev)
        _, cache = transformer.prefill_chunk_paged(
            params, cfg, cache, bt, toks, 0,
            torch.full((B,), S - 1, device=dev), qm)
    else:
        cache = transformer.init_cache(cfg, B, 2048, kv_quant=kv_quant,
                                       device=dev)
        _, cache = transformer.prefill_chunk(params, cfg, cache, toks, 0,
                                             S - 1, qm)
    seq_cache, ver_cache = _clone_cache(cache), cache
    seq = []
    for j in range(k + 1):
        p = (pos + j).to(dev)
        if layout == "paged":
            lg, seq_cache = transformer.decode_paged(
                params, cfg, seq_cache, forced[:, j], p, bt, qm)
        else:
            lg, seq_cache = transformer.decode(params, cfg, seq_cache,
                                               forced[:, j], p, qm)
        seq.append(lg)
    seq = torch.stack(seq, dim=1)
    nv = torch.full((B,), k + 1, dtype=torch.int32)
    torch.cuda.synchronize()
    ops.reset_launches()
    if layout == "paged":
        ver, _ = transformer.verify_paged(params, cfg, ver_cache, forced,
                                          pos, nv, bt, qm)
    else:
        ver, _ = transformer.verify(params, cfg, ver_cache, forced, pos, nv,
                                    qm)
    torch.cuda.synchronize()
    gemms = ops.launches["mx_gemm_packed"]
    err = ((ver - seq).abs().max() / seq.abs().max()).item()
    return err, gemms


def top2_margin(torch, transformer, params, cfg, qm, kv_quant, prompt,
                toks, t, layout, page_size, dev):
    """Top-2 margin and max |logit| of the logits that choose token t of a
    greedy run: ``prompt`` prefilled, then toks[:t] decoded one by one, on
    the layout the non-spec run decoded them on."""
    C = cfg.attn_chunk
    chunk = torch.zeros((1, C), dtype=torch.int32, device=dev)
    chunk[0, :len(prompt)] = torch.as_tensor(prompt, device=dev)
    if layout == "paged":
        bt = torch.tensor([[1]], dtype=torch.int32, device=dev)
        cache = transformer.init_cache_paged(cfg, 2, page_size,
                                             kv_quant=kv_quant, device=dev)
        lg, cache = transformer.prefill_chunk_paged(
            params, cfg, cache, bt, chunk, 0, len(prompt) - 1, qm)
    else:
        cache = transformer.init_cache(cfg, 1, 2048, kv_quant=kv_quant,
                                       device=dev)
        lg, cache = transformer.prefill_chunk(params, cfg, cache, chunk, 0,
                                              len(prompt) - 1, qm)
    for j in range(t):
        tok = torch.tensor([int(toks[j])], dtype=torch.int32, device=dev)
        pos = torch.tensor([len(prompt) + j], dtype=torch.int32, device=dev)
        if layout == "paged":
            lg, cache = transformer.decode_paged(params, cfg, cache, tok,
                                                 pos, bt, qm)
        else:
            lg, cache = transformer.decode(params, cfg, cache, tok, pos, qm)
    top = lg[0].float().topk(2).values
    return (top[0] - top[1]).item(), lg[0].abs().max().item()


def sampling_and_spec(torch, dev, seed, card, params, cfg, qm, prompts,
                      greedy):
    """Phase 5 on phase 3's Qwen2-0.5B (its artifact's weights, 4 lanes,
    max_len 2048, mxfp8 KV, fused backend): (a) threefry on the card, (b)
    temperature 0 against phase 3's greedy tokens on the three paths, (c)
    a seeded sampled run replayed on the paged path, (d) spec decoding at
    k = 3 and 4 on both continuous layouts against non-spec greedy, and
    verify against sequential decode, (e) the spec counters, tok/s and
    GEMM launches per verify step. (f), the packed GEMM at the verify
    shapes, runs beside phase 2 (:func:`verify_gemm_times`)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import sampling
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.policy import SpecConfig

    t_start = time.perf_counter()
    L = cfg.n_layers
    # the paged engine's page: attn_chunk rounded up to 64 rows
    page = cfg.attn_chunk * max(1, -(-64 // cfg.attn_chunk))
    log(f"phase 5 on {card}")
    threefry_on_card(torch, dev, sampling)
    fused = qm.with_backend("fused")
    common = dict(batch_size=4, max_len=2048, kv_cache="mxfp8", device=dev)
    paths = {"wave": dict(scheduler="wave", kv_layout="contiguous"),
             "continuous": dict(scheduler="continuous",
                                kv_layout="contiguous"),
             "paged": dict(scheduler="continuous", kv_layout="paged")}

    # (b) temperature 0 is the greedy path
    t0p = sampling.SamplingParams(temperature=0.0, top_k=5, top_p=0.5)
    for name, kw in paths.items():
        eng = Engine(params, cfg, fused, **kw, **common)
        outs, _ = _run(torch, eng, [
            Request(prompt=p, max_new=32,
                    sampling=dataclasses.replace(t0p, seed=i))
            for i, p in enumerate(prompts)])
        same = all(np.array_equal(a, b) for a, b in zip(outs, greedy[name]))
        log(f"phase 5 (b): temperature 0 on {name} equals phase 3's greedy "
            f"tokens: {same}")
        if not same:
            raise AssertionError(f"temperature 0 differs from greedy on "
                                 f"{name}")

    # (c) a seeded sampled run replays
    sp = sampling.SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
    runs, rates = [], []
    for _ in range(2):
        eng = Engine(params, cfg, fused, **paths["paged"], **common)
        outs, rate = _run(torch, eng, [
            Request(prompt=p, max_new=32,
                    sampling=dataclasses.replace(sp, seed=i))
            for i, p in enumerate(prompts)])
        runs.append(outs)
        rates.append(rate)
    same = all(np.array_equal(a, b) for a, b in zip(*runs))
    moved = sum(int((a != b).sum()) for a, b in zip(runs[0], greedy["paged"]))
    log(f"phase 5 (c): sampled paged run (T 0.8, top-k 50, top-p 0.95, "
        f"seeds 0-3) replays: {same}; {moved}/128 tokens differ from greedy; "
        f"{rates[0]:.1f} and {rates[1]:.1f} tok/s on {card}")
    if not same:
        raise AssertionError("a seeded sampled run did not replay")
    if moved == 0:
        raise AssertionError("sampling at temperature 0.8 gave the greedy "
                             "tokens")

    # (d, e) spec decoding against non-spec greedy
    rp = rep_prompts(np.random.default_rng(seed + 5), cfg.vocab_size)
    for name in ("continuous", "paged"):
        eng = Engine(params, cfg, fused, **paths[name], **common)
        base, base_rate = _run(torch, eng, [Request(prompt=p, max_new=32)
                                            for p in rp])
        for k in SPEC_KS:
            eng = Engine(params, cfg, fused, spec=SpecConfig(k=k),
                         **paths[name], **common)
            ops.reset_launches()
            outs, rate = _run(torch, eng, [Request(prompt=p, max_new=32)
                                           for p in rp])
            launches = dict(ops.launches)
            st = eng.stats()
            per_step = ((launches["mx_gemm_packed"]
                         - 7 * L * st["prefill_chunk_steps"])
                        / st["decode_steps"])
            log(f"phase 5 (e) spec k={k} {name}: proposed "
                f"{st['spec_proposed_tokens']}, accepted "
                f"{st['spec_accepted_tokens']}, acceptance "
                f"{st['spec_acceptance']:.3f}; {st['decode_steps']} verify "
                f"steps for 128 tokens; {rate:.1f} tok/s against non-spec "
                f"{base_rate:.1f} on {card}; mx_gemm_packed launches per "
                f"verify step {per_step:.1f} (M = {4 * (k + 1)}); launches "
                f"{launches}")
            if st["decode_steps"] and launches["mx_flash_decode_paged"] \
                    + launches["mx_flash_decode"]:
                raise AssertionError("a verify step launched a decode "
                                     "kernel")
            div = [(i, int(np.flatnonzero(a != b)[0]))
                   for i, (a, b) in enumerate(zip(outs, base))
                   if (a != b).any()]
            if div:
                i, t = div[0]
                margin, scale = top2_margin(
                    torch, transformer, params, cfg, fused, eng.kv_quant,
                    rp[i], base[i], t, name, page, dev)
                log(f"phase 5 (d) spec k={k} {name}: {len(div)} of 4 "
                    f"requests part from non-spec greedy; first: request "
                    f"{i} at token {t}, top-2 margin {margin:.4e} = "
                    f"{margin / scale:.3e} of max |logit| {scale:.4e}")
                if not margin <= VERIFY_BAR * scale:
                    raise AssertionError(
                        f"spec k={k} {name}: tokens part from greedy at a "
                        f"top-2 margin outside the {VERIFY_BAR} bar")
            else:
                log(f"phase 5 (d) spec k={k} {name}: tokens equal non-spec "
                    f"greedy on all 4 requests")
            err, gemms = verify_vs_sequential(
                torch, transformer, params, cfg, fused, eng.kv_quant, rp, k,
                name, page, dev)
            log(f"phase 5 (d) verify k={k} (M = {4 * (k + 1)}) {name}: "
                f"teacher-forced worst |verify - sequential decode| "
                f"{err:.3e} of max |logit| (bar {VERIFY_BAR}); "
                f"mx_gemm_packed launches in the verify step {gemms}")
            if not err <= VERIFY_BAR:
                raise AssertionError(f"verify k={k} {name} is {err:.3e} of "
                                     f"max |logit| from sequential decode")

    log(f"phase 5: {time.perf_counter() - t_start:.1f} s")


def verify_gemm_times(torch, dev, seed: int) -> None:
    """Phase 5 (f), run beside phase 2: the packed GEMM at the verify
    shapes (M = 4 (k + 1) rows for k = 3, 4; Qwen2-0.5B's (896, 4864) and,
    with T3, (4864, 896)), checked and timed as phase 2 times its shapes."""
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    for M in (4 * (k + 1) for k in SPEC_KS):
        for K, N, t3 in ((896, 4864, False), (4864, 896, True)):
            log(f"phase 5 (f): the verify GEMM at M = {M}")
            gemm_case(torch, dev, gen, M, K, N, t3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the kernels' inputs and the "
                         "requests")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_facts(torch, build)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    gemm_entries = check_gemm(torch, dev, gen)
    verify_gemm_times(torch, dev, args.seed)
    entries = [*gemm_entries,
               *check_prefill(torch, dev, gen, args.seed),
               check_decode(torch, dev, gen), check_flash_decode(torch, dev,
                                                                 gen),
               *check_quantizers(torch, dev, gen),
               check_unpacked_gemm(torch, dev, gen)]
    launches, served = end_to_end(torch, dev, args.seed)
    launches["standalone"] = standalone_path(torch, dev, served["params"])
    sampling_and_spec(torch, dev, args.seed, card, **served)
    # each kernel's launches on the path that carries it: the engine's
    # default (wave, contiguous) for the GEMM and the contiguous decode,
    # the paged run for the paged kernels, the standalone entry points
    path_of = {"mx_gemm_packed": "wave", "mx_flash_decode": "wave",
               "mx_flash_prefill": "paged", "mx_flash_decode_paged": "paged",
               "mx_quantize": "standalone", "t3_quantize": "standalone",
               "mx_gemm": "standalone"}
    for e in entries:
        path = e.get("path", path_of[e["name"]])
        e.update(route="cuda", source=SOURCE[e["name"]],
                 replaces=TPU_KERNEL[e["name"]], path=path,
                 launches=launches[path][e["name"]])
    log(f"card: {card}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
