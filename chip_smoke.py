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
   20 (run beside phase 2, while the profiler records every event);
6. the port's HTTP/SSE server (``repro_torch.serving.server``) in-process
   on 127.0.0.1 over phase 3's paged Qwen2-0.5B engine, driven over stdlib
   sockets and SSE: streamed tokens, priority preemption and resume,
   a disconnect-cancel, both deadlines, the ``nan_logits`` and
   ``failed_step`` faults, shedding with Retry-After, clean drain reports
   and a trace that validates (:func:`http_server_phase`); the paged
   kernels' launch counts in the ``kernels`` line are this phase's;
7. the LATMiX PTQ pipeline (:func:`ptq_phase`): ``apply_method
   ('latmix-lu', mxfp4, GPTQ)`` on Qwen2-0.5B at its published widths
   (random weights, the artifact CLI's calibration), timed by stage; the
   fold in FP under an orthogonal and under the learned set; GPTQ on the
   grid and below RTN's error on the captured Hessians; lu and qr for 2
   steps on the card against the CPU at 2 layers; the artifact exported,
   verified and served (paged, fused) with every kernel call of a prefill
   and a decode step held against its plain version. Each entry of the
   ``kernels`` line also carries ``launches_by_path``, phase 7's under
   ``ptq``;
8. the MoE family (:func:`moe_phase`): Qwen1.5-MoE-A2.7B at its published
   widths, its depth cut to 4 of 24 layers (random weights, RTN mxfp4
   with T3, exported and loaded), served on the three paths and under
   spec k = 4 on both continuous layouts, with launch counts per path
   (an expert-stacked einsum is one packed GEMM launch), every kernel
   call of a prefill and a decode step per layout held against its plain
   version, fused against reference logits and tokens, the memory rise of
   a fused expert call below the dense f32 bytes of its weight, and two
   prefills bitwise equal; then Moonlight-16B-A3B's widths at 2 of 48
   layers, one prefill and decode step per layout held call by call; and
   the expert-stacked GEMM timed at the decode and wave-prefill shapes
   (``launches_by_path`` under ``moe``, ``moe_wave``,
   ``moe_continuous``);
9. training, the train -> PTQ -> serve entry point and the rest of the
   zoo (:func:`zoo_phase`): Qwen2-0.5B at its full config trained 20
   steps under the port's ``Trainer`` (batch 8 x 512, bf16, remat), then
   a run interrupted after its step-10 checkpoint and resumed, its losses
   bitwise the uninterrupted run's; ``launch.serve --arch qwen2-0.5b
   --full --ckpt-dir ... --method rtn`` on that checkpoint, fused and
   reference, through kernels 1-3 (``launches_by_path`` ``train``);
   DeepSeek-67B's widths at 2 of 95 layers served on the paged path
   (``zoo_deepseek``); InternVL2-26B's at 2 of 48 through ``api.prefill``
   and ``api.decode`` of stub embeddings on the mxfp8 contiguous cache
   (``zoo_vlm``); HuBERT-XLarge's full forward (``zoo_encoder``); each
   with launch counts, fused against reference logits and kernel calls
   held against their plain versions. The kernel rows at those shapes are
   checked and timed beside phase 2 (:func:`zoo_kernel_entries`), and
   (f), a preempted spec request (k = 4) resumed bit for bit on both
   continuous layouts, runs after phase 6 on phase 3's engines
   (:func:`spec_resume_gate`);
10. the recurrent families (:func:`recurrent_phase`): RecurrentGemma-2B
   at its full config (26 layers, random weights, RTN mxfp4 with T3,
   packed in memory, mxfp8 ring cache) and Mamba2-130M at its full config
   (exported and loaded, ``kv_cache='none'``), each served by the wave
   scheduler on the contiguous cache (4 lanes, max_len 4096) in two waves
   of 4 x 32 greedy tokens: phase 3's prompts (bucketed to 2048) and four
   of 2100 tokens (bucketed to 3072, past Griffin's 2048-token window),
   with launch counts per wave (``launches_by_path`` ``rec_griffin``,
   ``rec_griffin_long``, ``rec_mamba2``, ``rec_mamba2_long``), every kernel
   call of a prefill and a decode step held against its plain version,
   fused against reference, a decode step's wall against device time,
   Griffin's first post-wrap decode step against the plain attention over
   the ring and against the full forward, and the cost of an unbucketed
   Mamba2 prefill; then (c) 10 Trainer steps of Mamba2-130M and 5 of
   RecurrentGemma-2B's widths at 5 layers, and (d) ``latmix-lu`` for 10
   steps at those widths, its first loss on the card against the CPU's.
   The packed GEMM at their shapes is checked and timed beside phase 2
   (:func:`rec_kernel_entries`);
11. the parallel layouts (:func:`parallel_phase`): a one-rank NCCL group
   started from a ``FileStore`` and a (1, 1) ("data", "model") mesh on
   the card. (a) Qwen2-0.5B's full config trained PAR_STEPS steps (phase
   9 (a)'s setup) under ``Trainer(mesh=)`` and meshless from the same
   seed, losses within PAR_LOSS_BAR relative (and whether bitwise), each
   run's peak memory; (b) each run's checkpoint restored into the other
   layout bit for bit; (c) the packed RTN Qwen2-0.5B through
   ``make_prefill_step`` and PAR_DECODE ``make_serve_step`` steps with
   and without the mesh: tokens equal, every packed-GEMM and flash-decode
   launch under the mesh through the replicated route (``ops.on_whole``),
   as many as without it
   (``launches_by_path`` ``parallel``); (d) the port's dry run of (a)'s
   cell on the fake backend, its predicted peak against (a)'s.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside this file, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import sys
import tempfile
import time
import types

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


def device_profile(torch):
    """A ``torch.profiler`` context that records the device's activity
    only. Recording the host's operators as well slowed the run it
    measured (phase 3's wave run on an H100: 10.0 s of wall against 4.8
    s, at the same device time) and took minutes to read back."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


class LostEvents(AssertionError):
    """Every record of :func:`device_split` with ``exact`` lost events."""


def device_ms(torch, fn, iters: int, warmup: int = 3,
              exact: bool = True) -> float:
    """Mean device milliseconds per call of ``fn``: the durations
    ``torch.profiler`` records for the CUDA kernels (and memory copies and
    sets) that ``iters`` calls launched, summed, over ``iters``. Unlike
    :func:`cuda_ms` this leaves out the host's time between launches. With
    ``exact``, every call launches the same kernels, so a record whose
    count of device events is not a multiple of ``iters`` lost some: it is
    taken again, and :class:`LostEvents` is raised after four such records
    (seen on an H100: 38, 39, 29 and 35 events for 20 calls of a GEMM with
    two events a call). A whole decode step is thousands of operations, of
    which the profiler may drop a few (seen on an H100: 27711 to 27714
    events for 10 steps); it passes ``exact=False`` and takes the sum as
    recorded."""
    return sum(device_split(torch, fn, iters, warmup, exact).values())


def device_split(torch, fn, iters: int, warmup: int = 3,
                 exact: bool = True) -> dict:
    """:func:`device_ms` by kernel: {short kernel name (no namespace,
    template arguments or parameters): mean device ms per call}."""
    for _ in range(warmup):
        fn()
    counts = []
    for _ in range(4):
        torch.cuda.synchronize()
        with device_profile(torch) as prof:
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
    raise LostEvents(f"the profiler's device events ({counts}) are not a "
                     f"multiple of the {iters} calls")


def measure(torch, fn, iters: int, exact: bool = True):
    """(device ms per call, ms per call with the wrapper included). The
    kernels of one stream cannot take longer than the wall time of their
    calls, so a device reading above the events' figure by more than 2% is
    a bad record: it is logged and both are taken again, and three bad
    pairs in a row fail the run. ``exact`` as in :func:`device_ms`; where
    the profiler lost events in every record (:class:`LostEvents`), the
    events' figure, an upper bound of the device time, stands for both,
    and the log says so."""
    for _ in range(3):
        wall = cuda_ms(torch, fn, iters)
        try:
            dev = device_ms(torch, fn, iters, exact=exact)
        except LostEvents as e:
            log(f"  {e}: the device time is taken as the {wall:.4f} ms per "
                f"call by events (an upper bound)")
            return wall, wall
        if dev <= 1.02 * wall:
            return dev, wall
        log(f"  discarded: device reading {dev:.4f} ms per call above the "
            f"{wall:.4f} ms per call by events")
    raise AssertionError("three device readings above their calls' wall "
                         "time: the profiler's record is not usable")


def timed(torch, label, kernel, plain, library, iters, plain_iters,
          plain_exact=True):
    """Time a kernel call, its plain version and (where there is one) the
    library call both ways; logs them, returns the JSON fields.
    ``plain_exact=False`` takes the plain version's device events as
    recorded (see :func:`device_ms`)."""
    ms, ms_w = measure(torch, kernel, iters)
    pl, pl_w = measure(torch, plain, plain_iters, exact=plain_exact)
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


def check_decode(torch, dev, gen, H=14, kvh=2, Dh=64,
                 fmts=("mxfp8", "mxint8", "mxfp4", "mxint4")):
    """The paged flash decode at Qwen2-0.5B's heads (or the heads given)
    over four lanes of 1024-row pages, each format with and without a
    window against its plain version; mxfp8 timed."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, packing, ref
    B, P, maxp = 4, 1024, 2
    D, G, n_pages = kvh * Dh, H // kvh, 1 + 4 * maxp
    kv_len = [1330, 1180, 250, 140]
    bt = _tables(torch, dev, gen, B, maxp, n_pages, kv_len, P)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qp = kl - 1
    q = torch.randn(B, H, Dh, generator=gen, device=dev)
    entry = None
    for fmt in fmts:
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
                 "path": "server" if Dh == 64 else "paged_qwen2_7b"}
    return entry


def check_flash_decode(torch, dev, gen, H=14, kvh=2, Dh=64,
                       fmts=("mxfp8", "mxint8", "mxfp4", "mxint4")):
    """The contiguous-cache flash decode at the paged check's shape: B = 4
    lanes of a 2048-row cache filled to [1330, 1180, 250, 140] (Qwen2-0.5B's
    heads, or the heads given)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, packing, ref
    B, S = 4, 2048
    D, G = kvh * Dh, H // kvh
    kv_len = [1330, 1180, 250, 140]
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qp = kl - 1
    q = torch.randn(B, H, Dh, generator=gen, device=dev)
    entry = None
    for fmt in fmts:
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
    reqs = [Request(prompt=p, max_new=32)
            for p in traffic(np.random.default_rng(seed + 1),
                             cfg.vocab_size)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with device_profile(torch) as prof:
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
                      seed: int, length: int = 1324, max_len: int = 2048,
                      label: str = "") -> None:
    """Host against device time of one decode step at the wave's shape:
    four lanes prefilled with ``length`` tokens into a ``max_len``-row
    cache, then fused decode steps (``transformer`` is any module with the
    prefill / decode interface: a family module or ``models.api``). The
    wall time per step (synchronized after each) against the device time
    the profiler records per step: their difference is what the host
    adds."""
    rng = np.random.default_rng(seed + 2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, length))
                           .astype(np.int32), device=dev)
    lg, cache = transformer.prefill(params, cfg, toks, qm, max_len=max_len,
                                    kv_quant=kv_quant)
    state = {"tok": lg.argmax(dim=-1).to(torch.int32), "pos": length,
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
    label = label or ("decode step, wave shape (4 lanes at fill 1337+, "
                      "contiguous mxfp8, fused")
    log(f"{label}, {cfg.n_layers} layers): wall {wall:.3f} ms, device "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}% busy), host adds "
        f"{wall - busy:.3f} ms")


def prefill_step_split(torch, transformer, params, cfg, qm, kv_quant, dev,
                       seed: int) -> None:
    """Host against device time of one full prefill at the wave's shape:
    four lanes of 1324 tokens into a 2048-row contiguous cache, fused, all
    layers. The wall time per prefill (synchronized after each) against the
    device time the profiler records for it, and that device time by
    kernel name."""
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
    with device_profile(torch) as prof:
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
    counts zeroed just before and read just after; ``art`` is an artifact
    directory (``Engine.from_artifact``) or the (params, cfg, qm) it
    loaded. Returns (engine, requests, launches, stats)."""
    from repro_torch.kernels import ops
    eng = (Engine(*art, backend="fused", **kw) if isinstance(art, tuple)
           else Engine.from_artifact(art, backend="fused", **kw))
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
    return runs[0]


def verify_gemm_times(torch, dev, seed: int) -> None:
    """Phase 5 (f), run beside phase 2: the packed GEMM at the verify
    shapes (M = 4 (k + 1) rows for k = 3, 4; Qwen2-0.5B's (896, 4864) and,
    with T3, (4864, 896)), checked and timed as phase 2 times its shapes."""
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    for M in (4 * (k + 1) for k in SPEC_KS):
        for K, N, t3 in ((896, 4864, False), (4864, 896, True)):
            log(f"phase 5 (f): the verify GEMM at M = {M}")
            gemm_case(torch, dev, gen, M, K, N, t3)


# ---------------------------------------------------------------------------
# phase 6: the HTTP/SSE server over the paged engine
# ---------------------------------------------------------------------------

IO_S = 120.0              # bound on one HTTP exchange or one sub-check
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)   # phase 5 (c)


async def _send(asyncio, port, method, path, body=None):
    """Open a connection and send one request; returns (reader, writer)."""
    r, w = await asyncio.wait_for(
        asyncio.open_connection("127.0.0.1", port), IO_S)
    data = b"" if body is None else json.dumps(body).encode()
    w.write((f"{method} {path} HTTP/1.1\r\nHost: smoke\r\n"
             f"Content-Length: {len(data)}\r\n\r\n").encode() + data)
    await w.drain()
    return r, w


async def _receive(asyncio, r, w, first=None):
    """Read a response to EOF (setting ``first`` at the first SSE token
    event); returns (code, headers, body, perf_counter at EOF)."""
    raw = b""
    try:
        while True:
            chunk = await asyncio.wait_for(r.read(65536), IO_S)
            if not chunk:
                break
            raw += chunk
            if first is not None and b"event: token" in raw:
                first.set()
    finally:
        w.close()
    t_eof = time.perf_counter()
    head, _, body = raw.partition(b"\r\n\r\n")
    headers = dict(line.decode().split(": ", 1)
                   for line in head.split(b"\r\n")[1:] if b": " in line)
    return (int(head.split()[1]), {k.lower(): v for k, v in headers.items()},
            body, t_eof)


async def _generate(asyncio, port, prompt, max_new, stream=False,
                    first=None, **fields):
    """POST /v1/generate. Streamed: (code, tokens from the token events,
    the done event's data or None, perf_counter at EOF); else (code,
    headers, the JSON result)."""
    r, w = await _send(asyncio, port, "POST", "/v1/generate",
                       {"prompt": [int(t) for t in prompt],
                        "max_new": max_new, "stream": stream, **fields})
    code, headers, body, t_eof = await _receive(asyncio, r, w, first)
    if not stream:
        return code, headers, json.loads(body) if body else {}
    toks, done, event = [], None, None
    for line in body.decode().split("\n"):
        if line.startswith("event:"):
            event = line[6:].strip()
        elif line.startswith("data:"):
            data = json.loads(line[5:])
            if event == "token":
                toks.extend(data["tokens"])
            elif event == "done":
                done = data
    return code, toks, done, t_eof


def _equal(label, got, want) -> None:
    """Tokens of each request against its uninterrupted run."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = [int(t) for t in a], [int(t) for t in b]
        if a != b:
            raise AssertionError(f"phase 6 {label}: request {i} gave {a} "
                                 f"against {b}")


def http_server_phase(torch, dev, seed, card, served, sampled_ref):
    """Phase 6: the port's ``Server`` on 127.0.0.1 (port 0, in-process,
    an ``EngineSupervisor`` on its worker thread) over phase 3's Qwen2-0.5B
    artifact (fused, mxfp8 KV, continuous scheduler, paged, 4 lanes),
    spoken to over stdlib sockets and SSE; one server per check, in turn,
    all with one tracer. Checks (each a hard failure): (a) the four phase-3
    requests streamed give phase 3's greedy tokens; (b) a priority-1
    arrival over four busy priority-0 lanes preempts exactly one, which
    resumes mid-flight with its uninterrupted tokens, greedy and sampled,
    its emitted tokens replayed through the decode kernels; (c) a client dropped by the ``disconnect`` fault point is
    cancelled within one engine step, its pages released, the other
    lanes' tokens unchanged; (d) an end-to-end deadline ends a decoding
    request TIMED_OUT, a TTFT deadline a queued one without a prefill;
    (e) ``nan_logits`` on one lane fails that request alone,
    ``failed_step`` fails the blamed lane and the requeued bystanders
    resume with their uninterrupted tokens; (f) past ``max_queue_depth`` requests get 429
    with a Retry-After that grows with consecutive sheds; (g) every drain
    report is clean (``sum(terminal) == submitted``, one terminal state a
    request, no page in use); (h) the trace validates. Returns the launch
    counts of the phase."""
    import asyncio

    from repro_torch.core.quantize import KVCacheQuant
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer, validate_trace
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.faults import FaultInjector
    from repro_torch.serving.policy import SchedulingPolicy
    from repro_torch.serving.server import Server, ServerConfig

    params, cfg = served["params"], served["cfg"]
    fused = served["qm"].with_backend("fused")
    prompts, greedy = served["prompts"], served["greedy"]["paged"]
    kv_quant = KVCacheQuant.parse("mxfp8")
    tracer = Tracer()
    reports = []
    handles = {}
    t_start = time.perf_counter()
    log(f"phase 6 on {card}")

    def resumed_equal(label, outs, want):
        """``outs``: (request id, tokens) of requests that may have been
        resumed; each must give its uninterrupted tokens ``want``, bit for
        bit. Returns, for each one that was preempted or requeued, the
        tokens it had emitted then (counted from its token times against
        the instant): what its re-admission replays."""
        emitted = []
        for (rid, got), w in zip(outs, want):
            _equal(f"{label}, {rid}", [got], [w])
            req, times = handles[rid]
            tid = tracer._tracks[req.trace_track]
            ev = [e for e in tracer.events() if e["tid"] == tid
                  and e["name"] in ("preempt", "requeue")]
            if ev:
                t_ev = ev[0]["ts"] / 1e6 + tracer._epoch
                emitted.append(sum(1 for x in times if x < t_ev))
        return emitted

    async def serving(check, policy=None, faults=None, server_kw=None):
        """One server over a fresh engine: run ``check(srv)``, shut down,
        hold the drain report to (g); returns (check's result, the
        engine's stats, the report). Each submitted request's handle and
        the perf_counter of each token it emits (on the worker thread)
        land in ``handles`` by request id."""
        eng = Engine(params, cfg, fused, batch_size=4, max_len=2048,
                     kv_cache="mxfp8", scheduler="continuous",
                     kv_layout="paged", tracer=tracer, faults=faults,
                     policy=policy, device=dev)
        srv = Server(eng, ServerConfig(port=0, **(server_kw or {})),
                     faults=faults)
        submit = srv.sup.submit

        def recording_submit(req, on_done=None):
            times, stream = [], req.on_token

            def on_token(tok):
                times.append(time.perf_counter())
                if stream is not None:
                    stream(tok)
            req.on_token = on_token
            submit(req, on_done)
            handles[req.request_id] = (req, times)
            return req
        srv.sup.submit = recording_submit
        await asyncio.wait_for(srv.start(), IO_S)
        try:
            out = await asyncio.wait_for(check(srv), IO_S)
            rep = await asyncio.wait_for(srv.shutdown(), IO_S)
        finally:
            srv.sup.stop(timeout_s=30.0)     # a no-op after shutdown()
        if srv.sup._thread.is_alive():
            raise AssertionError("phase 6: the supervisor did not stop")
        if not (rep["clean"] and rep["all_terminal"]
                and rep["allocator"]["in_use"] == 0):
            raise AssertionError(f"phase 6 (g): drain report not clean: "
                                 f"{rep}")
        reports.append(rep)
        return out, eng.stats(), rep

    def run(coro):
        return asyncio.run(asyncio.wait_for(coro, 4 * IO_S))

    ops.reset_launches()
    t0 = time.perf_counter()

    # (a) the four phase-3 requests, streamed
    async def stream4(srv):
        return await asyncio.gather(*[
            _generate(asyncio, srv.port, p, 32, stream=True)
            for p in prompts])
    outs, st, _ = run(serving(stream4))
    if any(o[0] != 200 or o[2]["state"] != "finished" for o in outs):
        raise AssertionError(f"phase 6 (a): {[o[2] for o in outs]}")
    _equal("(a)", [o[1] for o in outs], greedy)
    log(f"phase 6 (a): 4 streamed requests equal phase 3's greedy tokens "
        f"({time.perf_counter() - t0:.2f} s wall on {card}; "
        f"{st['prefix_hit_tokens']} prefix-hit tokens)")

    # (b) priority preemption with resume, greedy and sampled
    hi_prompt = np.random.default_rng(seed + 6).integers(
        0, cfg.vocab_size, 200).astype(np.int32)
    for kind, want in (("greedy", greedy), ("sampled", sampled_ref)):
        async def preempt(srv, kind=kind):
            firsts = [asyncio.Event() for _ in prompts]
            lo = [asyncio.ensure_future(_generate(
                asyncio, srv.port, p, 32, stream=True, first=firsts[i],
                deadline_ms=1e9,
                **(dict(SAMPLED, seed=i) if kind == "sampled" else {})))
                for i, p in enumerate(prompts)]
            await asyncio.wait_for(
                asyncio.gather(*[f.wait() for f in firsts]), IO_S)
            hi = await _generate(asyncio, srv.port, hi_prompt, 8,
                                 priority=1)
            return await asyncio.gather(*lo), hi
        t0 = time.perf_counter()
        (lo, hi), st, _ = run(serving(preempt))
        if hi[0] != 200 or hi[2]["state"] != "finished" or any(
                o[2]["state"] != "finished" for o in lo):
            raise AssertionError(f"phase 6 (b) {kind}: {hi}, "
                                 f"{[o[2] for o in lo]}")
        g = resumed_equal(f"(b) {kind}",
                          [(o[2]["request_id"], o[1]) for o in lo], want)
        if (st["preemptions"] != 1 or len(g) != 1 or g[0] < 1
                or st["resume_replay_steps"] != g[0]):
            raise AssertionError(f"phase 6 (b) {kind}: {st['preemptions']} "
                                 f"preemptions, {g} tokens emitted before "
                                 f"them, {st['resume_replay_steps']} replay "
                                 f"steps")
        log(f"phase 6 (b) {kind}: a priority-1 arrival over 4 busy lanes: "
            f"1 preemption after {g[0]} tokens, {g[0]} replay steps, "
            f"{st['admitted']} admissions for 5 requests; the 4 priority-0 "
            f"requests equal their uninterrupted tokens "
            f"({time.perf_counter() - t0:.2f} s wall on {card})")

    # (c) a client dropped mid-stream by the disconnect fault point; the
    # bystanders are not streamed, so only the victim's flushes count
    fi = FaultInjector(seed=seed).inject("disconnect", at=2)

    async def disconnect(srv):
        by = [asyncio.ensure_future(_generate(asyncio, srv.port, p, 32,
                                              deadline_ms=1e9))
              for p in prompts[:3]]
        victim = await _generate(asyncio, srv.port, prompts[3], 400,
                                 stream=True, deadline_ms=1e9)
        return await asyncio.gather(*by), victim
    t0 = time.perf_counter()
    (by, victim), st, rep = run(serving(disconnect, faults=fi))
    _, vtoks, vdone, t_drop = victim
    if fi.fired("disconnect") != 1 or vdone is not None:
        raise AssertionError("phase 6 (c): the stream was not dropped")
    if st["terminal"]["cancelled"] != 1:
        raise AssertionError(f"phase 6 (c): {st['terminal']}")
    _equal("(c) bystanders", [o[2]["tokens"] for o in by], greedy[:3])
    cancel = [e for e in tracer.events() if e["name"] == "cancel"]
    t_cancel = (cancel[-1]["ts"] / 1e6) + tracer._epoch
    steps = sum(1 for e in tracer.events() if e["name"] == "engine_step"
                and t_drop < e["ts"] / 1e6 + tracer._epoch < t_cancel)
    if len(cancel) != 1 or steps > 1:
        raise AssertionError(f"phase 6 (c): {len(cancel)} cancels, "
                             f"{steps} engine steps began between the "
                             f"drop and the cancel")
    log(f"phase 6 (c): the victim dropped after {len(vtoks)} tokens, "
        f"cancelled {1e3 * (t_cancel - t_drop):.1f} ms after the client "
        f"saw the drop, {steps} engine steps begun in between; pages in "
        f"use at quiescence {rep['allocator']['in_use']}; 3 bystanders "
        f"equal their uninterrupted tokens "
        f"({time.perf_counter() - t0:.2f} s wall on {card})")

    # (d) deadlines: end-to-end while decoding, TTFT while queued
    async def deadlines(srv):
        firsts = [asyncio.Event() for _ in range(4)]
        busy = [asyncio.ensure_future(_generate(
            asyncio, srv.port, p, n, stream=True, first=f, **kw))
            for p, n, f, kw in zip(
                prompts, (64, 64, 64, 1500), firsts,
                ({"deadline_ms": 1e9},) * 3 + ({"deadline_ms": 1500.0},))]
        await asyncio.wait_for(
            asyncio.gather(*[f.wait() for f in firsts]), IO_S)
        queued = await _generate(asyncio, srv.port, prompts[2], 8,
                                 ttft_deadline_ms=100.0)
        return await asyncio.gather(*busy), queued
    t0 = time.perf_counter()
    n_prefill = sum(1 for e in tracer.events() if e["name"] == "prefill")
    (busy, queued), st, _ = run(serving(deadlines))
    late = busy[3][2]
    if not (late["state"] == "timed_out" and "while decoding"
            in late["error"] and 0 < late["n_tokens"] < 1500):
        raise AssertionError(f"phase 6 (d) end to end: {late}")
    q = queued[2]
    prefills = sum(1 for e in tracer.events()
                   if e["name"] == "prefill") - n_prefill
    if not (queued[0] == 504 and q["state"] == "timed_out"
            and "TTFT deadline" in q["error"] and "while queued"
            in q["error"] and q["n_tokens"] == 0 and prefills == 4):
        raise AssertionError(f"phase 6 (d) TTFT: {queued}, {prefills} "
                             f"prefills for 5 requests")
    _equal("(d) neighbours", [o[1][:32] for o in busy[:3]], greedy[:3])
    log(f"phase 6 (d): end-to-end deadline 1500 ms: TIMED_OUT while "
        f"decoding after {late['n_tokens']} tokens; TTFT deadline 100 ms: "
        f"TIMED_OUT while queued, 0 tokens, no prefill "
        f"({time.perf_counter() - t0:.2f} s wall on {card})")

    # (e) faults in a step
    fi = FaultInjector(seed=seed).inject("nan_logits", at=10, lane=1)

    async def four(srv):
        return await asyncio.gather(*[
            _generate(asyncio, srv.port, p, 32, deadline_ms=1e9)
            for p in prompts])
    t0 = time.perf_counter()
    outs, st, _ = run(serving(four, faults=fi))
    failed = [i for i, o in enumerate(outs) if o[2]["state"] != "finished"]
    if (fi.fired("nan_logits") != 1 or len(failed) != 1
            or outs[failed[0]][2]["state"] != "failed"
            or "non-finite logits" not in outs[failed[0]][2]["error"]
            or st["nan_guard_trips"] != 1):
        raise AssertionError(f"phase 6 (e) nan_logits: "
                             f"{[o[2]['state'] for o in outs]}")
    i = failed[0]
    got = outs[i][2]["tokens"]
    _equal("(e) nan_logits, the failed lane's prefix", [got],
           [greedy[i][:len(got)]])
    _equal("(e) nan_logits, the others",
           [o[2]["tokens"] for j, o in enumerate(outs) if j != i],
           [g for j, g in enumerate(greedy) if j != i])
    log(f"phase 6 (e) nan_logits at the 11th decode step, lane 1: request "
        f"{i} FAILED after {len(got)} tokens (its uninterrupted prefix), "
        f"the other 3 equal their uninterrupted tokens "
        f"({time.perf_counter() - t0:.2f} s wall on {card})")
    fi = FaultInjector(seed=seed).inject("failed_step", at=3, lane=0,
                                         error="injected")
    t0 = time.perf_counter()
    outs, st, rep = run(serving(four, faults=fi))
    failed = [i for i, o in enumerate(outs) if o[2]["state"] != "finished"]
    if (fi.fired("failed_step") != 1 or rep["supervisor_restarts"] != 1
            or len(failed) != 1 or outs[failed[0]][0] != 500
            or "supervisor" not in outs[failed[0]][2]["error"]
            or st["terminal"]["preempted"] != 0):
        raise AssertionError(f"phase 6 (e) failed_step: {rep}, "
                             f"{[o[2]['state'] for o in outs]}")
    g = resumed_equal(
        "(e) failed_step, the requeued bystanders",
        [(o[2]["request_id"], o[2]["tokens"]) for j, o in enumerate(outs)
         if j != failed[0]],
        [g for j, g in enumerate(greedy) if j != failed[0]])
    if len(g) != 3 or st["resume_replay_steps"] != sum(g):
        raise AssertionError(f"phase 6 (e) failed_step: {g} tokens emitted "
                             f"by the requeued bystanders, "
                             f"{st['resume_replay_steps']} replay steps")
    log(f"phase 6 (e) failed_step before the 4th step, lane 0: request "
        f"{failed[0]} FAILED (500), 1 supervisor restart, "
        f"{st['admitted'] - 4} re-admissions replaying {g} tokens; the 3 "
        f"requeued bystanders equal their uninterrupted tokens bit for bit "
        f"({time.perf_counter() - t0:.2f} s wall on {card})")

    # (f) shedding past max_queue_depth
    policy = SchedulingPolicy(max_queue_depth=1)

    async def shed(srv):
        busy = []
        for p in prompts:                    # one at a time: a queue of one
            first = asyncio.Event()
            busy.append(asyncio.ensure_future(_generate(
                asyncio, srv.port, p, 64, stream=True, first=first,
                deadline_ms=1e9)))
            await asyncio.wait_for(first.wait(), IO_S)
        waiting = asyncio.ensure_future(
            _generate(asyncio, srv.port, prompts[2], 4))
        while True:                          # until it sits in the queue
            r, w = await _send(asyncio, srv.port, "GET", "/statz")
            st = json.loads((await _receive(asyncio, r, w))[2])
            if st["submitted"] == 5:
                break
            await asyncio.sleep(0.005)
        sheds = [await _generate(asyncio, srv.port, prompts[3], 4)
                 for _ in range(3)]
        return await asyncio.gather(*busy), await waiting, sheds
    t0 = time.perf_counter()
    (busy, waiting, sheds), st, _ = run(serving(shed, policy=policy))
    waits = [float(h["x-retry-after-s"]) for _, h, _ in sheds]
    if ([c for c, _, _ in sheds] != [429] * 3
            or waits != [policy.backoff_s(k) for k in (1, 2, 3)]
            or any(int(h["retry-after"]) < 1 for _, h, _ in sheds)
            or waiting[2]["state"] != "finished"
            or st["terminal"]["shed"] != 3):
        raise AssertionError(f"phase 6 (f): {sheds}, {waiting}")
    log(f"phase 6 (f): max_queue_depth 1 with 4 busy lanes and 1 queued: "
        f"3 requests shed with 429, X-Retry-After-S {waits} "
        f"(Retry-After {[h['retry-after'] for _, h, _ in sheds]} s); the "
        f"queued request finished ({time.perf_counter() - t0:.2f} s wall on {card})")
    launches = dict(ops.launches)

    # (g) one terminal state a request, across every server of the phase:
    # one "request" span on each request's track, one "shed" instant for
    # each shed request (shed at submit, it never gets a track)
    submitted = sum(r["submitted"] for r in reports)
    ends = collections.Counter(
        e["tid"] for e in tracer.events() if e["name"] == "request")
    n_shed = sum(1 for e in tracer.events() if e["name"] == "shed")
    if (sum(r["terminal_sum"] for r in reports) != submitted
            or len(ends) + n_shed != submitted
            or set(ends.values()) != {1}):
        raise AssertionError(f"phase 6 (g): {submitted} submitted, "
                             f"{sum(ends.values())} terminal transitions "
                             f"on {len(ends)} request tracks, {n_shed} "
                             f"shed")
    log(f"phase 6 (g): {len(reports)} drain reports clean: {submitted} "
        f"requests submitted, each with one terminal state, 0 pages in "
        f"use at quiescence")

    # (h) the trace
    with tempfile.TemporaryDirectory() as tmp:
        path = tracer.export(pathlib.Path(tmp) / "phase6_trace.json")
        evs = validate_trace(path)
    counts = collections.Counter(e["name"] for e in evs)
    log("phase 6 (h): trace validates: " + json.dumps(
        dict(sorted(counts.items()))))
    for k in PAGED_KERNELS:
        if not launches[k]:
            raise AssertionError(f"phase 6: {k} never launched")
    if launches["mx_flash_decode"]:
        raise AssertionError("phase 6: the paged server launched the "
                             "contiguous decode kernel")
    log(f"phase 6 launches: {launches}")
    log(f"phase 6: {time.perf_counter() - t_start:.1f} s wall on {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the LATMiX PTQ pipeline at full width, and its artifact served
# ---------------------------------------------------------------------------

PTQ_STEPS = 120          # (a)'s steps: apply_method's default
PTQ_CALIB = (3, 8, 64)   # the artifact CLI's calibration: batches, B, S
CARD_CPU_LAYERS = 2      # (d): Qwen2-0.5B's widths at this depth
FOLD_BAR = 1e-4          # (b): share of max |logit|, orthogonal set
TRAJ_BARS = (1e-2, 2e-2)  # (d): relative, first and second loss


class StageClock:
    """Wall seconds of the pipeline's stage functions, each wrapped (card
    synchronised before and after) for as long as the clock is open; the
    last call's arguments and result are kept."""

    def __init__(self, torch, targets):
        self.torch, self.targets = torch, targets
        self.seconds, self.calls, self.started = {}, {}, {}

    def __enter__(self):
        self.saved = {}
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved[(mod, name)] = fn
            setattr(mod, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def call(*a, **k):
            self.torch.cuda.synchronize()
            t0 = self.started[name] = time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            self.calls[name] = (a, k, out)
            return out
        return call

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


def _flat_omega(omega):
    out = {}
    for t, sub in omega.items():
        for k, v in sub["learn"].items():
            out[f"{t}/{k}"] = v.detach().float().cpu()
    return out


def fold_exactness(torch, api, tfm, folding, QuantMode, params, cfg,
                   tset, x, card):
    """(b): the fold in FP at full width. Each role's fold is exact for any
    invertible T1/T2 (Appendix C): on layer-stacked weights and a stream
    of rows y, the folded read of T1(y) equals the unfolded read of y
    (q, k, g, u, the head; v with T2 after it), the folded attention
    output of T2(o) equals the unfolded one followed by T1, and the folded
    down projection of T3(m) equals the unfolded one followed by T1: each
    within FOLD_BAR of its max |value|, under the learned set. The whole
    model is exact only where the RMSNorms commute with T1: under an
    orthogonal set without bias (block-Hadamard T1, Hadamard T2) its
    logits are held within FOLD_BAR of max |logit|; under the learned set
    a non-orthogonal T1 changes each token's RMS, so the logits move (in
    the JAX package as here; the student learns through that gap), and
    the move is reported beside cond(A1)."""
    with torch.no_grad():
        pn = api.fold_norms(params, cfg)
        fl = api.fold(pn, cfg, tset)
        b, fb = pn["blocks"], fl["blocks"]
        y = torch.randn(256, cfg.d_model, device=x.device)
        ty = y @ tset.a1 + tset.v1
        roles = {}

        def held(name, got, want):
            roles[name] = ((got - want).abs().max()
                           / want.abs().max()).item()

        for k in ("wq", "wk", "wg", "wu"):
            held(k, ty @ fb[k] + fb["b" + k[1]][:, None], y @ b[k])
        held("head", ty @ fl["head"] + fl["bhead"], y @ pn["head"])
        L, kvh, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        v = (y @ b["wv"]).reshape(L, -1, kvh, dh)
        tv = torch.einsum("ltkh,lhj->ltkj", v, tset.a2) + tset.v2[:, None,
                                                                None]
        held("wv", (ty @ fb["wv"] + fb["bv"][:, None]).reshape(tv.shape), tv)
        o = torch.randn(L, 256, cfg.n_heads, dh, device=x.device)
        to = torch.einsum("ltkh,lhj->ltkj", o, tset.a2) + tset.v2[:, None,
                                                                None]
        held("wo", to.reshape(L, 256, -1) @ fb["wo"] + fb["bo"][:, None],
             o.reshape(L, 256, -1) @ b["wo"] @ tset.a1)
        m = torch.randn(256, cfg.d_ff, device=x.device)
        tm = tfm.apply_blockwise(m, tfm.hadamard_matrix(32, m.dtype,
                                                        m.device))
        held("wd", tm @ fb["wd"], m @ b["wd"] @ tset.a1)
        del fl, fb

        ref = api.forward(params, cfg, x)
        scale = ref.abs().max().item()
        dev = x.device
        key = (torch.zeros((), dtype=torch.long, device=dev),
               torch.full((), 7, dtype=torch.long, device=dev))
        ortho = folding.TransformSet(
            a1=tfm.block_diag_init(key, cfg.d_model, 32, "hadamard", 0.0),
            v1=torch.zeros(cfg.d_model, device=dev),
            a2=tfm.random_hadamard(key, cfg.head_dim)[None].repeat(
                cfg.n_layers, 1, 1),
            v2=torch.zeros((cfg.n_layers, cfg.head_dim), device=dev),
            t3_block=32)
        model = {}
        for name, ts in (("orthogonal", ortho), ("learned", tset)):
            got = api.forward(api.fold(pn, cfg, ts), cfg, x,
                              QuantMode.off(32))
            model[name] = (got - ref).abs().max().item() / scale
            del got
        cond = torch.linalg.cond(tset.a1).item()
    log(f"phase 7 (b) fold in FP, learned set, each role against the "
        f"unfolded one (share of max |value|, bar {FOLD_BAR}): "
        + json.dumps(roles) + f"; cond(A1) {cond:.3f} ({card})")
    log(f"phase 7 (b) whole model, FP logits against the unfolded model's "
        f"(share of max |logit| {scale:.4e}): orthogonal set "
        f"{model['orthogonal']:.3e} (bar {FOLD_BAR}); learned set "
        f"{model['learned']:.3e} (RMSNorm against T1, no bar) ({card})")
    bad = {k: v for k, v in roles.items() if not v <= FOLD_BAR}
    if bad or not model["orthogonal"] <= FOLD_BAR:
        raise AssertionError(f"phase 7 (b): a fold is not exact: {bad}, "
                             f"orthogonal model {model['orthogonal']:.3e}")
    return roles, model, cond


def gptq_checks(torch, gptq, mxcfg, folded, stats, qparams, card):
    """(c): every layer's wq, wg and wd after GPTQ sits on the MX grid
    (RTN of it is itself) and its error tr((W−Q)ᵀ H (W−Q)) on the captured
    Hessian is at most RTN's."""
    worst = {}
    with torch.no_grad():
        for name, key in (("wq", "h_attn_in"), ("wg", "h_ffn_in"),
                          ("wd", "h_ffn_down")):
            w = folded["blocks"][name].double()
            q = qparams["blocks"][name]
            if not torch.equal(gptq.rtn_matrix(q, mxcfg), q.float()):
                raise AssertionError(f"phase 7 (c): GPTQ's {name} is off "
                                     f"the grid")
            h = getattr(stats, key)
            r = gptq.rtn_matrix(folded["blocks"][name], mxcfg).double()

            def err(e):
                return (e * (h @ e)).sum(dim=(-2, -1))

            eg, er = err(w - q.double()), err(w - r)
            if not bool((eg <= er).all()):
                worse = (eg > er).nonzero().flatten().tolist()
                raise AssertionError(f"phase 7 (c): GPTQ's {name} error "
                                     f"above RTN's at layers {worse}")
            worst[name] = (eg / er).max().item()
    log(f"phase 7 (c) GPTQ on the grid at every layer; worst error "
        f"GPTQ/RTN on the captured Hessian: " + json.dumps(worst)
        + f" ({card})")
    return worst


def card_against_cpu(torch, dev, seed, configs, transformer, api, latmix,
                     calib, card):
    """(d): Qwen2-0.5B's widths at CARD_CPU_LAYERS layers, the same random
    weights, one calibration batch: ``learn_transforms`` for 2 steps of
    lu and of qr on the card and on the CPU (``matrix_exp`` and ``inv``
    on the device; ``slogdet``, which only the kron kind's regularizer
    takes, is held on a perturbed d_model-wide kron Ω: 1e-4 relative). The
    first losses within TRAJ_BARS[0] relative: A differs between the
    devices in its last bits (qr's ``matrix_exp`` most), which moves a few
    MX codes of the student at these widths (2.3e-3 seen for qr); the
    second within TRAJ_BARS[1]; the final Ω within 2 × lr × steps (after
    the first update the two runs part as two runs on inputs an ulp apart
    do)."""
    import dataclasses

    from repro_torch import devices
    from repro_torch.core import transforms as tfm
    cfg = dataclasses.replace(configs.get("qwen2-0.5b"),
                              n_layers=CARD_CPU_LAYERS)
    gen = torch.Generator().manual_seed(seed + 23)
    host = transformer.init(gen, cfg, device="cpu")
    spec = tfm.TransformSpec(kind="kron", d=cfg.d_model)
    kron = {"learn": {k: torch.eye(n) + 0.05 * torch.randn(n, n,
                                                           generator=gen)
                      for k, n in (("K1", 28), ("K2", 32))}, "fixed": {}}
    vols = [tfm.loss_vol(devices.tree_to(kron, w), spec).item()
            for w in (dev, torch.device("cpu"))]
    if not abs(vols[0] - vols[1]) <= 1e-4 * abs(vols[1]):
        raise AssertionError(f"phase 7 (d): kron volume term card {vols[0]} "
                             f"against CPU {vols[1]}")
    cpu = torch.device("cpu")
    out = {}
    for kind in ("lu", "qr"):
        lx = latmix.LatmixConfig(kind=kind, steps=2)
        runs = []
        for where in (dev, cpu):
            t0 = time.perf_counter()
            om, _, hist = latmix.learn_transforms(
                api.fold_norms(devices.tree_to(host, where), cfg), cfg, lx,
                calib[:1])
            runs.append((_flat_omega(om), hist, time.perf_counter() - t0))
        (oc, hc, tc), (oh, hh, th) = runs
        rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
               for a, b in zip(hc, hh)]
        dom = max((oc[k] - oh[k]).abs().max().item() for k in oh)
        out[kind] = dict(loss_rel=rel, omega_max_abs=dom, card_s=tc,
                         cpu_s=th)
        log(f"phase 7 (d) {kind}: losses card {[h['loss'] for h in hc]} "
            f"cpu {[h['loss'] for h in hh]} (relative {rel}); final Ω max "
            f"|Δ| {dom:.3e} (bar {2 * lx.lr * lx.steps}); {tc:.1f} s on the "
            f"card ({card}), {th:.1f} s on the CPU; kron volume term card "
            f"{vols[0]:.6e} CPU {vols[1]:.6e}")
        if not (rel[0] <= TRAJ_BARS[0] and rel[1] <= TRAJ_BARS[1]
                and dom <= 2 * lx.lr * lx.steps):
            raise AssertionError(f"phase 7 (d): {kind} on the card parts "
                                 f"from the CPU past the bars")
    return out


def ptq_phase(torch, dev, seed: int, card: str):
    """Phase 7: the LATMiX PTQ pipeline on Qwen2-0.5B at its published
    widths (random weights from the seed), calibrated on the port's
    ``SyntheticLM`` at the artifact CLI's defaults, then its artifact
    served through the kernels. (a) ``apply_method('latmix-lu', mxfp4,
    steps=PTQ_STEPS, weight_quant='gptq')`` with the wall time of each
    stage; the task loss falls and the Fig. 3 metrics are finite; (b) the
    fold in FP (:func:`fold_exactness`); (c) GPTQ against RTN
    (:func:`gptq_checks`); (d) the card against the CPU at 2 layers
    (:func:`card_against_cpu`); (e) export, ``verify_artifact``, and
    ``Engine.from_artifact`` (fused, continuous, paged, mxfp8 KV, 4 lanes)
    on phase 3's four prompts with the launch counts zeroed just before
    and read just after, the first prefill and one decode step held call
    by call against the plain versions, and the greedy tokens against the
    reference backend's. Returns the launch counts of (e)."""
    from repro_torch import configs
    from repro_torch.artifacts import export_artifact, verify_artifact
    from repro_torch.core import folding, gptq, latmix, ptq
    from repro_torch.core import transforms as tfm
    from repro_torch.core.quantize import QuantMode
    from repro_torch.data import synthetic
    from repro_torch.models import api, transformer
    from repro_torch.serving.engine import Engine, Request

    t_phase = time.perf_counter()
    log(f"phase 7 on {card}")
    cfg = configs.get("qwen2-0.5b")
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    params = transformer.init(gen, cfg, device=dev)
    n, B, S = PTQ_CALIB
    src = synthetic.make_source(cfg, B, S, 0)
    calib = [src.batch(i) for i in range(n)]

    # (a) the pipeline, stage by stage
    stamps = []
    clock = StageClock(torch, ((latmix, "learn_transforms"),
                               (gptq, "capture_hessians"),
                               (gptq, "quantize_weights_gptq")))
    torch.cuda.reset_peak_memory_stats()
    with clock:
        res = ptq.apply_method(
            "latmix-lu", params, cfg, calib, fmt="mxfp4", steps=PTQ_STEPS,
            weight_quant="gptq",
            log=lambda s: (stamps.append(time.perf_counter()), log(s)))
    hist = res.history
    learn_s = clock.seconds["learn_transforms"]
    step_s = (stamps[-1] - stamps[0]) / (hist[-1]["step"] - hist[0]["step"])
    omega = clock.calls["learn_transforms"][2][0]
    lx = ptq._lat_cfg("latmix-lu", "mxfp4", PTQ_STEPS, False)
    metrics = latmix.transform_metrics(omega, cfg, lx)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        art = pathlib.Path(tmp) / "qwen2-0.5b-latmix-lu-mxfp4"
        export_artifact(res, cfg, art)
        export_s = time.perf_counter() - t0
        log("phase 7 (a) latmix-lu mxfp4 gptq, " + json.dumps({
            "steps": PTQ_STEPS, "calibration": list(PTQ_CALIB),
            "learn_s": learn_s, "mean_step_s": step_s,
            "teacher_and_init_s": (stamps[0] - step_s
                                   - clock.started["learn_transforms"]),
            "hessian_capture_s": clock.seconds["capture_hessians"],
            "gptq_s": clock.seconds["quantize_weights_gptq"],
            "export_s": export_s,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
            + f" ({card})")
        log("phase 7 (a) history: " + json.dumps(hist))
        log("phase 7 (a) transform metrics: " + json.dumps(metrics))
        tasks = [h["task"] for h in hist]
        if not min(tasks[-3:]) < tasks[0]:
            raise AssertionError("phase 7 (a): the task loss did not fall")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError("phase 7 (a): a transform metric is not "
                                 "finite")

        # (b)
        x = torch.as_tensor(calib[0]["inputs"], device=dev).long()
        fold_exactness(torch, api, tfm, folding, QuantMode, params, cfg,
                       res.tset, x, card)
        del params

        # (c)
        gargs = clock.calls["quantize_weights_gptq"][0]
        gptq_checks(torch, gptq, ptq._mx_cfg("mxfp4"), gargs[0], gargs[2],
                    res.params, card)
        del gargs, clock, res

        # (e) the artifact served
        rep = verify_artifact(art)
        log(f"phase 7 (e) verify_artifact: {json.dumps(rep)}")
        prompts = traffic(np.random.default_rng(seed), cfg.vocab_size)
        kw = dict(scheduler="continuous", kv_layout="paged", batch_size=4,
                  max_len=2048, kv_cache="mxfp8", device=dev)
        eng, reqs, lp, st = serve(torch, Engine, Request, art, prompts, cfg,
                                  tag=" ptq", **kw)
        check_paged_run(eng, lp, st, cfg.n_layers, " ptq")
        sparams, _, qm = eng.params, eng.cfg, eng.qm
        paged_teacher_forced(torch, transformer, sparams, cfg, qm, eng,
                             prompts[0], dev, " ptq")
        ref_eng = Engine(sparams, cfg, qm.with_backend("ref"), **kw)
        ref_reqs = [Request(prompt=p, max_new=32) for p in prompts]
        ref_eng.generate(ref_reqs)
        agree = sum(int(a == b) for r, s in zip(reqs, ref_reqs)
                    for a, b in zip(r.out.tolist(), s.out.tolist()))
        log(f"phase 7 (e) paged greedy tokens fused == ref: {agree}/"
            f"{sum(len(r.out) for r in reqs)}")
        del eng, ref_eng

    # (d)
    card_against_cpu(torch, dev, seed, configs, transformer, api, latmix,
                     calib, card)
    log(f"phase 7: {time.perf_counter() - t_phase:.1f} s wall on {card}")
    return lp


# ---------------------------------------------------------------------------
# phase 8: the MoE family at Qwen1.5-MoE-A2.7B's and Moonlight's widths
# ---------------------------------------------------------------------------

MOE_LAYERS = 4           # of Qwen1.5-MoE-A2.7B's 24: the smoke's time
MOONLIGHT_LAYERS = 2     # of Moonlight-16B-A3B's 48
MOE_SPEC_K = 4


def moe_gemms_per_forward(cfg) -> int:
    """Packed GEMM launches of one MoE forward: q, k, v, o, the router and
    the three expert-stacked einsums per layer (one launch each), and the
    shared experts' three linears where the config has them."""
    return cfg.n_layers * (8 + (3 if cfg.n_shared_experts else 0))


def expert_gemm_case(torch, dev, gen, E, M, K, N, t3):
    """The expert-stacked mx_gemm_packed at one shape: one launch, checked
    against its plain version (and a second call, bitwise), timed beside
    the plain version and f32 ``torch.bmm`` over the dequantised weights;
    returns its ``kernels`` entry (path ``moe``)."""
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels import ops, packing, ref
    x = torch.randn(E, M, K, generator=gen, device=dev)
    w = torch.randn(E, K, N, generator=gen, device=dev) / K ** 0.5
    pw = packing.PackedWeight.from_dense(w)
    del w
    n0 = ops.launches["mx_gemm_packed"]
    y = ops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
    one = ops.launches["mx_gemm_packed"] - n0
    y2 = ops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
    yp = ref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
    torch.cuda.synchronize()
    err = (y - yp).abs().amax(dim=(1, 2))
    tol = 1e-4 * yp.abs().amax(dim=(1, 2))
    label = f"expert gemm E={E} M={M} K={K} N={N} t3={t3}"
    log(f"{label}: launches per call {one}; max_abs_err "
        f"{err.max().item():.3e} (worst expert's share of its max |y| "
        f"{(err / tol * 1e-4).max().item():.3e}, bar 1e-4); two calls "
        f"bitwise equal: {torch.equal(y, y2)}")
    if one != 1:
        raise AssertionError(f"{label}: {one} launches for one call")
    if not (err <= tol).all():
        raise AssertionError(f"{label}: disagrees with its plain version")
    if not torch.equal(y, y2):
        raise AssertionError(f"{label}: not repeatable")
    del y, y2, yp
    xq = mxlib.quantize(x)
    wd = pw.to_dense()
    t = timed(torch, label,
              lambda: ops.mx_gemm_packed(x, pw.codes_packed,
                                         pw.scales_e8m0, t3=t3),
              lambda: ref.mx_matmul_packed_ref(
                  x, pw.codes_packed, pw.scales_e8m0, t3=t3),
              lambda: torch.bmm(xq, wd), 20, 5,
              # the plain version's device events at E = 60 came one over
              # a multiple of the calls in one run on an H100 (116 for 5
              # calls, four records in a row); its sum is taken as recorded
              plain_exact=False)
    nbytes = E * (M * K * 4 + K * N // 2 + K * N // 32 + M * N * 4)
    b, by = bound_ms(nbytes, 2.0 * E * M * N * K, PEAK_FP8)
    log(f"{label}: bound_ms {b:.4f} ({by}), share of the bound "
        f"{b / t['ms']:.3f}")
    return {"name": "mx_gemm_packed", "shape": f"E={E} M={M} K={K} N={N} "
            f"t3={t3} (expert-stacked)", "path": "moe",
            "max_abs_err": err.max().item(), **t, "bound_ms": b,
            "bound_by": by}


def moe_no_dense_weight(torch, qeinsum, params, cfg, qm, dev):
    """The port's counterpart of the JAX package's
    test_fused_lowering_has_no_dense_weight: around one fused
    expert-stacked einsum at the decode shape (4 groups x capacity 8 rows
    per expert), the rise of the allocator's peak stays below the dense
    f32 bytes of the stacked weight."""
    from repro_torch.models import moe
    w = params["blocks"]["eg"][0]
    E, K, N = w.shape
    C = moe.capacity(cfg, 1)
    x = torch.randn(4, E, C, K, device=dev)
    fused = qm.with_backend("fused")
    qeinsum("gecd,edf->gecf", x, w, fused, "ffn_in")      # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = qeinsum("gecd,edf->gecf", x, w, fused, "ffn_in")
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    dense = E * K * N * 4
    log(f"phase 8 (d) no dense weight: a fused expert-stacked einsum at "
        f"x {tuple(x.shape)} raised the peak by {rise} bytes; the dense f32 "
        f"weight is {dense} bytes; output {tuple(y.shape)}")
    if not rise < dense:
        raise AssertionError("phase 8: the fused expert einsum "
                             "materialized a dense weight")


def moe_spec(torch, Engine, Request, SpecConfig, moe, params, cfg, qm,
             seed, dev, common, paths, card):
    """Spec k = MOE_SPEC_K on both continuous layouts against non-spec
    greedy on phase 5's repetitive prompts (a first divergence must sit
    within VERIFY_BAR of max |logit| of a top-2 tie)."""
    from repro_torch.kernels import ops
    fused = qm.with_backend("fused")
    rp = rep_prompts(np.random.default_rng(seed + 5), cfg.vocab_size)
    page = cfg.attn_chunk * max(1, -(-64 // cfg.attn_chunk))
    for name in ("continuous", "paged"):
        eng = Engine(params, cfg, fused, **paths[name], **common)
        base, base_rate = _run(torch, eng, [Request(prompt=p, max_new=32)
                                            for p in rp])
        eng = Engine(params, cfg, fused, spec=SpecConfig(k=MOE_SPEC_K),
                     **paths[name], **common)
        ops.reset_launches()
        outs, rate = _run(torch, eng, [Request(prompt=p, max_new=32)
                                       for p in rp])
        st = eng.stats()
        log(f"phase 8 (b) spec k={MOE_SPEC_K} {name}: proposed "
            f"{st['spec_proposed_tokens']}, accepted "
            f"{st['spec_accepted_tokens']}, {st['decode_steps']} verify "
            f"steps for 128 tokens; {rate:.1f} tok/s against non-spec "
            f"{base_rate:.1f} on {card}; launches {dict(ops.launches)}")
        div = [(i, int(np.flatnonzero(a != b)[0]))
               for i, (a, b) in enumerate(zip(outs, base)) if (a != b).any()]
        if div:
            i, t = div[0]
            margin, scale = top2_margin(torch, moe, params, cfg, fused,
                                        eng.kv_quant, rp[i], base[i], t,
                                        name, page, dev)
            log(f"phase 8 (b) spec {name}: {len(div)} of 4 requests part "
                f"from non-spec greedy; first: request {i} at token {t}, "
                f"top-2 margin {margin / scale:.3e} of max |logit|")
            if not margin <= VERIFY_BAR * scale:
                raise AssertionError(f"phase 8 spec {name}: tokens part "
                                     f"from greedy outside a top-2 tie")
        else:
            log(f"phase 8 (b) spec {name}: tokens equal non-spec greedy on "
                f"all 4 requests")


def moonlight_path(torch, dev, seed, card):
    """Moonlight-16B-A3B's widths (64 experts, top-6, no shared experts, no
    QKV bias, router N = 64) cut to MOONLIGHT_LAYERS: random weights, RTN
    mxfp4 with T3, packed in memory; one prefill and one decode step per
    layout with every kernel call held against its plain version."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.artifacts.store import pack_params
    from repro_torch.core import ptq
    from repro_torch.core.quantize import KVCacheQuant
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    full = configs.get("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(full, n_layers=MOONLIGHT_LAYERS)
    log(f"phase 8 (f) moonlight: reduced: depth {cfg.n_layers} of "
        f"{full.n_layers} layers (published widths otherwise)")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    res = ptq.apply_method("rtn", moe.init(gen, cfg, device=dev), cfg,
                           fmt="mxfp4")
    params = pack_params(res)
    qm = dataclasses.replace(res.qm, t3_block=32)
    del res
    torch.cuda.synchronize()
    log(f"phase 8 (f) moonlight: init + RTN + pack "
        f"{time.perf_counter() - t0:.1f} s")
    kv = KVCacheQuant("mxfp8")
    prompt = traffic(np.random.default_rng(seed), cfg.vocab_size)[0]
    fused = qm.with_backend("fused")
    page = cfg.attn_chunk * max(1, -(-64 // cfg.attn_chunk))
    for name, run in (
            ("paged", lambda q: prefill_and_step(
                torch, moe, params, cfg, q, kv, page, cfg.attn_chunk,
                prompt, dev)),
            ("contiguous", lambda q: contiguous_prefill_and_step(
                torch, moe, params, cfg, q, kv, prompt, dev))):
        worst = teacher_forced(torch, ops, run, fused)
        log(f"phase 8 (f) moonlight {name} teacher-forced, worst error per "
            f"kernel call: " + json.dumps(worst))
    del params


def moe_phase(torch, dev, seed: int, card: str):
    """Phase 8: Qwen1.5-MoE-A2.7B at its published widths (d_model 2048, 16
    heads over 16 KV heads of 128, QKV bias, 60 routed experts of 1408,
    top-4, 4 shared experts fused to 5632, vocab 151936, capacity factor
    1.25, 32 routing groups), depth cut to MOE_LAYERS: random weights, RTN
    mxfp4 with T3, exported and loaded, served by the engine (4 lanes,
    max_len 2048, mxfp8 KV, fused) on phase 3's traffic three ways
    (``Engine.from_artifact`` for the first), (a) with the launch counts of
    each path; (b) spec; (c) a prefill and a decode step per layout held
    call by call, fused against reference logits and paged tokens; (d) no
    dense weight; (e) two prefills bitwise equal; (f) Moonlight; (g) the
    expert-stacked GEMM timed. Returns ({path: launches}, kernels
    entries)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.artifacts import export_artifact, load_artifact
    from repro_torch.core import ptq
    from repro_torch.core.quantize import qeinsum
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.policy import SpecConfig

    t_phase = time.perf_counter()
    log(f"phase 8 on {card}")
    full = configs.get("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    L = cfg.n_layers
    gemms = moe_gemms_per_forward(cfg)
    log(f"e2e qwen2-moe: reduced: depth {L} of {full.n_layers} layers "
        f"(published widths otherwise)")
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    t0 = time.perf_counter()
    res = ptq.apply_method("rtn", moe.init(gen, cfg, device=dev), cfg,
                           fmt="mxfp4")
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    prompts = traffic(np.random.default_rng(seed), cfg.vocab_size)
    common = dict(batch_size=4, max_len=2048, kv_cache="mxfp8", device=dev)
    paths = {"wave": dict(scheduler="wave", kv_layout="contiguous"),
             "continuous": dict(scheduler="continuous",
                                kv_layout="contiguous"),
             "paged": dict(scheduler="continuous", kv_layout="paged")}
    launches = {}
    tag = " qwen2-moe"
    with tempfile.TemporaryDirectory() as tmp:
        art = pathlib.Path(tmp) / "qwen2-moe-a2.7b-mxfp4"
        export_artifact(res, cfg, art)
        del res
        torch.cuda.synchronize()
        log(f"e2e qwen2-moe: init + RTN + export "
            f"{time.perf_counter() - t0:.1f} s ({L} layers)")
        # (a) the three paths: the first through the artifact
        eng, rw, lw, st = serve(torch, Engine, Request, art, prompts, cfg,
                                tag=tag, **paths["wave"], **common)
        params, qm = eng.params, eng.qm
    check_contiguous_launches(lw, st, L, gemms, 1 + st["decode_steps"],
                              "moe wave")
    launches["moe_wave"] = lw
    del eng
    served = (params, cfg, qm)
    eng, rc, lc, st = serve(torch, Engine, Request, served, prompts, cfg,
                            tag=tag, **paths["continuous"], **common)
    check_contiguous_launches(
        lc, st, L, gemms, st["prefill_chunk_steps"] + st["decode_steps"],
        "moe continuous")
    launches["moe_continuous"] = lc
    del eng
    eng, rp_, lp, st = serve(torch, Engine, Request, served, prompts, cfg,
                             tag=tag, **paths["paged"], **common)
    check_paged_run(eng, lp, st, L, tag)
    launches["moe"] = lp
    kv_quant, page = eng.kv_quant, eng.page_size
    del eng
    # (b)
    moe_spec(torch, Engine, Request, SpecConfig, moe, params, cfg, qm, seed,
             dev, common, paths, card)
    # (c) call by call, and fused against reference
    p0 = prompts[0]
    fused = qm.with_backend("fused")
    paged_teacher_forced(torch, moe, params, cfg, qm,
                         types.SimpleNamespace(page_size=page,
                                               kv_quant=kv_quant), p0, dev,
                         tag)
    worst = teacher_forced(torch, ops, lambda q: contiguous_prefill_and_step(
        torch, moe, params, cfg, q, kv_quant, p0, dev), fused)
    log("e2e qwen2-moe contiguous teacher-forced, worst error per kernel "
        "call: " + json.dumps(worst))
    ref_eng = Engine(params, cfg, qm.with_backend("ref"), **paths["paged"],
                     **common)
    ref_reqs = [Request(prompt=p, max_new=32) for p in prompts]
    ref_eng.generate(ref_reqs)
    agree = sum(int(a == b) for r, s in zip(rp_, ref_reqs)
                for a, b in zip(r.out.tolist(), s.out.tolist()))
    log(f"e2e qwen2-moe: paged greedy tokens fused == ref: {agree}/"
        f"{sum(len(r.out) for r in rp_)}")
    del ref_eng
    # (d)
    moe_no_dense_weight(torch, qeinsum, params, cfg, qm, dev)
    # (e) the combine and every kernel repeat bit for bit
    toks = torch.as_tensor(p0[None], device=dev)
    a, _ = moe.prefill(params, cfg, toks, fused, max_len=2048,
                       kv_quant=kv_quant)
    b, _ = moe.prefill(params, cfg, toks, fused, max_len=2048,
                       kv_quant=kv_quant)
    torch.cuda.synchronize()
    log(f"phase 8 (e): two prefills of a {len(p0)}-token prompt bitwise "
        f"equal: {torch.equal(a, b)}")
    if not torch.equal(a, b):
        raise AssertionError("phase 8: two prefills differ")
    del params, served, a, b
    torch.cuda.empty_cache()
    # (f)
    moonlight_path(torch, dev, seed, card)
    torch.cuda.empty_cache()
    # (g) the expert-stacked GEMM at the decode (M = 4 groups x capacity 8)
    # and wave-prefill (16 groups x capacity 32) shapes
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    E, d, f = full.n_experts, full.d_model, full.d_ff
    entries = [expert_gemm_case(torch, dev, gen, E, M, K, N, t3)
               for M, K, N, t3 in ((32, d, f, False), (32, f, d, True),
                                   (512, d, f, False))]
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s wall on {card}")
    return launches, entries


# ---------------------------------------------------------------------------
# phase 9: training, the train -> PTQ -> serve entry point, the zoo, and the
# spec resume
# ---------------------------------------------------------------------------

TRAIN_STEPS = 20          # (a): Qwen2-0.5B's full config under the Trainer
TRAIN_CKPT = 10           # the checkpoint the interrupted run resumes from
TRAIN_FAIL = 15           # where it is interrupted
TRAIN_SHAPE = (8, 512)    # batch x sequence
ZOO_LAYERS = 2            # of DeepSeek-67B's 95 and InternVL2-26B's 48
VLM_SHAPE = (4, 1024, 32)  # (d): lanes, stub-embedding prompt, decode steps
ENC_SHAPE = (4, 1500)     # (e): lanes x frames
ZOO_COS = 0.5             # fused against reference logits (phase 3's bar)


def train_phase(torch, dev, seed, card, root):
    """(a) Qwen2-0.5B at its full config (24 layers, d_model 896, bf16
    parameters, remat) under ``launch.train``'s Trainer: TRAIN_SHAPE
    batches, TRAIN_STEPS steps uninterrupted; then a run with a checkpoint
    at TRAIN_CKPT, interrupted at TRAIN_FAIL (``fail_at``) and resumed to
    the end, whose losses after the resume must equal the uninterrupted
    run's bit for bit. Returns the resumed run's checkpoint directory."""
    import shutil

    from repro_torch import configs
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import TrainConfig, Trainer

    cfg = configs.get("qwen2-0.5b")
    B, S = TRAIN_SHAPE

    def trainer(d, every, log_=lambda *_: None):
        return Trainer(cfg, TrainConfig(
            steps=TRAIN_STEPS, batch_size=B, seq_len=S, ckpt_every=every,
            ckpt_dir=str(d), keep=1, log_every=1, seed=seed,
            opt=opt.AdamWConfig(lr=3e-4, warmup_steps=5,
                                total_steps=TRAIN_STEPS)),
            device=dev, log=log_)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a = trainer(root / "a", 10 ** 9)
    t0 = time.perf_counter()
    a.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    la = {m["step"]: m["loss"] for m in a.metrics}
    st = a.step_times
    log(f"phase 9 (a) train qwen2-0.5b full ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, bf16 parameters, remat) batch {B} x seq "
        f"{S}: {TRAIN_STEPS} steps in {wall:.1f} s (checkpoint included); "
        f"step time first {st[0]:.3f} s, median {sorted(st)[len(st)//2]:.3f}"
        f" s; peak memory {peak:.2f} GiB; loss step 1 {la[1]:.6f}, step "
        f"{TRAIN_STEPS} {la[TRAIN_STEPS]:.6f} on {card}")
    if not la[TRAIN_STEPS] < la[1]:
        raise AssertionError("phase 9 (a): the loss did not fall")
    del a
    shutil.rmtree(root / "a", ignore_errors=True)
    torch.cuda.empty_cache()
    b = trainer(root / "b", TRAIN_CKPT)
    try:
        b.train(fail_at=TRAIN_FAIL)
        raise AssertionError("phase 9 (a): the injected failure did not fire")
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    del b
    torch.cuda.empty_cache()
    logs = []
    b2 = trainer(root / "b", TRAIN_CKPT, logs.append)
    t0 = time.perf_counter()
    b2.train()
    torch.cuda.synchronize()
    lb = {m["step"]: m["loss"] for m in b2.metrics}
    parted = [s for s in lb if lb[s] != la[s]]
    log(f"phase 9 (a) resumed ({logs[0] if logs else 'no resume'}) from the "
        f"step-{TRAIN_CKPT} checkpoint after a failure at step {TRAIN_FAIL}:"
        f" {len(lb)} steps in {time.perf_counter() - t0:.1f} s; losses of "
        f"steps {min(lb)}-{max(lb)} equal the uninterrupted run's bit for "
        f"bit: {not parted}")
    if f"[trainer] resumed from step {TRAIN_CKPT}" not in logs or \
            sorted(lb) != list(range(TRAIN_CKPT + 1, TRAIN_STEPS + 1)):
        raise AssertionError(f"phase 9 (a): resume went wrong: {logs}")
    if parted:
        raise AssertionError(
            f"phase 9 (a): resumed losses part from the uninterrupted run at "
            f"steps {parted}: " + json.dumps({s: [la[s], lb[s]]
                                              for s in parted}))
    del b2
    torch.cuda.empty_cache()
    return root / "b"


def train_serve_path(torch, dev, seed, card, ckpt_dir):
    """(b) ``launch.serve --arch qwen2-0.5b --full --ckpt-dir <a> --method
    rtn --kv-layout paged --scheduler continuous`` in-process, fused, with
    the launch counts zeroed just before and read just after; its served
    weights held call by call against the plain versions on a prefill and
    a decode step; then the same command with the reference backend, its
    tokens against the fused run's. Returns the launches."""
    import contextlib
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine

    argv = ["--arch", "qwen2-0.5b", "--full", "--ckpt-dir", str(ckpt_dir),
            "--method", "rtn", "--kv-layout", "paged", "--scheduler",
            "continuous", "--requests", "4", "--prompt-len", "256",
            "--max-new", "32", "--batch", "4", "--max-len", "2048",
            "--seed", str(seed), "--device", dev.type]
    runs = {}
    gen_, thr = Engine.generate, Engine.throughput

    def spy_gen(self, reqs):
        out = gen_(self, reqs)
        runs.setdefault(self.qm.backend, {})["reqs"] = out
        return out

    def spy_thr(self, *a, **k):
        res = thr(self, *a, **k)
        runs.setdefault(self.qm.backend, {}).update(eng=self, stats=res)
        return res

    Engine.generate, Engine.throughput = spy_gen, spy_thr
    try:
        for backend in ("fused", "ref"):
            out = io.StringIO()
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = launch_serve.main(argv + ["--backend", backend])
            torch.cuda.synchronize()
            runs[backend]["launches"] = dict(ops.launches)
            text = out.getvalue()
            log(f"phase 9 (b) launch.serve {' '.join(argv)} --backend "
                f"{backend}: exit {rc} in {time.perf_counter() - t0:.1f} s; "
                + " | ".join(text.strip().splitlines()[:3]))
            if rc != 0 or f"loaded checkpoint step {TRAIN_STEPS}" not in text:
                raise AssertionError(f"phase 9 (b): {text}")
    finally:
        Engine.generate, Engine.throughput = gen_, thr
    f = runs["fused"]
    eng, st, lp = f["eng"], f["stats"], f["launches"]
    L = eng.cfg.n_layers
    log(f"phase 9 (b) fused: {st['tokens']} tokens, {st['tok_per_s']:.1f} "
        f"tok/s, launches {lp}")
    for name in PAGED_KERNELS:
        if lp[name] <= 0:
            raise AssertionError(f"phase 9 (b): {name} never launched")
    if lp["mx_flash_decode_paged"] != st["decode_steps"] * L:
        raise AssertionError(f"phase 9 (b): paged decode launched "
                             f"{lp['mx_flash_decode_paged']}x for "
                             f"{st['decode_steps']} steps")
    eng._alloc.check()
    prompt = np.asarray(f["reqs"][0].prompt)
    paged_teacher_forced(torch, transformer, eng.params, eng.cfg, eng.qm,
                         eng, prompt, dev, " train->serve")
    agree = sum(int(a == b) for r, s in zip(f["reqs"], runs["ref"]["reqs"])
                for a, b in zip(r.out.tolist(), s.out.tolist()))
    log(f"phase 9 (b): paged greedy tokens fused == ref: {agree}/"
        f"{sum(len(r.out) for r in f['reqs'])}")
    del runs, f, eng
    torch.cuda.empty_cache()
    return lp


def _zoo_model(torch, dev, seed, name, layers=None):
    """A zoo config at its published widths (depth cut to ``layers``):
    random weights built on the card, RTN mxfp4, packed in memory, T3 on.
    Returns (params, cfg, qm)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.artifacts.store import pack_params
    from repro_torch.core import ptq
    from repro_torch.models import api

    full = configs.get(name)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 90)
    res = ptq.apply_method("rtn", api.init(gen, cfg, device=dev), cfg,
                           fmt="mxfp4")
    params = pack_params(res)
    qm = dataclasses.replace(res.qm, t3_block=32)
    del res
    torch.cuda.synchronize()
    log(f"phase 9 {name}: depth {cfg.n_layers} of {full.n_layers} layers, "
        f"published widths (d_model {cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} KV heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}); init + RTN + pack on the card "
        f"{time.perf_counter() - t0:.1f} s, no artifact written")
    return params, cfg, qm


def _logits_agree(torch, label, fused, ref):
    """Fused against reference logits, row by row: logs max |diff|, the
    worst cosine and argmax agreement; fails below ZOO_COS."""
    f, r = fused.float().flatten(0, -2), ref.float().flatten(0, -2)
    cos = torch.nn.functional.cosine_similarity(f, r, dim=-1)
    same = (f.argmax(-1) == r.argmax(-1)).float().mean().item()
    log(f"{label}: fused vs ref logits max|diff| "
        f"{(f - r).abs().max().item():.4e}, max|logit| "
        f"{r.abs().max().item():.4e}, cosine min {cos.min().item():.4f} "
        f"mean {cos.mean().item():.4f}, argmax agreement {same:.3f}")
    if not cos.min().item() >= ZOO_COS:
        raise AssertionError(f"{label}: fused logits are unrelated to ref")


def deepseek_path(torch, dev, seed, card):
    """(c) DeepSeek-67B's widths cut to ZOO_LAYERS, served by phase 3's
    engine (4 lanes, max_len 2048, mxfp8 KV, fused, continuous/paged) on
    ``traffic``, 32 greedy tokens each, launch counts per run; a prefill
    and a decode step held call by call; fused against reference tokens;
    its kernels' shapes are timed beside phase 2
    (:func:`zoo_kernel_entries`)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine, Request

    params, cfg, qm = _zoo_model(torch, dev, seed, "deepseek-67b",
                                 ZOO_LAYERS)
    L = cfg.n_layers
    prompts = traffic(np.random.default_rng(seed), cfg.vocab_size)
    kw = dict(scheduler="continuous", kv_layout="paged", batch_size=4,
              max_len=2048, kv_cache="mxfp8", device=dev)
    eng, reqs, lp, st = serve(torch, Engine, Request, (params, cfg, qm),
                              prompts, cfg, tag=" deepseek-67b", **kw)
    check_paged_run(eng, lp, st, L, " deepseek-67b")
    if lp["mx_gemm_packed"] % (7 * L):
        raise AssertionError(f"deepseek: {lp['mx_gemm_packed']} GEMM "
                             f"launches, not a multiple of 7 x {L}")
    paged_teacher_forced(torch, transformer, params, cfg, qm, eng,
                         prompts[0], dev, " deepseek-67b")
    ref_eng = Engine(params, cfg, qm.with_backend("ref"), **kw)
    ref_reqs = [Request(prompt=p, max_new=32) for p in prompts]
    ref_eng.generate(ref_reqs)
    agree = sum(int(a == b) for r, s in zip(reqs, ref_reqs)
                for a, b in zip(r.out.tolist(), s.out.tolist()))
    log(f"phase 9 (c) deepseek-67b: paged greedy tokens fused == ref: "
        f"{agree}/{sum(len(r.out) for r in reqs)}")
    del eng, ref_eng, params
    torch.cuda.empty_cache()
    return lp


def vlm_path(torch, dev, seed, card):
    """(d) InternVL2-26B's widths cut to ZOO_LAYERS: ``api.prefill`` of
    stub embeddings (VLM_SHAPE lanes x rows) into the mxfp8 contiguous
    cache, then decode steps of stub embeddings through the contiguous
    flash decode at G = 6, fused (launch counts) against the reference
    backend; a prefill and a decode step held call by call."""
    from repro_torch.core.quantize import KVCacheQuant
    from repro_torch.kernels import ops
    from repro_torch.models import api

    params, cfg, qm = _zoo_model(torch, dev, seed, "internvl2-26b",
                                 ZOO_LAYERS)
    L = cfg.n_layers
    B, S, T = VLM_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed + 92)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev) * 0.5
    nxt = torch.randn(T, B, cfg.d_model, generator=gen, device=dev) * 0.5
    kv = KVCacheQuant("mxfp8")

    def run(q, steps=T):
        with torch.no_grad():
            lg, cache = api.prefill(params, cfg, x, q, max_len=2048,
                                    kv_quant=kv)
            out = [lg]
            for t in range(steps):
                lg, cache = api.decode(params, cfg, cache, nxt[t], S + t, q)
                out.append(lg)
        return torch.stack(out)

    fused = qm.with_backend("fused")
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    lf = run(fused)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.launches)
    log(f"phase 9 (d) internvl2-26b: prefill of {B} x {S} stub embeddings "
        f"+ {T} decode steps (mxfp8 contiguous cache) in {dt:.2f} s on "
        f"{card}; launches {launches}")
    want = {"mx_gemm_packed": 7 * L * (1 + T), "mx_flash_decode": T * L}
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"phase 9 (d): {name} launched {n}x, "
                                 f"expected {want.get(name, 0)}")
    lr = run(qm.with_backend("ref"))
    _logits_agree(torch, "phase 9 (d) internvl2-26b", lf, lr)
    worst = teacher_forced(torch, ops, lambda q: run(q, 1), fused)
    log("phase 9 (d) internvl2-26b teacher-forced, worst error per kernel "
        "call: " + json.dumps(worst))
    del params, lf, lr
    torch.cuda.empty_cache()
    return launches


def encoder_path(torch, dev, seed, card):
    """(e) HuBERT-XLarge at its full published config (48 layers, d_model
    1280, head_dim 80, non-causal): ``api.forward`` of ENC_SHAPE stub
    frames under the fused backend (launch counts) against the reference
    backend, every GEMM call held against its plain version."""
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.training.optimizer import tree_leaves

    params, cfg, qm = _zoo_model(torch, dev, seed, "hubert-xlarge")
    nparam = sum(int(np.prod(v.shape)) for v in tree_leaves(params))
    B, S = ENC_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed + 93)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev) * 0.5

    def run(q):
        with torch.no_grad():
            return api.forward(params, cfg, x, q)

    fused = qm.with_backend("fused")
    run(fused)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    lf = run(fused)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.launches)
    log(f"phase 9 (e) hubert-xlarge ({nparam / 1e9:.3f} B parameters): "
        f"forward of {B} x {S} frames in {dt * 1e3:.1f} ms on {card}; "
        f"launches {launches}")
    want = {"mx_gemm_packed": 7 * cfg.n_layers}
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"phase 9 (e): {name} launched {n}x, "
                                 f"expected {want.get(name, 0)}")
    lr = run(qm.with_backend("ref"))
    _logits_agree(torch, "phase 9 (e) hubert-xlarge", lf, lr)
    worst = teacher_forced(torch, ops, run, fused)
    log("phase 9 (e) hubert-xlarge teacher-forced, worst error per kernel "
        "call: " + json.dumps(worst))
    del params, lf, lr
    torch.cuda.empty_cache()
    return launches


def spec_resume_gate(torch, dev, seed, card, served):
    """(f) Priority preemption under spec decoding (k = 4) on both
    continuous layouts of phase 3's Qwen2-0.5B: four priority-0 requests on
    repetition-friendly prompts, a priority-1 arrival once all four are
    decoding, one preempted and resumed. Every priority-0 request must give
    the tokens of the uninterrupted run (the four alone), and the logits
    row the resume's replay ends on must be bitwise the row the
    uninterrupted run computed at that position (slot 0 of its next verify
    step)."""
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.policy import SchedulingPolicy, SpecConfig

    params, cfg, qm = served["params"], served["cfg"], served["qm"]
    fused = qm.with_backend("fused")
    prompts = rep_prompts(np.random.default_rng(seed + 9), cfg.vocab_size)
    hi_prompt = np.random.default_rng(seed + 10).integers(
        0, cfg.vocab_size, 200).astype(np.int32)
    spec = SpecConfig(k=4)
    rec = []
    owner = []
    real = {n: getattr(api, n) for n in ("verify", "verify_paged")}

    def spy(n):
        def run(*a, **k):
            logits, cache = real[n](*a, **k)
            if owner:
                rec.append(([None if sl is None else sl.req.request_id
                             for sl in owner[0]._slots],
                            a[4].clone(), logits[:, 0].clone()))
            return logits, cache
        return run

    replay = Engine._replay
    seen = []

    def spy_replay(self, slot, req, pos0):
        n0 = len(req._steps)
        row = replay(self, slot, req, pos0)
        seen.append((req.request_id, pos0 + len(req._gen) - 1, row.clone(),
                     n0, list(req._steps)))
        return row

    for n in real:
        setattr(api, n, spy(n))
    Engine._replay = spy_replay
    try:
        for name, kw in (("continuous", dict(kv_layout="contiguous")),
                         ("paged", dict(kv_layout="paged"))):
            common = dict(scheduler="continuous", batch_size=4,
                          max_len=2048, kv_cache="mxfp8", spec=spec,
                          device=dev, **kw)

            def lo():
                return [Request(prompt=p, max_new=32, request_id=f"r{i}",
                                deadline_ms=1e9)
                        for i, p in enumerate(prompts)]
            rec.clear()
            ref_eng = Engine(params, cfg, fused, **common)
            owner[:] = [ref_eng]
            ref = lo()
            ref_eng.generate(ref)
            owner.clear()
            table = {}
            for ids, pos, rows in rec:
                for lane, rid in enumerate(ids):
                    if rid is not None:
                        table[(rid, int(pos[lane]))] = rows[lane]
            eng = Engine(params, cfg, fused, policy=SchedulingPolicy(
                backoff_base_s=0.0), **common)
            reqs = lo()
            for r in reqs:
                eng.submit(r)
            steps = 0
            while not all(r.state.value == "running" and len(r._gen) > 4
                          for r in reqs):
                eng.step()
                steps += 1
                if steps > 64:
                    raise AssertionError("phase 9 (f): the lanes never all "
                                         "ran")
            seen.clear()
            hi = Request(prompt=hi_prompt, max_new=8, priority=1,
                         request_id="hi")
            eng.submit(hi)
            eng.drain()
            torch.cuda.synchronize()
            st = eng.stats()
            bad = [r.request_id for r, s in zip(reqs, ref)
                   if not np.array_equal(r.out, s.out)]
            if (st["preemptions"] != 1 or len(seen) != 1
                    or hi.state.value != "finished"):
                raise AssertionError(f"phase 9 (f) {name}: "
                                     f"{st['preemptions']} preemptions, "
                                     f"{len(seen)} resumes, hi "
                                     f"{hi.state.value}")
            rid, p, row, n0, steps_rec = seen[0]
            want = table.get((rid, p))
            same = want is not None and torch.equal(row, want)
            log(f"phase 9 (f) spec k=4 {name}: request {rid} preempted and "
                f"resumed through {n0 + 1} verify replay steps (recorded "
                f"steps {steps_rec[:n0]}); the 4 priority-0 requests equal "
                f"their uninterrupted tokens: {not bad}; the replay's last "
                f"logits row (position {p}) bitwise the uninterrupted "
                f"run's: {same}; resume_replay_steps "
                f"{st['resume_replay_steps']} on {card}")
            if bad or not same or st["resume_replay_steps"] != n0 + 1:
                raise AssertionError(f"phase 9 (f) {name}: tokens part for "
                                     f"{bad}, row equal {same}")
            del eng, ref_eng
    finally:
        for n, fn in real.items():
            setattr(api, n, fn)
        Engine._replay = replay


def zoo_kernel_entries(torch, dev, seed):
    """Phase 9's kernel rows, run beside phase 2 (a record of 200 GEMV
    calls at K = 8192 taken after phases 1-8 came back with 339 of its 400
    device events four times running): the packed GEMM at DeepSeek-67B's
    decode (M = 4) and chunk (M = 1024) shapes and at HuBERT-XLarge's
    forward (M = 6000), the paged prefill and decode at DeepSeek-67B's
    heads (G = 8, Dh 128), the contiguous decode at InternVL2-26B's (G =
    6), each checked against its plain version and timed."""
    from repro_torch import configs

    gen = torch.Generator(device=dev).manual_seed(seed + 91)
    ds, vl, hb = (configs.get(n) for n in ("deepseek-67b", "internvl2-26b",
                                           "hubert-xlarge"))
    d, f = ds.d_model, ds.d_ff
    entries = [dict(gemm_case(torch, dev, gen, M, K, N, t3),
                    path="zoo_deepseek")
               for M, K, N, t3 in ((4, d, f, False), (4, f, d, True),
                                   (1024, d, f, False))]
    heads = dict(H=ds.n_heads, kvh=ds.n_kv_heads, Dh=ds.head_dim)
    entries.append(dict(_prefill_pages(torch, dev, gen, 1024, 2, **heads),
                        path="zoo_deepseek"))
    entries.append(dict(check_decode(torch, dev, gen, fmts=("mxfp8",),
                                     **heads), path="zoo_deepseek"))
    entries.append(dict(check_flash_decode(
        torch, dev, gen, H=vl.n_heads, kvh=vl.n_kv_heads, Dh=vl.head_dim,
        fmts=("mxfp8",)), path="zoo_vlm"))
    d, f = hb.d_model, hb.d_ff
    M = ENC_SHAPE[0] * ENC_SHAPE[1]
    entries += [dict(gemm_case(torch, dev, gen, M, K, N, t3),
                     path="zoo_encoder")
                for K, N, t3 in ((d, f, False), (f, d, True))]
    return entries


def zoo_phase(torch, dev, seed, card):
    """Phase 9 (a)-(e): training at Qwen2-0.5B's full config, the train ->
    PTQ -> serve entry point on its checkpoint, DeepSeek-67B's and
    InternVL2-26B's widths at reduced depth and HuBERT-XLarge at its full
    config. Returns {path: launches}."""
    t_phase = time.perf_counter()
    log(f"phase 9 on {card}")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = train_phase(torch, dev, seed, card, pathlib.Path(tmp))
        t_a = time.perf_counter() - t_phase
        launches["train"] = train_serve_path(torch, dev, seed, card, ckpt)
    t_b = time.perf_counter() - t_phase
    launches["zoo_deepseek"] = deepseek_path(torch, dev, seed, card)
    t_c = time.perf_counter() - t_phase
    launches["zoo_vlm"] = vlm_path(torch, dev, seed, card)
    t_d = time.perf_counter() - t_phase
    launches["zoo_encoder"] = encoder_path(torch, dev, seed, card)
    t_e = time.perf_counter() - t_phase
    log(f"phase 9: {t_e:.1f} s wall on {card} (cumulative: (a) {t_a:.1f}, "
        f"(b) {t_b:.1f}, (c) {t_c:.1f}, (d) {t_d:.1f}, (e) {t_e:.1f})")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the recurrent families
# ---------------------------------------------------------------------------

REC_KW = dict(scheduler="wave", kv_layout="contiguous", batch_size=4,
              max_len=4096)
REC_WRAP = 2100           # wave (ii)'s prompts: bucket to 3072, past 2048
REC_TRAIN = {"mamba2-130m": (None, 10), "recurrentgemma-2b": (5, 5)}
REC_PTQ_LAYERS = 5        # (d): RecurrentGemma-2B's widths at this depth
REC_CPU_LAYERS = 3        # (d): one super-block, the least depth with
#                           every sublayer kind (2 layers would be two tails)
RING_BAR = 1e-2           # post-wrap decode against the dense ring, of max


def rec_gemms_per_forward(cfg) -> int:
    """Packed-GEMM launches of one forward: Griffin's recurrent layers run
    wx, wy, wor and the GeGLU's three (6), its attention layers q, k, v, o
    and the GeGLU's (7); a Mamba2 block in_proj and out_proj (2). The LM
    head stays in f32 (``quantize_head`` off)."""
    if cfg.family == "ssm":
        return 2 * cfg.n_layers
    return 19 * cfg.n_super_blocks + 6 * cfg.n_tail_rec


def _wave_tokens(torch, dev, prompts, S):
    """The wave scheduler's left-padded (B, S) prompt tokens."""
    toks = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    return torch.as_tensor(toks, device=dev)


def rec_kernel_entries(torch, dev, seed):
    """Phase 10's kernel rows, run beside phase 2: the packed GEMM at
    Mamba2-130M's in_proj (768, 3352; N % 16 != 0, the byte-staged weight
    route of both kernels) for a decode step (M = 4) and a 4 x 2048 wave
    prefill (M = 8192), and at RecurrentGemma-2B's GeGLU widths: (2560,
    7680) at M = 4 and 8192, (7680, 2560) with T3 at M = 4."""
    gen = torch.Generator(device=dev).manual_seed(seed + 101)
    cases = (("rec_mamba2", 4, 768, 3352, False),
             ("rec_mamba2", 8192, 768, 3352, False),
             ("rec_griffin", 4, 2560, 7680, False),
             ("rec_griffin", 4, 7680, 2560, True),
             ("rec_griffin", 8192, 2560, 7680, False))
    return [dict(gemm_case(torch, dev, gen, M, K, N, t3), path=path)
            for path, M, K, N, t3 in cases]


def _rec_engine_checks(eng, lw, st, cfg, label):
    """Launch counts of a wave run: the packed GEMM rec_gemms_per_forward
    times per forward (the prefill and each decode step), no other kernel
    (the ring attention decodes in place: its key positions keep it off the
    flash-decode contract)."""
    want = rec_gemms_per_forward(cfg) * (1 + st["decode_steps"])
    log(f"phase 10 {label}: {st['decode_steps']} decode steps, "
        f"{rec_gemms_per_forward(cfg)} packed GEMMs a forward; launches {lw}"
        f"; kv_bytes_resident {eng.kv_bytes_resident()}")
    for name, n in lw.items():
        if n != (want if name == "mx_gemm_packed" else 0):
            raise AssertionError(f"phase 10 {label}: {name} launched {n}x, "
                                 f"expected "
                                 f"{want if name == 'mx_gemm_packed' else 0}")


def rec_serve_cell(torch, dev, seed, card, params, cfg, qm, kv_cache, tag,
                   art=None):
    """(a) / (b): waves (i) and (ii) on the wave scheduler, fused, launch
    counts per wave; the wave-(i) prefill and a decode step with every
    kernel call held against its plain version; fused against reference
    for wave (i) (prefill logits, tokens); a decode step's wall against
    device time. Returns ({path: launches}, the wave-(ii) prompts)."""
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine, Request

    rng = np.random.default_rng(seed)
    waves = {"": traffic(rng, cfg.vocab_size),
             "_long": [rng.integers(0, cfg.vocab_size, REC_WRAP)
                       .astype(np.int32) for _ in range(4)]}
    kw = dict(REC_KW, kv_cache=kv_cache, device=dev)
    launches = {}
    fused = qm.with_backend("fused")
    for suffix, prompts in waves.items():
        t0 = time.perf_counter()
        eng, reqs, lw, st = serve(torch, Engine, Request,
                                  art if art is not None
                                  else (params, cfg, qm),
                                  prompts, cfg, tag=f" {tag}{suffix}", **kw)
        S = eng._bucket_len(max(len(p) for p in prompts), 32)
        _rec_engine_checks(eng, lw, st, cfg,
                           f"{tag}{suffix} (prompts bucket to {S})")
        launches[f"rec_{tag}{suffix}"] = lw
        log(f"phase 10 {tag}{suffix}: wave served in "
            f"{time.perf_counter() - t0:.1f} s on {card}")
        if suffix:
            continue
        toks = _wave_tokens(torch, dev, prompts, S)
        kvq = eng.kv_quant

        def run(q):
            with torch.no_grad():
                lg, cache = api.prefill(params, cfg, toks, q,
                                        max_len=eng.max_len, kv_quant=kvq)
                lg2, _ = api.decode(params, cfg, cache,
                                    lg.argmax(-1).to(torch.int32), S, q)
            return lg, lg2

        worst = teacher_forced(torch, ops, run, fused)
        log(f"phase 10 {tag} teacher-forced, worst error per kernel call: "
            + json.dumps(worst))
        lf, lr = run(fused)[0], run(qm.with_backend("ref"))[0]
        _logits_agree(torch, f"phase 10 {tag} prefill", lf, lr)
        ref_eng = Engine(params, cfg, qm.with_backend("ref"), **kw)
        ref_reqs = [Request(prompt=p, max_new=32) for p in prompts]
        ref_eng.generate(ref_reqs)
        agree = sum(int(a == b) for r, s in zip(reqs, ref_reqs)
                    for a, b in zip(r.out.tolist(), s.out.tolist()))
        log(f"phase 10 {tag}: wave greedy tokens fused == ref: {agree}/"
            f"{sum(len(r.out) for r in reqs)}")
        decode_step_split(
            torch, api, params, cfg, fused, kvq, dev, seed, length=S,
            max_len=eng.max_len,
            label=f"phase 10 {tag} decode step, wave shape (4 lanes at fill "
                  f"{S}+, kv_cache {kv_cache}, fused")
        del eng, ref_eng
        torch.cuda.empty_cache()
    return launches, waves["_long"]


def griffin_ring_gate(torch, dev, params, cfg, qm, prompts, card):
    """Wave (ii)'s first decode step, past the ring's wrap (3072 prompt
    positions in a 2048-slot ring; the step writes slot 1024). (1) The
    fused logits on the mxfp8 ring against the same step on a copy of the
    ring under the reference backend: the ring decoded to dense, the plain
    attention over it and the plain GEMMs. (2) Lane 0 on a dense ring
    (``kv_cache='none'``), reference backend, against the forward of its
    3073 tokens at the last position: the ring's key positions give the
    windowed attention of the full sequence. Both within RING_BAR of max
    |logit| (the MX-tie bar); (2) holds the weights in f32 without
    activation quantization, and logs the quantized comparison beside
    it."""
    from repro_torch.core.quantize import KVCacheQuant, QuantMode
    from repro_torch.kernels.packing import PackedKV
    from repro_torch.models import api
    S = 3072
    toks = _wave_tokens(torch, dev, prompts, S)
    fused, ref = qm.with_backend("fused"), qm.with_backend("ref")

    def copy(v):
        return (PackedKV(v.codes.clone(), v.scales.clone(), v.fmt, v.dtype)
                if isinstance(v, PackedKV) else v.clone())

    def agree(label, got, want, hold=True):
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log(f"phase 10 griffin ring {label}: max|diff| {err:.4e} of "
            f"max|logit| {top:.4e} ({err / top:.3e}; bar {RING_BAR}); argmax "
            f"agreement {same:.3f} on {card}")
        if hold and not err <= RING_BAR * top:
            raise AssertionError(f"phase 10: Griffin's post-wrap decode, "
                                 f"{label}")

    with torch.no_grad():
        lg, cache = api.prefill(params, cfg, toks, fused, max_len=4096,
                                kv_quant=KVCacheQuant("mxfp8"))
        nxt = lg.argmax(-1).to(torch.int32)
        twin = {k: copy(v) for k, v in cache.items()}
        lf, _ = api.decode(params, cfg, cache, nxt, S, fused)
        lr, _ = api.decode(params, cfg, twin, nxt, S, ref)
        A = cache["attn_k"].shape[2]
        agree(f"(1) decode at position {S} into slot {S % A} of {A} (the "
              f"prefill wrapped the ring {S // A}x), fused on the mxfp8 ring "
              f"against the plain attention over it decoded", lf, lr)
        ext = torch.cat([toks[:1], nxt[:1, None].to(toks.dtype)], dim=1)
        for q in (QuantMode.off(), ref):
            _, dense = api.prefill(params, cfg, toks[:1], q, max_len=4096)
            ld, _ = api.decode(params, cfg, dense, nxt[:1], S, q)
            full = api.forward(params, cfg, ext, q)[:, -1]
            agree(f"(2) lane 0 on a dense ring against the forward of its "
                  f"{S + 1} tokens, "
                  + ("f32 (activations unquantized)" if not q.enabled else
                     f"MX activations (logged: a code flipped at a tie "
                     f"compounds through {cfg.n_layers} layers)"), ld, full,
                  hold=not q.enabled)


def ssd_chunk_cost(torch, dev, params, cfg, qm, card):
    """The cost of an unbucketed Mamba2 prefill: 4 x 1324 tokens (the chunk
    rule takes q = 4: 331 chunks a layer) against 4 x 2048 (q = 256: 8),
    wall time each, synchronised."""
    from repro_torch.models import api, ssd
    out = {}
    for S in (1324, 2048):
        toks = torch.randint(0, cfg.vocab_size, (4, S), device=dev)
        with torch.no_grad():
            api.prefill(params, cfg, toks, qm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.prefill(params, cfg, toks, qm)
            torch.cuda.synchronize()
        out[S] = (time.perf_counter() - t0) * 1e3
        log(f"phase 10 mamba2 prefill 4 x {S} (chunk "
            f"{ssd.chunk_len(S, cfg.ssm_chunk)}, "
            f"{S // ssd.chunk_len(S, cfg.ssm_chunk)} chunks a layer): "
            f"{out[S]:.1f} ms wall on {card}")
    return out


def rec_train(torch, dev, seed, card, root):
    """(c) Mamba2-130M at its full config (10 steps) and RecurrentGemma-2B's
    widths at 5 layers (5 steps) under the port's Trainer: batch 8 x 512,
    bf16 parameters, remat; step times, peak memory and losses."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import TrainConfig, Trainer
    B, S = TRAIN_SHAPE
    for name, (layers, steps) in REC_TRAIN.items():
        cfg = configs.get(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, TrainConfig(
            steps=steps, batch_size=B, seq_len=S, ckpt_every=10 ** 9,
            ckpt_dir=str(root / name), keep=1, log_every=1, seed=seed,
            opt=opt.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps)),
            device=dev, log=lambda *_: None)
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [m["loss"] for m in tr.metrics]
        st = tr.step_times
        log(f"phase 10 (c) train {name} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, bf16 parameters, remat) batch {B} x seq {S}: "
            f"{steps} steps in {wall:.1f} s; step time first {st[0]:.3f} s, "
            f"median {sorted(st)[len(st) // 2]:.3f} s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; losses "
            f"{[round(x, 6) for x in losses]} on {card}")
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"phase 10 (c) {name}: losses {losses}")
        del tr
        torch.cuda.empty_cache()


def rec_latmix(torch, dev, seed, card):
    """(d) ``apply_method('latmix-lu', steps=10)`` on RecurrentGemma-2B's
    widths at REC_PTQ_LAYERS layers (random weights, the artifact CLI's
    calibration; RTN weights, T2 on the super-blocks' attention layers);
    then the first loss of ``learn_transforms`` on the card against the
    CPU's at REC_CPU_LAYERS layers on the same weights, within
    TRAJ_BARS[0] relative (phase 7's bar)."""
    import dataclasses

    from repro_torch import configs, devices
    from repro_torch.core import latmix, ptq
    from repro_torch.data import synthetic
    from repro_torch.models import api

    full = configs.get("recurrentgemma-2b")
    cfg = dataclasses.replace(full, n_layers=REC_PTQ_LAYERS)
    nb, B, S = PTQ_CALIB
    src = synthetic.make_source(cfg, B, S, seed)
    calib = [src.batch(i) for i in range(nb)]
    params = api.init(torch.Generator(device=dev).manual_seed(seed + 102),
                      cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ptq.apply_method("latmix-lu", params, cfg, calib, fmt="mxfp4",
                           steps=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"phase 10 (d) latmix-lu recurrentgemma-2b ({cfg.n_layers} of "
        f"{full.n_layers} layers, published widths), 10 steps on {nb} x {B} "
        f"x {S} calibration: {wall:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; history "
        + json.dumps(res.history) + f"; T2 {tuple(res.tset.a2.shape)} on "
        f"{card}")
    if res.tset.a2.shape[0] != cfg.n_super_blocks or not all(
            np.isfinite(h["loss"]) for h in res.history):
        raise AssertionError("phase 10 (d): latmix-lu went wrong")
    del res, params
    torch.cuda.empty_cache()
    small = dataclasses.replace(full, n_layers=REC_CPU_LAYERS)
    host = api.init(torch.Generator().manual_seed(seed + 103), small,
                    device="cpu")
    batch = {k: v[:1] for k, v in calib[0].items()}
    lx = latmix.LatmixConfig(kind="lu", steps=1)
    firsts = []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        _, _, hist = latmix.learn_transforms(
            api.fold_norms(devices.tree_to(host, where), small), small, lx,
            [batch])
        firsts.append((hist[0]["loss"], time.perf_counter() - t0))
    (lc, tc), (lh, th) = firsts
    rel = abs(lc - lh) / abs(lh)
    log(f"phase 10 (d) first latmix-lu loss at {REC_CPU_LAYERS} layers: card "
        f"{lc:.6f} ({tc:.1f} s, {card}), CPU {lh:.6f} ({th:.1f} s); "
        f"relative {rel:.3e} (bar {TRAJ_BARS[0]})")
    if not rel <= TRAJ_BARS[0]:
        raise AssertionError("phase 10 (d): the card's first loss parts "
                             "from the CPU's")


def recurrent_phase(torch, dev, seed, card):
    """Phase 10 (a)-(d): RecurrentGemma-2B and Mamba2-130M at their full
    configs served on the wave scheduler, trained, and LATMiX on Griffin's
    widths. Returns {path: launches}."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.artifacts import export_artifact, load_artifact
    from repro_torch.artifacts.store import pack_params
    from repro_torch.core import ptq
    from repro_torch.models import api
    from repro_torch.training.optimizer import tree_leaves

    t_phase = time.perf_counter()
    log(f"phase 10 on {card}")
    launches = {}
    cfg = configs.get("recurrentgemma-2b")
    t0 = time.perf_counter()
    res = ptq.apply_method("rtn", api.init(
        torch.Generator(device=dev).manual_seed(seed + 100), cfg,
        device=dev), cfg, fmt="mxfp4")
    params = pack_params(res)
    qm = dataclasses.replace(res.qm, t3_block=32)
    nparam = sum(int(np.prod(v.shape)) for v in tree_leaves(res.params))
    del res
    torch.cuda.synchronize()
    log(f"phase 10 (a) recurrentgemma-2b full config ({cfg.n_layers} layers: "
        f"{cfg.n_super_blocks} super-blocks + {cfg.n_tail_rec} recurrent, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} "
        f"KV head of {cfg.head_dim}, d_ff {cfg.d_ff}, window {cfg.window}, "
        f"vocab {cfg.vocab_size}, {nparam / 1e9:.3f} B parameters): init + "
        f"RTN + pack on the card {time.perf_counter() - t0:.1f} s, no "
        f"artifact")
    lw, wrap = rec_serve_cell(torch, dev, seed, card, params, cfg, qm,
                              "mxfp8", "griffin")
    launches.update(lw)
    griffin_ring_gate(torch, dev, params, cfg, qm, wrap, card)
    del params
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_phase

    cfg = configs.get("mamba2-130m")
    gen = torch.Generator(device=dev).manual_seed(seed + 104)
    res = ptq.apply_method("rtn", api.init(gen, cfg, device=dev), cfg,
                           fmt="mxfp4")
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    with tempfile.TemporaryDirectory() as tmp:
        art = pathlib.Path(tmp) / "mamba2-130m-mxfp4"
        export_artifact(res, cfg, art)
        del res
        params, _, qm = load_artifact(art, device=dev)
        log(f"phase 10 (b) mamba2-130m full config ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_nheads}"
            f" heads of {cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
            f"{cfg.ssm_chunk}, in_proj N = "
            f"{params['blocks']['in_proj'].shape[-1]}, vocab "
            f"{cfg.vocab_size}): exported and loaded")
        lw, _ = rec_serve_cell(torch, dev, seed, card, params, cfg, qm,
                               "none", "mamba2", art=art)
    launches.update(lw)
    ssd_chunk_cost(torch, dev, params, cfg, qm.with_backend("fused"), card)
    del params
    torch.cuda.empty_cache()
    t_b = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory() as tmp:
        rec_train(torch, dev, seed, card, pathlib.Path(tmp))
    t_c = time.perf_counter() - t_phase
    rec_latmix(torch, dev, seed, card)
    t_d = time.perf_counter() - t_phase
    log(f"phase 10: {t_d:.1f} s wall on {card} (cumulative: (a) {t_a:.1f}, "
        f"(b) {t_b:.1f}, (c) {t_c:.1f}, (d) {t_d:.1f})")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the parallel layouts on the card
# ---------------------------------------------------------------------------

PAR_STEPS = 10            # (a): Trainer steps with and without the mesh
PAR_LOSS_BAR = 1e-5       # (a): relative, per step
PAR_PROMPT = 150          # (c): phase 3's four prompts, cut to the shortest
PAR_DECODE = 32           # (c): serve steps after the prefill
PAR_PEAK_BAR = 0.25       # (d): the dry run's peak against the card's


def _bitwise(torch, a, b) -> bool:
    if isinstance(a, dict):
        return all(_bitwise(torch, a[k], b[k]) for k in a)
    return bool(torch.equal(a, b))


def parallel_train(torch, dev, seed, card, root, mesh):
    """(a) Phase 9 (a)'s setup — Qwen2-0.5B's full config, bf16, remat,
    TRAIN_SHAPE synthetic batches, AdamW lr 3e-4 — PAR_STEPS steps under
    the meshless Trainer and under ``Trainer(mesh=)`` from the same seed;
    (b) the step-PAR_STEPS checkpoint each wrote, restored into the other
    layout bit for bit. Returns each run's peak bytes."""
    from repro_torch import configs
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import TrainConfig, Trainer

    cfg = configs.get("qwen2-0.5b")
    B, S = TRAIN_SHAPE
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, TrainConfig(
            steps=PAR_STEPS, batch_size=B, seq_len=S, ckpt_every=PAR_STEPS,
            ckpt_dir=str(root / name), keep=1, log_every=1, seed=seed,
            opt=opt.AdamWConfig(lr=3e-4, warmup_steps=5,
                                total_steps=PAR_STEPS)),
            device=dev, mesh=m, log=lambda *_: None)
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        st = tr.step_times
        runs[name] = dict(
            losses=[r["loss"] for r in tr.metrics],
            wall=time.perf_counter() - t0,
            step=sorted(st)[len(st) // 2],
            peak=torch.cuda.max_memory_allocated(),
            params=sh.gather(tr.params))
        del tr
    p, m = runs["plain"], runs["mesh"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(p["losses"], m["losses"]))
    bitwise = p["losses"] == m["losses"]
    log(f"phase 11 (a) train qwen2-0.5b full, {PAR_STEPS} steps of {B} x "
        f"{S}: meshless {p['wall']:.1f} s (median step {p['step']:.3f} s, "
        f"peak {p['peak'] / 2**30:.2f} GiB), under the (1, 1) NCCL mesh "
        f"{m['wall']:.1f} s (median step {m['step']:.3f} s, peak "
        f"{m['peak'] / 2**30:.2f} GiB); losses {p['losses'][0]:.6f} -> "
        f"{p['losses'][-1]:.6f}, worst relative difference {rel:.3e}, "
        f"bitwise equal: {bitwise} on {card}")
    if len(m["losses"]) != PAR_STEPS or rel > PAR_LOSS_BAR:
        raise AssertionError(
            f"phase 11 (a): losses part by {rel:.3e} (bar {PAR_LOSS_BAR}): "
            + json.dumps({"plain": p["losses"], "mesh": m["losses"]}))

    # (b) each run's step-PAR_STEPS checkpoint into the other layout
    like = {"params": steps.abstract_params(cfg),
            "opt": steps.abstract_opt_state(cfg)}
    psh = sh.params_shardings(like["params"], cfg, "train", mesh)
    shards = {"params": psh,
              "opt": sh.opt_state_shardings(like["opt"], psh, mesh)}
    to_plain, man = ckpt.restore(root / "mesh", like, device=dev)
    to_mesh, _ = ckpt.restore(root / "plain", like, device=dev,
                              shardings=shards)
    placed = all(t.placements == s.placements for t, s in zip(
        opt.tree_leaves(to_mesh["params"]), opt.tree_leaves(psh)))
    ok = (man["step"] == PAR_STEPS and placed
          and _bitwise(torch, to_plain["params"], m["params"])
          and _bitwise(torch, sh.gather(to_mesh["params"]), p["params"]))
    log(f"phase 11 (b) the step-{PAR_STEPS} checkpoints: written under the "
        f"mesh and restored meshless, and the other way round (as "
        f"DTensors of the train layout), bit for bit: {ok} on {card}")
    if not ok:
        raise AssertionError("phase 11 (b): a checkpoint did not cross "
                             "layouts bit for bit")
    return {name: r["peak"] for name, r in runs.items()}


def parallel_serve(torch, dev, seed, card, mesh):
    """(c) Qwen2-0.5B's packed RTN mxfp4 tree (T3 before ``ffn_down``,
    fused backend, mxfp8 KV cache): ``make_prefill_step`` and PAR_DECODE
    ``make_serve_step`` steps on phase 3's four prompts (cut to
    PAR_PROMPT tokens) without a mesh and under it; tokens equal, every
    kernel launch under the mesh through the replicated route
    (``ops.on_whole``), launch counts equal. Returns the mesh run's
    launches."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.artifacts.store import pack_params
    from repro_torch.core import ptq
    from repro_torch.core.quantize import KVCacheQuant
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import pcontext as pctx
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    cfg = configs.get("qwen2-0.5b")
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = ptq.apply_method("rtn", transformer.init(gen, cfg, device=dev),
                           cfg, fmt="mxfp4")
    qm = dataclasses.replace(res.qm, t3_block=32, backend="fused")
    params = pack_params(res)
    del res
    prompts = traffic(np.random.default_rng(seed), cfg.vocab_size)
    inp = torch.as_tensor(np.stack([p[:PAR_PROMPT] for p in prompts]),
                          device=dev).long()
    B = inp.shape[0]
    prefill = steps.make_prefill_step(
        cfg, qm, max_len=PAR_PROMPT + PAR_DECODE + 1,
        kv_quant=KVCacheQuant.parse("mxfp8"))
    serve = steps.make_serve_step(cfg, qm)

    def run(params, inputs, place_cache):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = prefill(params, inputs)
        cache = place_cache(cache)
        toks = [tok]
        for i in range(PAR_DECODE):
            tok, cache = serve(params, cache, tok, PAR_PROMPT + i)
            toks.append(tok)
        torch.cuda.synchronize()
        toks = [t.full_tensor() if pctx.is_dtensor(t) else t for t in toks]
        return (torch.stack(toks, 1), time.perf_counter() - t0,
                dict(ops.launches), dict(ops.quant_paths))

    plain_toks, plain_s, plain_l, _ = run(params, inp, lambda c: c)
    dp = sh.batch_spec(cfg, B, mesh)
    with pctx.activate(mesh, batch_axes=mesh_lib.dp_axes(mesh),
                       model_axis="model"):
        dparams = sh.distribute(params, sh.params_shardings(
            params, cfg, "serve", mesh))
        dinp = sh.distribute_leaf(inp, sh.NamedSharding(mesh,
                                                        sh.Spec(dp, None)))
        mesh_toks, mesh_s, mesh_l, paths = run(
            dparams, dinp, lambda c: sh.distribute(
                c, sh.cache_shardings(c, cfg, B, mesh)))
    local = {k[0]: v for k, v in paths.items() if k[1] == "replicated"}
    kernels = ("mx_gemm_packed", "mx_flash_decode")
    equal = bool(torch.equal(plain_toks, mesh_toks))
    log(f"phase 11 (c) serve qwen2-0.5b (packed RTN mxfp4, T3, fused, "
        f"mxfp8 cache), {B} x {PAR_PROMPT}-token prompts + {PAR_DECODE} "
        f"steps: meshless {plain_s:.2f} s, under the mesh {mesh_s:.2f} s; "
        f"tokens equal: {equal}; launches meshless "
        f"{ {k: plain_l[k] for k in kernels} }, under the mesh "
        f"{ {k: mesh_l[k] for k in kernels} }, through the replicated route "
        f"{ {k: local.get(k, 0) for k in kernels} } on {card}")
    for k in kernels:
        if not (mesh_l[k] == plain_l[k] == local.get(k, 0) > 0):
            raise AssertionError(f"phase 11 (c): {k} launched {mesh_l[k]} "
                                 f"times under the mesh ({local.get(k, 0)}"
                                 f" replicated), {plain_l[k]} "
                                 f"without")
    if not equal:
        raise AssertionError("phase 11 (c): tokens under the mesh part from "
                             "the meshless steps")
    return mesh_l


def parallel_dryrun(torch, card, peaks):
    """(d) The port's dry run of (a)'s own cell (the full config, TRAIN_SHAPE,
    a (1, 1) mesh on the fake backend): its predicted peak bytes against
    (a)'s ``torch.cuda.max_memory_allocated``. Analysis, not measurement."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    B, S = TRAIN_SHAPE
    t0 = time.perf_counter()
    rec = dryrun.run_counted(configs.get("qwen2-0.5b"),
                             ShapeConfig("phase11a", S, B, "train"), False,
                             quant=False, mesh_shape=(1, 1))
    if rec["status"] != "ok":
        raise AssertionError(f"phase 11 (d): {rec['error']}\n"
                             f"{rec['traceback']}")
    mem = rec["memory"]
    pred, meas = mem["peak_bytes"], peaks["mesh"]
    rel = pred / meas - 1
    gib = {k: v / 2**30 for k, v in mem.items()}
    log(f"phase 11 (d) dry run of (a)'s cell (analysis, "
        f"{time.perf_counter() - t0:.1f} s on the host): arguments "
        f"{gib['argument_bytes']:.2f} GiB + temporaries "
        f"{gib['temp_bytes']:.2f} GiB = peak "
        f"{pred / 2**30:.2f} GiB predicted; (a) measured {meas / 2**30:.2f} "
        f"GiB under the mesh, {peaks['plain'] / 2**30:.2f} meshless "
        f"({rel:+.1%}; beyond {PAR_PEAK_BAR:.0%}: "
        f"{abs(rel) > PAR_PEAK_BAR}); {rec['flops_per_device']:.4e} FLOPs, "
        f"{rec['bytes_accessed_per_device']:.4e} bytes a step on {card}")
    return rec


def parallel_phase(torch, dev, seed, card):
    """Phase 11: a one-rank NCCL group from a FileStore, a (1, 1) ("data",
    "model") mesh on the card: (a) and (b) :func:`parallel_train`, (c)
    :func:`parallel_serve`; then, the group closed, (d)
    :func:`parallel_dryrun`. Returns {"parallel": launches}."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    log(f"phase 11 on {card}")
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        mesh_lib.init_distributed(store=dist.FileStore(str(root / "store"),
                                                       1),
                                  world_size=1, rank=0, device="cuda")
        try:
            mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
            peaks = parallel_train(torch, dev, seed, card, root, mesh)
            t_ab = time.perf_counter() - t_phase
            launches = parallel_serve(torch, dev, seed, card, mesh)
            t_c = time.perf_counter() - t_phase
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    parallel_dryrun(torch, card, peaks)
    t_d = time.perf_counter() - t_phase
    log(f"phase 11: {t_d:.1f} s wall on {card} (cumulative: (a, b) "
        f"{t_ab:.1f}, (c) {t_c:.1f}, (d) {t_d:.1f})")
    return {"parallel": launches}


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
    t_script = time.perf_counter()
    card = card_facts(torch, build)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def clock(what):
        log(f"{what} done at {time.perf_counter() - t_script:.1f} s of the "
            f"script on {card}")
    gemm_entries = check_gemm(torch, dev, gen)
    verify_gemm_times(torch, dev, args.seed)
    t0 = time.perf_counter()
    zoo_entries = zoo_kernel_entries(torch, dev, args.seed)
    log(f"phase 9 kernel rows: {time.perf_counter() - t0:.1f} s wall on "
        f"{card}")
    t0 = time.perf_counter()
    rec_entries = rec_kernel_entries(torch, dev, args.seed)
    log(f"phase 10 kernel rows: {time.perf_counter() - t0:.1f} s wall on "
        f"{card}")
    entries = [*gemm_entries,
               *check_prefill(torch, dev, gen, args.seed),
               check_decode(torch, dev, gen), check_flash_decode(torch, dev,
                                                                 gen),
               *check_quantizers(torch, dev, gen),
               check_unpacked_gemm(torch, dev, gen)]
    clock("phase 2")
    launches, served = end_to_end(torch, dev, args.seed)
    clock("phase 3")
    launches["standalone"] = standalone_path(torch, dev, served["params"])
    clock("phase 4")
    sampled = sampling_and_spec(torch, dev, args.seed, card, **served)
    launches["server"] = http_server_phase(torch, dev, args.seed, card,
                                           served, sampled)
    clock("phase 6")
    t0 = time.perf_counter()
    spec_resume_gate(torch, dev, args.seed, card, served)
    log(f"phase 9 (f): {time.perf_counter() - t0:.1f} s wall on {card}")
    del served, sampled
    launches["ptq"] = ptq_phase(torch, dev, args.seed, card)
    moe_launches, moe_entries = moe_phase(torch, dev, args.seed, card)
    launches.update(moe_launches)
    entries += moe_entries
    launches.update(zoo_phase(torch, dev, args.seed, card))
    entries += zoo_entries
    launches.update(recurrent_phase(torch, dev, args.seed, card))
    entries += rec_entries
    clock("phase 10")
    launches.update(parallel_phase(torch, dev, args.seed, card))
    clock("phase 11")
    # each kernel's launches on the path that carries it: the HTTP server
    # over the paged engine (phase 6) for the paged path's kernels, the
    # wave run for the contiguous decode, the standalone entry points
    path_of = {"mx_gemm_packed": "server", "mx_flash_decode": "wave",
               "mx_flash_prefill": "server",
               "mx_flash_decode_paged": "server",
               "mx_quantize": "standalone", "t3_quantize": "standalone",
               "mx_gemm": "standalone"}
    for e in entries:
        path = e.get("path", path_of[e["name"]])
        e.update(route="cuda", source=SOURCE[e["name"]],
                 replaces=TPU_KERNEL[e["name"]], path=path,
                 launches=launches[path][e["name"]],
                 launches_by_path={p: n.get(e["name"], 0)
                                   for p, n in launches.items()})
    log(f"card: {card}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
