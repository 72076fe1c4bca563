#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order (each raises on failure; nothing is caught):

1. card facts: ``nvidia-smi`` name and power limit, torch / CUDA versions,
   the build of the three CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the Qwen2-0.5B shapes of the serving path, with CUDA-event times of the
   kernel, the plain version and one PyTorch library call, and the least
   time the card could take (``bound_ms``);
3. end to end: Qwen2-0.5B at its published widths (24 layers, random
   weights from a seed, RTN mxfp4 with the T3 rotation) exported as an
   artifact and served by ``Engine.from_artifact`` (fused backend,
   continuous scheduler, paged mxfp8 KV cache) for four requests, two of
   which share a one-page prefix; the kernel launch counts of that run;
   then the first prefill and one decode step again with every kernel
   call held against its plain version on the same inputs (the values the
   reference backend computes there), and the fused logits and greedy
   tokens compared with the reference backend's.

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

TPU_KERNEL = {   # the Pallas kernel each CUDA kernel replaces (def line)
    "mx_gemm_packed": "src/repro/kernels/mx_matmul.py:170",
    "mx_flash_prefill": "src/repro/kernels/mx_attention.py:478",
    "mx_flash_decode_paged": "src/repro/kernels/mx_attention.py:270",
}
SOURCE = {
    "mx_gemm_packed": "src/repro_torch/kernels/csrc/mx_gemm.cu",
    "mx_flash_prefill": "src/repro_torch/kernels/csrc/mx_prefill.cu",
    "mx_flash_decode_paged": "src/repro_torch/kernels/csrc/mx_decode_paged.cu",
}


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
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels import ops, packing, ref
    cases = [(m, k, n, t3) for m in (4, 4096)
             for (k, n, t3) in ((896, 896, False), (896, 128, False),
                                (896, 4864, False), (4864, 896, True))]
    entry = None
    for M, K, N, t3 in cases:
        x = torch.randn(M, K, generator=gen, device=dev)
        w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
        pw = packing.PackedWeight.from_dense(w)
        y = ops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
        yp = ref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0,
                                      t3=t3)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        tol = 1e-4 * yp.abs().max().item()
        log(f"gemm M={M} K={K} N={N} t3={t3}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"mx_gemm_packed disagrees with its plain "
                                 f"version at M={M} K={K} N={N} t3={t3}")
        iters = 200 if M == 4 else 20
        ms = cuda_ms(torch, lambda: ops.mx_gemm_packed(
            x, pw.codes_packed, pw.scales_e8m0, t3=t3), iters)
        plain = cuda_ms(torch, lambda: ref.mx_matmul_packed_ref(
            x, pw.codes_packed, pw.scales_e8m0, t3=t3), max(iters // 4, 5))
        xq = mxlib.quantize(x)
        wd = pw.to_dense()
        lib = cuda_ms(torch, lambda: torch.matmul(xq, wd), iters)
        nbytes = M * K * 4 + K * N // 2 + K * N // 32 + M * N * 4
        b, by = bound_ms(nbytes, 2.0 * M * N * K, PEAK_FP8)
        log(f"gemm M={M} K={K} N={N} t3={t3}: kernel_ms {ms:.4f} plain_ms "
            f"{plain:.4f} library_ms {lib:.4f} bound_ms {b:.4f} ({by})")
        if (M, K, N) == (4096, 896, 4864):
            entry = {"name": "mx_gemm_packed",
                     "shape": f"M={M} K={K} N={N} t3={t3}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by, "library_ms": lib}
    return entry


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
    from repro_torch.kernels import ops, ref
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
            if fmt != "mxfp8" or window:
                continue
            ms = cuda_ms(torch, lambda: ops.mx_flash_decode_paged(
                q, kc, ks, vc, vs, bt, qp, kl, fmt), 200)
            plain = cuda_ms(torch, lambda: ref.mx_attention_paged_ref(
                q, kc, ks, vc, vs, bt, qp, kl, fmt), 20)
            kd, vd = _sdpa_inputs(torch, kc, ks, vc, vs, bt, fmt, kvh, Dh, G)
            S = kd.shape[2]
            kp = torch.arange(S, device=dev)
            mask = (kp[None, :] < kl[:, None].long())[:, None, None, :]
            q4 = q[:, :, None, :].contiguous()
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask), 200)
            row = D + D // 32          # mxfp8: one code byte per feature
            nbytes = (2 * B * H * Dh * 4 + 2 * sum(kv_len) * row
                      + bt.numel() * 4 + 2 * B * 4)
            b, by = bound_ms(nbytes, 4.0 * H * Dh * sum(kv_len), PEAK_BF16)
            log(f"decode {fmt} B={B} kv_len={kv_len}: kernel_ms {ms:.4f} "
                f"plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms "
                f"{b:.4f} ({by})")
            entry = {"name": "mx_flash_decode_paged",
                     "shape": f"B={B} H={H} kvh={kvh} Dh={Dh} P={P} "
                              f"kv_len={kv_len} {fmt}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by, "library_ms": lib}
    return entry


def check_prefill(torch, dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B, C, H, kvh, Dh, P, maxp = 4, 1024, 14, 2, 64, 1024, 2
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
        log(f"prefill {fmt} q_start={starts}: max_abs_err {err:.3e}, "
            f"chunk bytes equal to kv_encode: {same}")
        if not (err <= 1e-4 and same):
            raise AssertionError(f"mx_flash_prefill disagrees with its plain "
                                 f"version ({fmt}, q_start {starts})")
        if fmt != "mxfp8" or starts[1] != 1024:
            continue
        ms = cuda_ms(torch, lambda: ops.mx_flash_prefill(
            q, kd, vd, kc, ks, vc, vs, bt, st, kl, fmt), 5)
        plain = cuda_ms(torch, lambda: ref.mx_prefill_ref(
            q, kd, vd, kc, ks, vc, vs, bt, st, kl, fmt), 3)
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
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), 5)
        row = D + D // 32
        nbytes = (2 * B * C * H * Dh * 4 + 2 * B * C * D * 4
                  + 2 * B * C * row + 2 * sum(starts) * row + bt.numel() * 4)
        keys = sum(C * s + C * (C + 1) // 2 for s in starts)
        b, by = bound_ms(nbytes, 4.0 * H * Dh * keys, PEAK_BF16)
        log(f"prefill {fmt} B={B} C={C} q_start={starts}: kernel_ms {ms:.4f} "
            f"plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms {b:.4f} "
            f"({by})")
        entry = {"name": "mx_flash_prefill",
                 "shape": f"B={B} C={C} H={H} kvh={kvh} Dh={Dh} P={P} "
                          f"q_start={starts} {fmt}",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b, "bound_by": by, "library_ms": lib}
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


def profile_serving(torch, eng, Request, cfg, seed: int) -> None:
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
    log(f"profile: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%), {len(rows)} kernel names")
    for ms, n, key in rows[:15]:
        log(f"profile: {ms:10.3f} ms {n:7d}x  {key[:90]}")


def end_to_end(torch, dev, seed: int):
    import dataclasses

    from repro_torch import configs
    from repro_torch.artifacts import export_artifact, load_artifact
    from repro_torch.core import ptq
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine, Request

    cfg = configs.get("qwen2-0.5b")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = transformer.init(gen, cfg, device=dev)
    res = ptq.apply_method("rtn", params, cfg, fmt="mxfp4")
    # random weights carry no folded T3 inverse; the rotation still runs,
    # so the ffn_down prologue of the GEMM kernel is on the path
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    del params
    with tempfile.TemporaryDirectory() as tmp:
        art = pathlib.Path(tmp) / "qwen2-0.5b-mxfp4"
        export_artifact(res, cfg, art)
        del res
        torch.cuda.synchronize()
        log(f"e2e: init + RTN + export {time.perf_counter() - t0:.1f} s "
            f"({cfg.n_layers} layers)")
        kw = dict(batch_size=4, max_len=2048, scheduler="continuous",
                  kv_layout="paged", kv_cache="mxfp8", device=dev)
        eng = Engine.from_artifact(art, backend="fused", **kw)
        params, _, qm = load_artifact(art, device=dev)

    prompts = traffic(np.random.default_rng(seed), cfg.vocab_size)
    reqs = [Request(prompt=p, max_new=32) for p in prompts]

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.launches)
    st = eng.stats()
    toks = sum(len(r.out) for r in reqs)
    log(f"e2e: {len(reqs)} requests, {toks} tokens in {dt:.3f} s = "
        f"{toks / dt:.1f} tok/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("e2e stats: " + json.dumps({k: st[k] for k in (
        "admitted", "decode_steps", "slot_steps", "prefill_chunk_steps",
        "prefill_lane_steps", "prefill_batched_steps", "prefix_hit_tokens",
        "blocks_in_use")}))
    log(f"e2e launches: {launches}")
    for r in reqs:
        if r.state.value != "finished" or len(r.out) != 32:
            raise AssertionError(f"request ended {r.state.value} with "
                                 f"{len(r.out)} tokens: {r.error}")
    if st["prefix_hit_tokens"] <= 0:
        raise AssertionError("the shared prefix was not served from cache")
    eng._alloc.check()
    if eng._alloc.in_use:
        raise AssertionError(f"{eng._alloc.in_use} pages still in use")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    if launches["mx_flash_decode_paged"] != st["decode_steps"] * cfg.n_layers:
        raise AssertionError(
            f"decode kernel launched {launches['mx_flash_decode_paged']}x, "
            f"expected decode_steps x layers = "
            f"{st['decode_steps'] * cfg.n_layers}")
    if not all(((r.out >= 0) & (r.out < cfg.vocab_size)).all()
               for r in reqs):
        raise AssertionError("token ids outside the vocabulary")
    profile_serving(torch, eng, Request, cfg, seed)

    # The first prefill and one decode step again, fused, with every kernel
    # call held against its plain version on the same inputs: the values
    # the reference backend computes at that call, at all layers.
    P, C = eng.page_size, cfg.attn_chunk
    p0 = prompts[0]
    worst = teacher_forced(torch, ops, lambda q: prefill_and_step(
        torch, transformer, params, cfg, q, eng.kv_quant, P, C, p0, dev),
        qm.with_backend("fused"))
    log("e2e teacher-forced, worst error per kernel call: "
        + json.dumps(worst))
    # Full depth, fused against reference. An attention output that moves by
    # 1e-7 flips an activation code at a grid midpoint downstream, and the
    # flips compound layer by layer through random weights, so these logits
    # are compared loosely (a wiring fault decorrelates them entirely).
    logits = {b: prefill_and_step(torch, transformer, params, cfg,
                                  qm.with_backend(b), eng.kv_quant, P, C, p0,
                                  dev)[0] for b in ("fused", "ref")}
    diff = (logits["fused"] - logits["ref"]).abs().max().item()
    scale = logits["ref"].abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        logits["fused"], logits["ref"], dim=0).item()
    log(f"e2e: fused vs ref prefill logits max|diff| {diff:.4e}, "
        f"max|logit| {scale:.4e}, cosine {cos:.4f}, same argmax "
        f"{bool(logits['fused'].argmax() == logits['ref'].argmax())}")
    if not cos >= 0.5:
        raise AssertionError("fused prefill logits are unrelated to ref")
    ref_eng = Engine(params, cfg, qm.with_backend("ref"), **kw)
    ref_reqs = [Request(prompt=p, max_new=32) for p in prompts]
    ref_eng.generate(ref_reqs)
    agree = sum(int(a == b) for r, s in zip(reqs, ref_reqs)
                for a, b in zip(r.out.tolist(), s.out.tolist()))
    log(f"e2e: greedy tokens fused == ref: {agree}/{toks}")
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
    disagreement, returns the worst error seen per kernel."""
    from repro_torch.kernels import ref
    plain = {"mx_gemm_packed": ref.mx_matmul_packed_ref,
             "mx_flash_prefill": ref.mx_prefill_ref,
             "mx_flash_decode_paged": ref.mx_attention_paged_ref}
    worst = {n: 0.0 for n in plain}
    saved = {n: getattr(ops, n) for n in plain}

    def checked(name):
        def call(*a, **k):
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
    return worst


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
    entries = [check_gemm(torch, dev, gen), check_prefill(torch, dev, gen),
               check_decode(torch, dev, gen)]
    launches = end_to_end(torch, dev, args.seed)
    for e in entries:
        e.update(route="cuda", source=SOURCE[e["name"]],
                 replaces=TPU_KERNEL[e["name"]],
                 launches=launches[e["name"]])
    log(f"card: {card}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
