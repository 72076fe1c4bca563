#!/usr/bin/env python3
"""Time two builds of the port's CUDA kernels back to back on one GPU.

    python3 kernel_ab.py --other DIR [--this DIR] [--rounds 3] [--only TEXT]

``DIR`` is the ``src/repro_torch/kernels/csrc`` of another checkout (for
example the parent commit, unpacked with ``git archive`` into the
git-ignored ``build/``); ``--this`` defaults to this checkout's. Every
source both trees have (their C interfaces must agree) is compiled from
each tree with the flags of ``kernels/build.py`` plus ``-Xptxas -v``,
whose register and spill report is printed. Each kernel then runs
through its ``ops`` wrapper on the same inputs as in ``chip_smoke.py`` (a
wrapper's launch goes to whichever build is loaded), in the order other,
this, this, other, ``--rounds`` times, so both builds see the same
clocks; ``--only`` keeps the cases whose label contains its text. A build
whose flash-decode entries still have the C signature without the split
scratch (before the split-key decode) is called through an adapter that
drops the new arguments. Where a case launches more than one kernel (the
GEMM's activation pass and its tile, the prefill's two chunk encodes and
its attention), its device time is also printed by kernel name. A case
whose shape one build refuses (its wrapper raises: the parent's prefill at
head_dim 128) is timed on the other build alone. The last line is a JSON
object with every time — device ms from ``torch.profiler``, in all and by
kernel name, and ms per call by CUDA events, wrapper included — and the
largest difference between the two builds' outputs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import chip_smoke as cs

SOURCES = {"mx_gemm_packed": "mx_gemm", "mx_flash_prefill": "mx_prefill",
           "mx_flash_decode_paged": "mx_decode_paged",
           "mx_flash_decode": "mx_decode", "mx_quant": "mx_quant",
           "hadamard_quant": "mx_quant", "mx_gemm": "mx_matmul"}
_C, _I = ctypes.c_void_p, ctypes.c_int
# entry -> (argument types of the signature before the split-key decode,
# position of the scratch pointer the current signature added before
# ``out``); the current one also appends (chunk, nsplit) before the stream
UNSPLIT_DECODE = {"mx_flash_decode": ([_C] * 8 + [_I] * 7 + [_C], 7),
                  "mx_flash_decode_paged": ([_C] * 9 + [_I] * 8 + [_C], 8)}


def _unsplit_adapter(fn, part_at: int):
    """Call an older flash-decode entry with the current arguments."""
    def call(*a):
        return fn(*(a[:part_at] + a[part_at + 1:-3] + a[-1:]))
    return call


# the packed GEMM's signature before the expert count E (after ``y``)
UNBATCHED_GEMM = [_C] * 5 + [_I] * 5 + [_C]


def _unbatched_adapter(fn):
    """Call an older packed-GEMM entry (no E) with the current arguments;
    only E = 1 has a meaning there."""
    def call(*a):
        if a[5] != 1:
            raise ValueError("this build predates expert-stacked calls")
        return fn(*(a[:5] + a[6:]))
    return call


def compile_tree(build, csrc: pathlib.Path, tag: str) -> dict:
    """{entry: C function} of the sources ``csrc`` has; prints ptxas's
    report."""
    out_dir = build.BUILD_DIR / "ab" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(set(SOURCES.values())):
        if not (csrc / f"{src}.cu").exists():
            continue
        lib = out_dir / f"{src}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(lib), str(csrc / f"{src}.cu")]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    fns = {}
    for src, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {src}.cu:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                cs.log(f"ptxas {tag} {src}: {line.split(':', 1)[-1].strip()}")
    for entry, src in SOURCES.items():
        if src not in procs:
            continue
        _, sym, argtypes = build._ENTRIES[entry]
        fn = getattr(ctypes.CDLL(str(procs[src][1])), sym)
        text = (csrc / f"{src}.cu").read_text()
        unsplit = entry in UNSPLIT_DECODE and "nsplit" not in text
        unbatched = entry == "mx_gemm_packed" and "int E," not in text
        if unsplit:
            argtypes = UNSPLIT_DECODE[entry][0]
        if unbatched:
            argtypes = UNBATCHED_GEMM
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[entry] = (_unsplit_adapter(fn, UNSPLIT_DECODE[entry][1])
                      if unsplit else _unbatched_adapter(fn) if unbatched
                      else fn)
    return fns


def cases(torch, dev, gen):
    """(label, entry, call) at chip_smoke.py's timed shapes."""
    from repro_torch.kernels import ops, packing, ref
    out = []
    for M, K, N, t3 in ((4, 896, 896, False), (4, 896, 128, False),
                        (4, 896, 4864, False), (4, 4864, 896, True),
                        (4096, 896, 896, False), (4096, 896, 128, False),
                        (4096, 896, 4864, False), (4096, 4864, 896, True),
                        (1024, 896, 4864, False), (5296, 896, 4864, False)):
        x = torch.randn(M, K, generator=gen, device=dev)
        pw = packing.PackedWeight.from_dense(
            torch.randn(K, N, generator=gen, device=dev) / K ** 0.5)
        out.append((f"mx_gemm_packed M={M} K={K} N={N} t3={t3}",
                    "mx_gemm_packed", 200 if M == 4 else 20,
                    lambda x=x, pw=pw, t3=t3: ops.mx_gemm_packed(
                        x, pw.codes_packed, pw.scales_e8m0, t3=t3)))
    B, H, kvh, Dh, P, maxp = 4, 14, 2, 64, 1024, 2
    D, n_pages = kvh * Dh, 1 + 4 * maxp
    kv_len = [1330, 1180, 250, 140]
    bt = cs._tables(torch, dev, gen, B, maxp, n_pages, kv_len, P)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    q = torch.randn(B, H, Dh, generator=gen, device=dev)
    kc, ks, vc, vs = cs._paged_pool(torch, dev, gen, n_pages, P, D, "mxfp8")
    out.append((f"mx_flash_decode_paged B={B} kv_len={kv_len} mxfp8",
                "mx_flash_decode_paged", 200,
                lambda: ops.mx_flash_decode_paged(q, kc, ks, vc, vs, bt,
                                                  kl - 1, kl, "mxfp8")))
    C, starts = 1024, [0, 1024, 0, 0]
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    bt2 = cs._tables(torch, dev, gen, B, maxp, n_pages,
                     [s + C for s in starts], P)
    q2 = torch.randn(B, C, H, Dh, generator=gen, device=dev)
    kd = torch.randn(B, C, D, generator=gen, device=dev)
    vd = torch.randn(B, C, D, generator=gen, device=dev)
    out.append((f"mx_flash_prefill B={B} C={C} q_start={starts} P={P} mxfp8",
                "mx_flash_prefill", 5,
                lambda: ops.mx_flash_prefill(q2, kd, vd, kc, ks, vc, vs, bt2,
                                             st, st + C, "mxfp8")[0]))
    S = 2048
    ck, sk = packing.kv_encode(torch.randn(B, S, D, generator=gen,
                                           device=dev), "mxfp8")
    cv, sv = packing.kv_encode(torch.randn(B, S, D, generator=gen,
                                           device=dev), "mxfp8")
    out.append((f"mx_flash_decode B={B} S={S} kv_len={kv_len} mxfp8",
                "mx_flash_decode", 200,
                lambda: ops.mx_flash_decode(q, ck, sk, cv, sv, kl - 1, kl,
                                            "mxfp8")))
    xq = cs._spread(torch, gen, dev, 4096, 4864)
    for entry, fn in (("mx_quant", ops.mx_quantize),
                      ("hadamard_quant", ops.t3_quantize)):
        out.append((f"{entry} M=4096 K=4864 mxfp4", entry, 20,
                    lambda fn=fn: fn(xq, "mxfp4")[0]))
    w = torch.randn(896, 4864, generator=gen, device=dev) / 896 ** 0.5
    for M, fmt in ((4, "mxfp4"), (4096, "mxfp4"), (4096, "mxfp8")):
        wc, ws = ref.mx_quant_ref(w.T.contiguous(), fmt)
        wc, ws = wc.T.contiguous(), ws.T.contiguous()
        x = torch.randn(M, 896, generator=gen, device=dev)
        out.append((f"mx_gemm M={M} K=896 N=4864 {fmt}", "mx_gemm",
                    200 if M == 4 else 20,
                    lambda x=x, wc=wc, ws=ws, fmt=fmt: ops.mx_gemm(x, wc, ws,
                                                                   fmt)))
    # the prefill again on 64-row pages through 32-slot tables (drawn last,
    # so every case above keeps its inputs)
    P64, maxp64 = 64, 32
    n64 = 1 + 4 * maxp64
    pool64 = cs._paged_pool(torch, dev, gen, n64, P64, D, "mxfp8")
    bt64 = cs._tables(torch, dev, gen, B, maxp64, n64,
                      [s + C for s in starts], P64)
    out.append((f"mx_flash_prefill B={B} C={C} q_start={starts} P={P64} "
                f"mxfp8", "mx_flash_prefill", 5,
                lambda: ops.mx_flash_prefill(q2, kd, vd, *pool64, bt64, st,
                                             st + C, "mxfp8")[0]))
    # and at Qwen2-7B's heads (28 over 4 KV heads of 128) on 1024-row pages
    # (drawn after all the others)
    H7, kvh7, Dh7 = 28, 4, 128
    D7 = kvh7 * Dh7
    pool7 = cs._paged_pool(torch, dev, gen, n_pages, P, D7, "mxfp8")
    bt7 = cs._tables(torch, dev, gen, B, maxp, n_pages,
                     [s + C for s in starts], P)
    q7 = torch.randn(B, C, H7, Dh7, generator=gen, device=dev)
    kd7 = torch.randn(B, C, D7, generator=gen, device=dev)
    vd7 = torch.randn(B, C, D7, generator=gen, device=dev)
    out.append((f"mx_flash_prefill B={B} C={C} H={H7} kvh={kvh7} Dh={Dh7} "
                f"q_start={starts} P={P} mxfp8", "mx_flash_prefill", 5,
                lambda: ops.mx_flash_prefill(q7, kd7, vd7, *pool7, bt7, st,
                                             st + C, "mxfp8")[0]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="another checkout's src/repro_torch/kernels/csrc")
    ap.add_argument("--this", type=pathlib.Path, default=None,
                    help="the csrc to hold against it (default: this "
                         "checkout's)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", default=None,
                    help="time only the cases whose label contains this")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {card}")
    builds = {"other": compile_tree(build, args.other.resolve(), "other"),
              "this": compile_tree(build, (args.this or build.CSRC).resolve(),
                                   "this")}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"card": card, "other": str(args.other),
              "this": str(args.this or build.CSRC), "kernels": []}
    for label, entry, iters, call in cases(torch, dev, gen):
        if not all(entry in b for b in builds.values()):
            continue
        if args.only and args.only not in label:
            continue
        # a build whose kernel refuses the shape (raises) is left out
        tags = []
        for tag in ("other", "this"):
            build._libs[entry] = builds[tag][entry]
            try:
                call()
                tags.append(tag)
            except RuntimeError as exc:
                cs.log(f"{label}: {tag} refuses the shape ({exc})")
        times = {t: [] for t in tags}
        splits = {t: [] for t in tags}
        outs = {}
        for _ in range(args.rounds):
            for tag in ("other", "this", "this", "other"):
                if tag not in tags:
                    continue
                build._libs[entry] = builds[tag][entry]
                splits[tag].append(cs.device_split(torch, call, iters))
                times[tag].append(cs.cuda_ms(torch, call, iters))
                outs[tag] = call()
        torch.cuda.synchronize()
        mean = {t: sum(v) / len(v) for t, v in times.items()}
        dev_times = {t: [sum(r.values()) for r in v]
                     for t, v in splits.items()}
        dmean = {t: sum(v) / len(v) for t, v in dev_times.items()}
        by_kernel = {t: {n: sum(r.get(n, 0.0) for r in v) / len(v)
                         for n in sorted({n for r in v for n in r})}
                     for t, v in splits.items()}
        if len(tags) < 2:
            diff = None
            cs.log(f"{label}: device " + ", ".join(
                f"{t} {dmean[t]:.4f} ms" for t in tags) + "; per call, "
                "wrapper included, " + ", ".join(
                    f"{t} {mean[t]:.4f} ms" for t in tags))
        else:
            diff = (outs["this"].float()
                    - outs["other"].float()).abs().max().item()
            cs.log(f"{label}: device other {dmean['other']:.4f} ms, this "
                   f"{dmean['this']:.4f} ms "
                   f"({dmean['this'] / dmean['other']:.3f}x); per call, "
                   f"wrapper included, other {mean['other']:.4f} ms, this "
                   f"{mean['this']:.4f} ms "
                   f"({mean['this'] / mean['other']:.3f}x); "
                   f"max |this - other| {diff:.3e}")
        for t, k in by_kernel.items():
            if len(k) > 1:
                cs.log(f"{label}: {t} by kernel: " + ", ".join(
                    f"{n} {v:.4f}" for n, v in k.items()))
        result["kernels"].append({"case": label, "ms": times,
                                  "mean_ms": mean, "device_ms": dev_times,
                                  "mean_device_ms": dmean,
                                  "device_ms_by_kernel": by_kernel,
                                  "max_abs_diff": diff})
    build._libs.clear()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
