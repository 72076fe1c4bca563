#!/usr/bin/env python3
"""Where the paged MX flash-prefill's device time goes, on one GPU.

    python3 scripts/prefill_passes.py [--heads qwen2-0.5b|qwen2-7b]

Builds ``src/repro_torch/kernels/csrc/mx_prefill.cu`` as it is and with the
attention's parts left out (``-DMXPREFILL_LEAVE_OUT``, see the source: the
decoder's TMA loads, its decode, the wgmmas, the softmax, the decoder's
proxy fence, the ranking of the blocks' work, or several)
into the git-ignored ``build/prefill_passes/``, and times the attention
(``flash_prefill_kernel``, apart from the chunk encodes) by device time
(``chip_smoke.device_split``) at ``chip_smoke.py``'s timed shape, B = 4
lanes of a 1024-row mxfp8 chunk at q_start = [0, 1024, 0, 0], on 1024-row
and on 64-row pages, with the heads of Qwen2-0.5B (14 over 2 KV heads of
64, the default) or of Qwen2-7B (28 over 4 KV heads of 128). A variant's
output is wrong by design; only its time is read. The last line is a JSON
object with every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# name -> MXPREFILL_LEAVE_OUT bits: 1 the decoder's TMA loads, 2 its
# decode, 4 the wgmmas, 8 the softmax, 32 the decoder's proxy fence, 64 the
# ranking of the blocks' work ("no loads, no decode": the consumers alone;
# "no wgmma, no softmax": the decoder alone; "pipeline only": neither)
VARIANTS = {"full": 0, "no loads": 1, "no loads, no decode": 3,
            "no wgmma": 4, "no softmax": 8, "no wgmma, no softmax": 12,
            "pipeline only": 15, "pipeline only, no fence": 47,
            "pipeline only, no rank": 79, "no rank": 64}
PAGES = ((1024, 2), (64, 32))
HEADS = {"qwen2-0.5b": (14, 2, 64), "qwen2-7b": (28, 4, 128)}  # H, kvh, Dh


def build_variants(build) -> dict:
    """{variant: the C entry ``mx_flash_prefill_launch`` of its build}, all
    compiled at once."""
    out_dir = build.BUILD_DIR.parent / "prefill_passes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, bits in VARIANTS.items():
        lib = out_dir / f"leave_out_{bits}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS,
             f"-DMXPREFILL_LEAVE_OUT={bits}", "-o", str(lib),
             str(build.CSRC / "mx_prefill.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).mx_flash_prefill_launch
        fn.argtypes = build._ENTRIES["mx_flash_prefill"][2]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--heads", choices=sorted(HEADS), default="qwen2-0.5b",
                    help="the query and KV heads of the timed shape")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("prefill_passes.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {card}")
    fns = build_variants(build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, C = 4, 1024
    H, kvh, Dh = HEADS[args.heads]
    D, starts = kvh * Dh, [0, 1024, 0, 0]
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    kl = st + C
    q = torch.randn(B, C, H, Dh, generator=gen, device=dev)
    kd = torch.randn(B, C, D, generator=gen, device=dev)
    vd = torch.randn(B, C, D, generator=gen, device=dev)
    out = torch.empty(B, C, H, Dh, device=dev)
    kc = torch.empty(B, C, D, dtype=torch.uint8, device=dev)
    ks = torch.empty(B, C, D // 32, dtype=torch.uint8, device=dev)
    vc, vs = torch.empty_like(kc), torch.empty_like(ks)
    times: dict = {}
    for P, maxp in PAGES:
        n_pages = 1 + B * maxp
        pool = cs._paged_pool(torch, dev, gen, n_pages, P, D, "mxfp8")
        bt = cs._tables(torch, dev, gen, B, maxp, n_pages,
                        [s + C for s in starts], P)
        label = (f"B={B} C={C} H={H} kvh={kvh} Dh={Dh} q_start={starts} "
                 f"P={P} mxfp8")
        times[label] = {}
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                rc = fn(*(t.data_ptr() for t in (q, kd, vd, *pool, bt, st, kl,
                                                 out, kc, ks, vc, vs)),
                        B, C, H, Dh, D, P, maxp, 2, 0,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            ms = cs.device_split(torch, call, 20).get("flash_prefill_kernel",
                                                      0.0)
            times[label][name] = ms
            cs.log(f"prefill {label} {name:22s} device ms {ms:.4f}")
    print(json.dumps({"card": card, "flash_prefill_kernel_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
