#!/usr/bin/env python3
"""Where the large-M packed MX GEMM tile's device time goes, on one GPU.

    python3 scripts/gemm_passes.py

Builds ``src/repro_torch/kernels/csrc/mx_gemm.cu`` as it is and with the
tile's parts left out (``-DMXGEMM_LEAVE_OUT``, see ``mx_gemm.cuh``: its
copies, its weight decode, its wgmmas, or two of them) into the git-ignored
``build/gemm_passes/``, and times the tile (``gemm_kernel``, apart from the
activation pass) by device time (``chip_smoke.device_split``) at two
prefill shapes of Qwen2-0.5B: M = 4096 at (K, N) = (896, 4864) and
(896, 128). A variant's output is wrong by design; only its time is read.
The time of each kernel of the full build against another tree's is
``kernel_ab.py``'s. The last line is a JSON object with every time.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# name -> MXGEMM_LEAVE_OUT bits: 1 the copies, 2 the decode, 4 the wgmmas
VARIANTS = {"full": 0, "no decode": 2, "no wgmma": 4, "no loads": 1,
            "no loads, no decode": 3, "no loads, no wgmma": 5,
            "no decode, no wgmma": 6}
SHAPES = ((4096, 896, 4864), (4096, 896, 128))


def build_variants(build) -> dict:
    """{variant: the C entry ``mx_gemm_packed_launch`` of its build}, all
    compiled at once."""
    out_dir = build.BUILD_DIR.parent / "gemm_passes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, bits in VARIANTS.items():
        lib = out_dir / f"leave_out_{bits}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-DMXGEMM_LEAVE_OUT={bits}",
             "-o", str(lib), str(build.CSRC / "mx_gemm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).mx_gemm_packed_launch
        fn.argtypes = build._ENTRIES["mx_gemm_packed"][2]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gemm_passes.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, packing
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {card}")
    fns = build_variants(build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out: dict = {}
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen, device=dev)
        pw = packing.PackedWeight.from_dense(
            torch.randn(K, N, generator=gen, device=dev) / K ** 0.5)
        xq = torch.empty(2 * M * K, dtype=torch.uint8, device=dev)
        y = torch.empty(M, N, device=dev)
        label = f"M={M} K={K} N={N}"
        out[label] = {}
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                rc = fn(x.data_ptr(), xq.data_ptr(),
                        pw.codes_packed.data_ptr(), pw.scales_e8m0.data_ptr(),
                        y.data_ptr(), 1, M, N, K, 0, 0,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            ms = cs.device_split(torch, call, 20).get("gemm_kernel", 0.0)
            out[label][name] = ms
            cs.log(f"tile {label} {name:22s} device ms {ms:.4f}")
    print(json.dumps({"card": card, "tile_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
