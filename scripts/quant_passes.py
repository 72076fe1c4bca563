#!/usr/bin/env python3
"""Where the standalone MX quantizers' device time goes, on one GPU.

    python3 scripts/quant_passes.py

Builds ``src/repro_torch/kernels/csrc/mx_quant.cu`` as it is, with parts
left out (``-DMXQUANT_LEAVE_OUT``, see the source: the T3 rotation, the
encode, the loads, the stores, or several) into the git-ignored
``build/quant_passes/``, and times ``mx_quant`` and ``hadamard_quant`` by
device time (``chip_smoke.device_split``) at ``chip_smoke.py``'s timed
shape, M = 4096, K = 4864 (the ffn_down activation of Qwen2-0.5B at 4096
rows), mxfp4 and mxfp8. A variant that leaves a part out is wrong by
design; only its time is read. The last line is a JSON object with every
time.
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

# name -> MXQUANT_LEAVE_OUT bits: 1 the T3 rotation, 2 the encode, 4 the
# loads, 8 the stores ("loads and stores only": a copy with the layout's
# addressing; "no loads, no stores": the rotation and encode alone)
VARIANTS = {"full": 0, "no rotation": 1, "no encode": 2,
            "loads and stores only": 3, "no loads": 4, "no stores": 8,
            "no loads, no stores": 12}
FMTS = {"mxfp4": 0, "mxfp8": 2}


def build_variants(build) -> dict:
    """{variant: {entry: C function}}, all compiled at once."""
    out_dir = build.BUILD_DIR.parent / "quant_passes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, bits in VARIANTS.items():
        lib = out_dir / f"leave_out_{bits}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS,
             f"-DMXQUANT_LEAVE_OUT={bits}", "-o", str(lib),
             str(build.CSRC / "mx_quant.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fns[name] = {}
        for entry in ("mx_quant", "hadamard_quant"):
            fn = getattr(ctypes.CDLL(str(lib)), f"{entry}_launch")
            fn.argtypes = build._ENTRIES[entry][2]
            fn.restype = ctypes.c_int
            fns[name][entry] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("quant_passes.py: no CUDA device", file=sys.stderr)
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
    M, K = 4096, 4864
    x = cs._spread(torch, gen, dev, M, K)
    codes = torch.empty(M, K, dtype=torch.uint8, device=dev)
    scales = torch.empty(M, K // 32, device=dev)
    times: dict = {}
    for fmt, fid in FMTS.items():
        for entry in ("mx_quant", "hadamard_quant"):
            label = f"{entry} M={M} K={K} {fmt}"
            times[label] = {}
            for name, per in fns.items():
                def call(fn=per[entry], name=name):
                    rc = fn(x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                            M, K, fid, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: launch failed ({rc})")
                ms = sum(cs.device_split(torch, call, 50).values())
                times[label][name] = ms
                cs.log(f"{label} {name:22s} device ms {ms:.4f}")
    print(json.dumps({"card": card, "device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
