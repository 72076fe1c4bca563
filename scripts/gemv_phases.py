#!/usr/bin/env python3
"""Where the small-M packed GEMM's time goes, phase by phase, on one GPU.

    python3 scripts/gemv_phases.py

Builds ``src/repro_torch/kernels/csrc/mx_gemm.cu`` as it is and in variants
that stop the kernel after a phase or leave one out, into the git-ignored
``build/gemv_phases/``, and times each at Qwen2-0.5B's four decode shapes
(M = 4, mxfp4) by device time (``chip_smoke.device_ms``). A variant's
output is wrong by design; only its time is read. The variants patch the
source text: if a pattern is no longer in the source, the script stops and
names it. The last line is a JSON object with every time.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

STOP = "  if (kbb > 0) return;\n"
WAIT = ('  if constexpr (kVec) asm volatile("cp.async.wait_all;\\n" ::: '
        '"memory");\n  __syncthreads();\n')
ACT = "  // this warp's activation elements\n"
EXCHANGE = "  __syncthreads();\n  // every block of the cluster has started"
# name -> [(source text, replacement)]; the shapes below stage their split
# in one chunk, so the variants stop the kernel after its one chunk's phase
VARIANTS = {
    "full": [],
    "empty (launch only)": [
        ("  coop::cluster_group cluster = coop::this_cluster();\n",
         "  coop::cluster_group cluster = coop::this_cluster();\n" + STOP)],
    "stop after staging": [(ACT, WAIT + STOP + ACT)],
    "stop after encode": [(WAIT, WAIT + STOP)],
    "stop after compute": [
        (EXCHANGE, EXCHANGE.replace("\n", "\n" + STOP, 1))],
    "no cluster exchange": [
        ("cluster.map_shared_rank(recv, o / per)[rank * per + o % per] = s;",
         "recv[o] = s;"),
        ("  cluster.sync();\n  // this block",
         "  __syncthreads();\n  // this block"),
        ("attr.val.clusterDim.y = nsplit;", "attr.val.clusterDim.y = 1;")],
    "T3 encoded in the kernel": [
        ("constexpr int MAX_INKERNEL_KBB = 2 * KW;",
         "constexpr int MAX_INKERNEL_KBB = KCH;")],
}
SHAPES = ((896, 896, False), (896, 128, False), (896, 4864, False),
          (4864, 896, True))


def build_variants(build) -> dict:
    src = (build.CSRC / "mx_gemm.cu").read_text()
    out = build.BUILD_DIR.parent / "gemv_phases"
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: pattern not in mx_gemm.cu: "
                                 f"{old!r}")
            text = text.replace(old, new)
        d = out / f"v{i}"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(build.CSRC, d)
        (d / "mx_gemm.cu").write_text(text)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "mx_gemm.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), d / "lib.so")
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
        print("gemv_phases.py: no CUDA device", file=sys.stderr)
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
    result = {"card": card, "ms": {}}
    for K, N, t3 in SHAPES:
        x = torch.randn(4, K, generator=gen, device=dev)
        pw = packing.PackedWeight.from_dense(
            torch.randn(K, N, generator=gen, device=dev) / K ** 0.5)
        xq = torch.empty(4 * 4 * K, dtype=torch.uint8, device=dev)
        y = torch.empty(4, N, device=dev)
        label = f"M=4 K={K} N={N} t3={t3}"
        result["ms"][label] = {}
        for name, fn in fns.items():
            def call(fn=fn):
                rc = fn(x.data_ptr(), xq.data_ptr(),
                        pw.codes_packed.data_ptr(), pw.scales_e8m0.data_ptr(),
                        y.data_ptr(), 1, 4, N, K, 0, int(t3),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            ms = cs.device_ms(torch, call, 200)
            result["ms"][label][name] = ms
            cs.log(f"{label} {name:26s} device ms {ms:.4f}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
