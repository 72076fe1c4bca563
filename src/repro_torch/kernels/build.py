"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` compiles, at first use, into its own shared library with
a plain C interface (no PyTorch headers, so ``nvcc`` takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The libraries land in ``build/kernels/`` at the repository root, named by
a hash of their sources, so an edited source rebuilds and an unchanged one
loads. :func:`build_all` starts one ``nvcc`` per source, all at once.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("mx_gemm", "mx_decode_paged", "mx_prefill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}
build_seconds: dict = {}       # source name -> wall seconds of its nvcc


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build from source at first use")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", CSRC / "mx_common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel; returns {name: path}.
    Raises RuntimeError with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in names}
    procs = {}
    for n, out in todo.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    errors = []
    for n, (p, tmp, out, t0) in procs.items():
        log, _ = p.communicate()
        build_seconds[n] = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {p.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mx_gemm": ("mx_gemm_packed_launch", [_C] * 5 + [_I] * 5 + [_C]),
    "mx_decode_paged": ("mx_flash_decode_paged_launch",
                        [_C] * 9 + [_I] * 8 + [_C]),
    "mx_prefill": ("mx_flash_prefill_launch", [_C] * 15 + [_I] * 9 + [_C]),
}


def kernel(name: str):
    """The C entry point of ``csrc/<name>.cu`` (built and loaded once)."""
    with _lock:
        fn = _libs.get(name)
        if fn is None:
            path = build_all((name,))[name]
            sym, argtypes = _SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(path)), sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = fn
        return fn
