"""Serve a packed MX artifact with the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --artifact DIR \
        --backend fused --scheduler continuous --kv-layout paged \
        --kv-cache mxfp8 --requests 8 --prompt-len 64 --max-new 32

Runs on the CUDA card (``--device cuda``, the default) or, when asked, on
the CPU with the kernels' plain PyTorch versions (``--device cpu``). It
loads the artifact (exported by either package), serves a synthetic wave
of requests and prints throughput and the schedule counters as JSON.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", required=True,
                    help="packed artifact directory")
    ap.add_argument("--backend", default="fused", choices=("ref", "fused"),
                    help="'fused' runs the packed weights and the quantized "
                         "KV pool through the CUDA kernels")
    ap.add_argument("--scheduler", default="continuous",
                    choices=("continuous",))
    ap.add_argument("--kv-layout", default="paged", choices=("paged",))
    ap.add_argument("--kv-cache", default="mxfp8",
                    choices=("none", "mxfp8", "mxint8", "mxfp4", "mxint4"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=None)
    ap.add_argument("--n-pages", type=int, default=None)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.serving.engine import Engine
    eng = Engine.from_artifact(
        args.artifact, batch_size=args.batch,
        max_len=max(args.max_len, args.prompt_len + args.max_new),
        backend=args.backend, scheduler=args.scheduler, eos_id=args.eos_id,
        kv_cache=args.kv_cache, kv_layout=args.kv_layout,
        page_size=args.page_size, n_pages=args.n_pages, device=args.device)
    res = eng.throughput(n_requests=args.requests,
                         prompt_len=args.prompt_len, max_new=args.max_new,
                         seed=args.seed)
    print(json.dumps(res, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
