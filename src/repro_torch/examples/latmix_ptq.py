"""Full LATMiX PTQ pipeline on the trained benchmark checkpoint:

  load checkpoint -> fold norms -> learn T1/T2 (KL distillation + L_vol)
  -> fold transforms -> GPTQ the weights -> evaluate every method.

Compares RTN / GPTQ / QuaRot / block-Hadamard / SpinQuant-like /
LATMiX-LU / LATMiX-QR under MXFP4 on ``experiments/bench_model`` (trained
first by the port's trainer if it is not there).

    PYTHONPATH=src python -m repro_torch.examples.latmix_ptq \
        [--fmt mxint4] [--steps 80] [--device cpu]

With --export DIR, each quantized method's result is additionally written
as a packed artifact under DIR/<method> — the deployable checkpoint that
``repro_torch.examples.serve --artifact`` serves with zero
re-quantization.
"""
import argparse
import pathlib

import torch

from repro_torch.core import ptq
from repro_torch.core import transforms as tfm
from repro_torch.models import api
from repro_torch.paper import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fmt", default="mxfp4",
                    choices=["mxfp4", "mxint4"])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--methods", default="rtn,gptq,quarot,block_hadamard,"
                                         "spinquant,latmix-lu,latmix-qr")
    ap.add_argument("--export", default="",
                    help="export each method's packed artifact under "
                         "<dir>/<method>")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    params, cfg = common.get_model(device=args.device)
    dev = params["embed"].device
    calib = common.calib_batches(cfg, device=dev)
    ev = common.eval_tokens(cfg, device=dev)

    fp = api.perplexity(params, cfg, ev)
    print(f"\n{'method':16s} {'ppl':>9s} {'vs FP':>8s}")
    print(f"{'fp16':16s} {fp:9.3f} {'100.0%':>8s}")
    for m in args.methods.split(","):
        res = ptq.apply_method(m, params, cfg, calib, fmt=args.fmt,
                               steps=args.steps)
        ppl = ptq.eval_ppl(res, cfg, ev)
        print(f"{m:16s} {ppl:9.3f} {100*fp/ppl:7.1f}%")
        if args.export:
            out = res.export(cfg, pathlib.Path(args.export) / m)
            print(f"{'':16s}   exported -> {out}")
        if res.tset is not None and m.startswith("latmix"):
            with torch.no_grad():
                dev_ = float(tfm.orthogonality_deviation(res.tset.a1))
                off = float(tfm.offblock_norm(res.tset.a1, 32))
            print(f"{'':16s}   A1: orth-dev={dev_:.3f} offblock={off:.3f}"
                  f" (Fig. 3 metrics)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
