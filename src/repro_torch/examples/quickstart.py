"""Quickstart: build a small LM, quantize it to MXFP4 with LATMiX, and
compare perplexity against RTN — in a few minutes on a CPU, seconds on the
card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch import devices
from repro_torch.configs.base import ArchConfig
from repro_torch.core import ptq
from repro_torch.data import synthetic
from repro_torch.models import api


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=60,
                    help="LATMiX transform-learning steps")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    # 1. a small llama-style model (random init for speed; see
    #    train_lm.py + latmix_ptq.py for the trained pipeline)
    cfg = ArchConfig(name="quickstart", family="dense", n_layers=3,
                     d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
                     d_ff=352, vocab_size=512, attn_chunk=64)
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    print(f"model: {cfg.param_count()/1e6:.2f}M params on {dev}")

    # 2. calibration + eval data (synthetic Zipf–Markov corpus)
    src = synthetic.make_source(cfg, 8, 64, seed=0)
    calib = [src.batch(i) for i in range(3)]
    ev = torch.as_tensor(src.batch(100)["inputs"], device=dev).long()

    fp_ppl = api.perplexity(params, cfg, ev)
    print(f"FP32 ppl          : {fp_ppl:9.2f}")

    # 3. RTN baseline vs LATMiX-LU (learned affine transforms + GPTQ)
    for method in ["rtn", "latmix-lu"]:
        res = ptq.apply_method(method, params, cfg, calib, fmt="mxfp4",
                               steps=args.steps)
        ppl = ptq.eval_ppl(res, cfg, ev)
        print(f"MXFP4 {method:12s}: {ppl:9.2f}  "
              f"(recovery {100*fp_ppl/ppl:.1f}% of FP ppl ratio)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
