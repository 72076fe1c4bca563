"""App. E.3 / E.5 ablations (the port's ``benchmarks/table8_ablations.py``):
  - loss function for Ω: MSE vs CE vs KL (Table 8) — KL best on the
    out-of-distribution proxy, CE best in-distribution.
  - calibration-set size (Table 9): 1 -> 8 batches.
  - regularization factor λ robustness (Table 12).
"""
from __future__ import annotations

import torch

from repro_torch import devices
from repro_torch.core import gptq as gptq_lib
from repro_torch.core import latmix as lx_lib
from repro_torch.core import mx as mxlib
from repro_torch.core.quantize import QuantMode
from repro_torch.models import api
from . import common


def _quantized_ppl(params, cfg, tset, lx, ev):
    with torch.no_grad():
        folded = api.fold(params, cfg, tset)
    mxcfg = mxlib.MXConfig(fmt="mxfp4", block_size=32)
    qp = gptq_lib.quantize_weights_rtn(folded, cfg, mxcfg)
    qm = QuantMode(enabled=True, act_cfg=mxcfg, t3_block=lx.t3_block)
    return api.perplexity(qp, cfg, ev, qm)


def ablation_ppl(pn, cfg, ev, steps, n_calib=4, **lx_kw):
    """MXFP4 perplexity after LATMiX-LU learned for ``steps`` on
    ``n_calib`` calibration batches with ``lx_kw`` (loss, lambda_vol)."""
    lx = lx_lib.LatmixConfig(kind="lu", steps=steps, **lx_kw)
    calib = common.calib_batches(cfg, n=n_calib, device=devices.of(pn))
    _, tset, _ = lx_lib.learn_transforms(pn, cfg, lx, calib)
    return _quantized_ppl(pn, cfg, tset, lx, ev)


def run(log=print, steps=80, device=None):
    params, cfg = common.get_model(log, device=device)
    pn = api.fold_norms(params, cfg)
    ev = common.eval_tokens(cfg, device=devices.of(params))
    rows = []

    # ---- Table 8: loss ablation ----
    for loss in ["mse", "ce", "kl"]:
        ppl = ablation_ppl(pn, cfg, ev, steps, loss=loss)
        log(f"[table8] loss={loss:4s} ppl={ppl:.3f}")
        rows.append({"name": f"table8_loss_{loss}", "us_per_call": 0.0,
                     "derived": f"ppl={ppl:.3f}", "ppl": ppl})

    # ---- Table 9: calibration size ----
    for n in [1, 2, 8]:
        ppl = ablation_ppl(pn, cfg, ev, steps, n_calib=n)
        log(f"[table9] calib_batches={n} ppl={ppl:.3f}")
        rows.append({"name": f"table9_calib{n}", "us_per_call": 0.0,
                     "derived": f"ppl={ppl:.3f}", "ppl": ppl})

    # ---- Table 12: λ robustness ----
    ppls = []
    for lam in [0.01, 0.1, 1.0]:
        ppl = ablation_ppl(pn, cfg, ev, steps, lambda_vol=lam)
        ppls.append(ppl)
        log(f"[table12] lambda={lam} ppl={ppl:.3f}")
        rows.append({"name": f"table12_lambda{lam}", "us_per_call": 0.0,
                     "derived": f"ppl={ppl:.3f}", "ppl": ppl})
    spread = (max(ppls) - min(ppls)) / min(ppls)
    rows.append({"name": "table12_robustness", "us_per_call": 0.0,
                 "derived": f"rel_spread={100*spread:.2f}%;"
                            f"robust={bool(spread < 0.08)}"})
    common.emit(rows, "table8_ablations")
    return rows


if __name__ == "__main__":
    run()
