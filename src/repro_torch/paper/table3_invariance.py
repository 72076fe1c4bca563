"""Table 3 — computational-invariance relaxation: FP model perplexity after
fusing the learned T1/T2 at several transform-training step counts (the
port's ``benchmarks/table3_invariance.py``). The paper's claim (C4):
fusing the learned affine transforms changes FP quality negligibly
(distillation keeps the models consistent)."""
from __future__ import annotations

import torch

from repro_torch import devices
from repro_torch.core import latmix as lx_lib
from repro_torch.core import prng
from repro_torch.core.quantize import QuantMode
from repro_torch.models import api
from . import common

STEPS = (0, 1, 50, 150)


def fused_ppl(pn, cfg, calib, ev, steps):
    """FP perplexity of the norm-folded ``pn`` with T1/T2 learned for
    ``steps`` steps (0: Ω at its init) folded in."""
    lx = lx_lib.LatmixConfig(kind="lu", steps=max(steps, 1),
                             lr=1e-3 if steps else 0.0)
    if steps == 0:
        omega = lx_lib.init_omega(prng.prng_key(0, devices.of(pn)), cfg, lx)
        with torch.no_grad():
            tset = lx_lib.materialize_set(omega, cfg, lx)
    else:
        _, tset, _ = lx_lib.learn_transforms(pn, cfg, lx, calib)
    with torch.no_grad():
        folded = api.fold(pn, cfg, tset)
    return api.perplexity(folded, cfg, ev, QuantMode.off(t3=32))


def run(log=print, steps=STEPS, device=None):
    params, cfg = common.get_model(log, device=device)
    dev = devices.of(params)
    calib = common.calib_batches(cfg, device=dev)
    ev = common.eval_tokens(cfg, device=dev)
    fp_ppl = api.perplexity(params, cfg, ev)
    rows = [{"name": "table3_fp16", "us_per_call": 0.0,
             "derived": f"ppl={fp_ppl:.4f}", "ppl": fp_ppl}]
    pn = api.fold_norms(params, cfg)
    for n in steps:
        ppl = fused_ppl(pn, cfg, calib, ev, n)
        drift = abs(ppl - fp_ppl) / fp_ppl
        log(f"[table3] steps={n:4d} fused-FP ppl={ppl:.4f} "
            f"(drift {100*drift:.2f}%)")
        rows.append({"name": f"table3_steps{n}", "us_per_call": 0.0,
                     "derived": f"ppl={ppl:.4f};drift={100*drift:.2f}%",
                     "ppl": ppl, "drift": drift})
    worst = max(r["drift"] for r in rows if "drift" in r)
    rows.append({"name": "table3_claimC4", "us_per_call": 0.0,
                 "derived": f"max_drift={100*worst:.2f}%;"
                            f"negligible={bool(worst < 0.10)}"})
    common.emit(rows, "table3_invariance")
    return rows


if __name__ == "__main__":
    run()
