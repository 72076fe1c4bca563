"""Table 2 — transformation type × granularity ablation (MXFP4 ppl):
random Hadamard / learned orthogonal (±bias) / learned invertible /
LATMiX-LU, each at Block and Full granularity (the port's
``benchmarks/table2_granularity.py``).

Paper claim reproduced (C2): Full + affine (LATMiX) is best; learning
helps over fixed rotations; the bias term helps at full granularity.
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

VARIANTS = [
    # (label, kind, learn_bias)
    ("none", None, False),
    ("random_hadamard", "hadamard", False),
    ("learned_orth", "orthogonal", False),
    ("learned_orth_bias", "orthogonal", True),
    ("learned_inv", "invertible", False),
    ("latmix_lu", "lu", True),
]


def variant_ppl(params, cfg, calib, ev, kind, bias, gran, steps):
    """MXFP4 perplexity of one cell: RTN weights, MX activations, after
    the transform ``kind`` at granularity ``gran`` learned for ``steps``
    (kind None: no transform)."""
    mxcfg = mxlib.MXConfig(fmt="mxfp4", block_size=32)
    if kind is None:
        qparams = gptq_lib.quantize_weights_rtn(params, cfg, mxcfg)
        qm = QuantMode(enabled=True, act_cfg=mxcfg, t3_block=0)
        return api.perplexity(qparams, cfg, ev, qm)
    k = "block_hadamard" if (kind == "hadamard" and gran == "block") else kind
    lx = lx_lib.LatmixConfig(
        kind=k, learn_bias=bias, steps=steps,
        granularity="full" if k == "block_hadamard" else gran)
    pn = api.fold_norms(params, cfg)
    _, tset, _ = lx_lib.learn_transforms(pn, cfg, lx, calib)
    with torch.no_grad():
        folded = api.fold(pn, cfg, tset)
    qparams = gptq_lib.quantize_weights_rtn(folded, cfg, mxcfg)
    qm = QuantMode(enabled=True, act_cfg=mxcfg, t3_block=lx.t3_block)
    return api.perplexity(qparams, cfg, ev, qm)


def run(log=print, steps=100, device=None):
    params, cfg = common.get_model(log, device=device)
    dev = devices.of(params)
    calib = common.calib_batches(cfg, device=dev)
    ev = common.eval_tokens(cfg, device=dev)
    rows = []
    for label, kind, bias in VARIANTS:
        grans = ["full"] if kind is None else ["block", "full"]
        for gran in grans:
            ppl = variant_ppl(params, cfg, calib, ev, kind, bias, gran,
                              steps)
            name = f"table2_{label}_{gran}"
            log(f"[table2] {label:18s} {gran:5s} ppl={ppl:.3f}")
            rows.append({"name": name, "us_per_call": 0.0,
                         "derived": f"ppl={ppl:.3f}", "ppl": ppl})
    by = {r["name"]: r["ppl"] for r in rows}
    ok = by.get("table2_latmix_lu_full", 9e9) <= min(
        v for k, v in by.items() if k != "table2_latmix_lu_full") * 1.05
    rows.append({"name": "table2_claimC2", "us_per_call": 0.0,
                 "derived": f"latmix_full_best={bool(ok)}"})
    common.emit(rows, "table2_granularity")
    return rows


if __name__ == "__main__":
    run()
