"""Fig. 2 — transformation MSE against the MX block size (2a) and the
per-block error profile (2c), on real activations of the trained
benchmark model (the port's ``benchmarks/fig2_mse.py``).

Paper claims reproduced (C1): learned affine < block-Hadamard / Hadamard <
none; full rotations flatten the error across blocks, block-Hadamard
reduces dominant blocks, learned affine lowers all blocks.
"""
from __future__ import annotations

import torch

from repro_torch.core import mx as mxlib
from repro_torch.core import prng
from repro_torch.core import transforms as tfm
from repro_torch.models.layers import rms_norm
from repro_torch.training import optimizer as opt
from . import common


def capture_activations(params, cfg, batches):
    """Residual-stream activations entering layer 0's attention (the T1
    input distribution), (tokens, d_model) on the params' device."""
    table = params["embed"]
    outs = []
    with torch.no_grad():
        for b in batches:
            ids = torch.as_tensor(b["inputs"], device=table.device).long()
            h = rms_norm(table[ids], params["blocks"]["ln1"][0],
                         cfg.norm_eps)
            outs.append(h.reshape(-1, cfg.d_model))
    return torch.cat(outs, 0)


def learn_affine_mse(x, block_size, steps=150, lr=1e-3, kind="lu"):
    """Directly minimize E(T) (Eq. 2) over the LU parameterization — the
    'learned affine' curve of Fig. 2 (numerical study), through the STE
    quantizer with the port's AdamW. Keeps the best iterate (init is a
    block-diagonal rotation, so the result can never be worse than
    block-Hadamard)."""
    d = x.shape[-1]
    spec = tfm.TransformSpec(kind=kind, d=d, block=min(block_size, d))
    params = tfm.init_params(prng.prng_key(0, x.device), spec)
    cfg = mxlib.MXConfig(fmt="mxfp4", block_size=block_size)
    learn, fixed = params["learn"], params["fixed"]

    def loss(lr_):
        p = {"learn": lr_, "fixed": fixed}
        a, v = tfm.materialize(p, spec)
        y = tfm.forward(x, a, v)
        q = mxlib.quantize(y, cfg)           # STE
        back = tfm.backward(q, tfm.inverse(a), v)
        mse = torch.mean(torch.sum((x - back) ** 2, -1) / d)
        return mse + 0.1 * tfm.loss_vol(p, spec)

    def eval_mse(lr_):
        with torch.no_grad():
            a, v = tfm.materialize({"learn": lr_, "fixed": fixed}, spec)
            return float(tfm.transform_mse(x, a, v, cfg))

    state = opt.init_state(learn)
    ocfg = opt.AdamWConfig(lr=lr, weight_decay=0.0, warmup_steps=10,
                           total_steps=steps, grad_clip=1.0)
    best, best_mse = learn, eval_mse(learn)
    for i in range(steps):
        learn = opt.tree_map(lambda t: t.detach().requires_grad_(True),
                             learn)
        leaves = opt.tree_leaves(learn)
        gs = iter(torch.autograd.grad(loss(learn), leaves))
        grads = opt.tree_map(lambda _: next(gs), learn)
        learn, state, _ = opt.apply_updates(learn, grads, state, ocfg)
        if (i + 1) % 25 == 0:
            m = eval_mse(learn)
            if m < best_mse:
                best, best_mse = learn, m
    with torch.no_grad():
        return tfm.materialize({"learn": best, "fixed": fixed}, spec)


def _fixed(kind, d, B, seed, dev):
    spec = tfm.TransformSpec(kind=kind, d=d, block=B)
    with torch.no_grad():
        return tfm.materialize(tfm.init_params(prng.prng_key(seed, dev),
                                               spec), spec)


FIXED = ("identity", "hadamard", "block_hadamard")


def mse(x, B, a, v) -> float:
    """E(T) of ``x`` through T = (a, v) under MXFP4 at block size ``B``."""
    mxcfg = mxlib.MXConfig(fmt="mxfp4", block_size=B)
    with torch.no_grad():
        return float(tfm.transform_mse(x, a, v, mxcfg))


def fixed_mse(x, B) -> dict:
    """Fig. 2a at block size ``B``: E(T) of each fixed transform (drawn
    from key 1, as the JAX run draws them)."""
    return {kind: mse(x, B, *_fixed(kind, x.shape[-1], B, 1, x.device))
            for kind in FIXED}


def profile(x, a, v, B=32) -> list:
    """Fig. 2c: the per-block error of ``x`` through T = (a, v) at ``B``."""
    mxcfg = mxlib.MXConfig(fmt="mxfp4", block_size=B)
    with torch.no_grad():
        y = tfm.forward(x, a, v)
        back = tfm.backward(mxlib.quantize(y, mxcfg, ste=False),
                            tfm.inverse(a), v)
        return mxlib.blockwise_error(x, back, B).cpu().tolist()


def fixed_profiles(x, B=32) -> dict:
    """Fig. 2c's fixed transforms (drawn from key 2, as the JAX run)."""
    return {kind: profile(x, *_fixed(kind, x.shape[-1], B, 2, x.device), B)
            for kind in FIXED}


def run(log=print, device=None):
    params, cfg = common.get_model(log, device=device)
    x = capture_activations(params, cfg, common.eval_batches(cfg, n=2))
    rows = []
    for B in [8, 16, 32, 64]:
        errs = fixed_mse(x, B)
        errs["learned_affine"] = mse(x, B, *learn_affine_mse(x, B))
        rows.append({"name": f"fig2a_mse_B{B}", "us_per_call": 0.0,
                     "derived": ";".join(f"{k}={v:.5f}"
                                         for k, v in errs.items()),
                     **errs})
        ok = (errs["learned_affine"] <= errs["block_hadamard"] + 1e-6
              and errs["block_hadamard"] < errs["identity"])
        rows[-1]["claim_C1"] = bool(ok)

    # Fig 2c: per-block error at B=32 (vanilla vs block-hadamard vs learned)
    B = 32
    prof = fixed_profiles(x, B)
    prof["learned_affine"] = profile(x, *learn_affine_mse(x, B), B)
    rows.append({"name": "fig2c_blockwise", "us_per_call": 0.0,
                 "derived": "max_block_err:" + ";".join(
                     f"{k}={max(v):.5f}" for k, v in prof.items()),
                 "profiles": prof})
    common.emit(rows, "fig2_mse")
    return rows


if __name__ == "__main__":
    run()
