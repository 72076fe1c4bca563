"""End-to-end PTQ pipeline of the port — every method of
``repro.core.ptq``, for every family, under one interface:

    result = apply_method(method, params, cfg, calib, fmt)

Methods (Table 1 / Table 2 / Table 6 rows):
  'fp'              no quantization (teacher)
  'rtn'             MX RTN on weights+acts, no transform
  'gptq'            MX GPTQ on weights, acts RTN, no transform
  'quarot'          fixed full random-Hadamard T1/T2 (+GPTQ)
  'quarot-rtn'      same transform, RTN weights
  'block_hadamard'  fixed block-diagonal Hadamard (MR-GPTQ/BRQ structure)
  'spinquant'       learned orthogonal T1/T2 (CE loss, per App. D.2)
  'ostquant'        learned orthogonal × diagonal scaling (OSTQuant-style)
  'flatquant'       learned Kronecker-structured invertible T1 (+distill)
  'inv'             learned invertible (LU, no bias) — "Learned Inv. Matrix"
  'latmix-lu'       LATMiX, LU parameterization (Eq. 5)
  'latmix-qr'       LATMiX, QR parameterization (Eq. 6)
  '*-block'         any learned method at block granularity (Table 2)

Every transform-based method runs the same pipeline (fold norms -> learn
or fix Ω -> fold -> weight quant), on the device of ``params``. The JAX
package's gates hold: GPTQ for the dense family only (the others take RTN
weights), T2 wherever ``latmix.t2_applicable`` (not ``ssm``; ``hybrid``
only on its attention layers); a stub-frontend family's T1 stays as
``input_transform``."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import devices
from repro_torch.configs.base import ArchConfig
from repro_torch.models import api

from . import gptq as gptq_lib
from . import latmix as lx_lib
from . import mx as mxlib
from .quantize import QuantMode

METHODS = ["fp", "rtn", "gptq", "quarot", "quarot-rtn", "block_hadamard",
           "spinquant", "ostquant", "flatquant", "inv", "latmix-lu",
           "latmix-qr"]


@dataclasses.dataclass
class PTQResult:
    params: dict
    qm: QuantMode
    tset: Optional[object]
    history: list
    method: str

    def export(self, cfg: ArchConfig, out_dir, **kw):
        """Persist as a packed artifact directory (see artifacts.store)."""
        from repro_torch.artifacts import export_artifact
        return export_artifact(self, cfg, out_dir, **kw)


def _mx_cfg(fmt: str) -> mxlib.MXConfig:
    if fmt == "nvfp4":
        return mxlib.NVFP4
    return mxlib.MXConfig(fmt=fmt, block_size=32)


def _lat_cfg(method: str, fmt: str, steps: int,
             block: bool) -> lx_lib.LatmixConfig:
    c = _mx_cfg(fmt)
    base = dict(act_fmt=c.fmt, block_size=c.block_size,
                scale_mode=c.scale_mode, steps=steps,
                granularity="block" if block else "full")
    kinds = {"quarot": ("hadamard", False, "kl"),
             "quarot-rtn": ("hadamard", False, "kl"),
             "block_hadamard": ("block_hadamard", False, "kl"),
             "spinquant": ("orthogonal", False, "ce"),
             # OSTQuant (Hu et al. 2025): orthogonal + scaling
             "ostquant": ("orth_scale", False, "kl"),
             "flatquant": ("kron", True, "kl"),
             "inv": ("invertible", False, "kl"),
             "latmix-lu": ("lu", True, "kl"),
             "latmix-qr": ("qr", True, "kl")}
    if method not in kinds:
        raise ValueError(method)
    kind, bias, loss = kinds[method]
    return lx_lib.LatmixConfig(kind=kind, learn_bias=bias, loss=loss, **base)


def apply_method(method: str, params, cfg: ArchConfig,
                 calib: Optional[List[dict]] = None, fmt: str = "mxfp4",
                 steps: int = 120, weight_quant: str = "gptq",
                 log=None) -> PTQResult:
    """Run ``method`` on ``params`` (a tensor tree on the device it runs
    on) with the calibration batches ``calib`` (dicts of 'inputs' — (B, S)
    tokens or (B, S, d) embeddings — and (B, S) 'labels', numpy or torch;
    'fp' and 'rtn' need none)."""
    block = method.endswith("-block")
    base_method = method[:-6] if block else method
    mxcfg = _mx_cfg(fmt)

    if base_method == "fp":
        return PTQResult(params, QuantMode.off(), None, [], method)

    if base_method in ("rtn", "gptq"):
        qm = QuantMode(enabled=True, act_cfg=mxcfg, weight_cfg=None,
                       t3_block=0)
        if base_method == "rtn" or cfg.family != "dense":
            qp = gptq_lib.quantize_weights_rtn(params, cfg, mxcfg)
        else:
            stats = gptq_lib.capture_hessians(params, cfg, calib, qm)
            qp = gptq_lib.quantize_weights_gptq(params, cfg, stats, mxcfg,
                                                t3_block=0)
        return PTQResult(qp, qm, None, [], method)

    # ---- transform-based methods ----
    lx = _lat_cfg(base_method, fmt, steps, block)
    pn = api.fold_norms(params, cfg)
    _, tset, hist = lx_lib.learn_transforms(pn, cfg, lx, calib, log=log)
    with torch.no_grad():
        folded = api.fold(pn, cfg, tset)
    qm = QuantMode(enabled=True, act_cfg=mxcfg, weight_cfg=None,
                   t3_block=lx.t3_block)
    wq = "rtn" if base_method == "quarot-rtn" else weight_quant
    if wq == "gptq" and cfg.family == "dense":
        stats = gptq_lib.capture_hessians(folded, cfg, calib, qm)
        qp = gptq_lib.quantize_weights_gptq(folded, cfg, stats, mxcfg,
                                            t3_block=lx.t3_block)
    else:
        qp = gptq_lib.quantize_weights_rtn(folded, cfg, mxcfg)
    return PTQResult(qp, qm, tset, hist, method)


def eval_ppl(result: PTQResult, cfg: ArchConfig, tokens) -> float:
    dev = devices.of(result.params)
    return api.perplexity(result.params, cfg,
                          torch.as_tensor(tokens, device=dev).long(),
                          result.qm)


def zero_shot_proxy(result: PTQResult, cfg: ArchConfig, eval_batches,
                    n_choices: int = 4, seed: int = 0,
                    teacher_logits=None) -> float:
    """Multiple-choice proxy for the zero-shot suites: rank the true next
    token against hard negatives drawn from the *teacher's* top
    predictions at each position (method-independent), or uniformly when
    no teacher is given."""
    rng = np.random.default_rng(seed)
    dev = devices.of(result.params)
    correct = total = 0
    for bi, b in enumerate(eval_batches):
        with torch.no_grad():
            logits = api.forward(result.params, cfg,
                                 torch.as_tensor(b["inputs"],
                                                 device=dev).long(),
                                 result.qm)
            lp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
        labels = np.asarray(b["labels"])
        B, S = labels.shape
        pos = rng.integers(S // 2, S, size=(B, 4))
        tl = (np.asarray(teacher_logits[bi])
              if teacher_logits is not None else None)
        for i in range(B):
            for t in pos[i]:
                t = int(t)
                gold = labels[i, t]
                if tl is not None:
                    top = np.argsort(-tl[i, t])[:n_choices + 2]
                    distract = np.asarray(
                        [c for c in top if c != gold][:n_choices - 1])
                else:
                    distract = rng.choice(cfg.vocab_size,
                                          size=n_choices - 1)
                scores = lp[i, t, np.concatenate([[gold], distract])]
                correct += int(np.argmax(scores) == 0)
                total += 1
    return correct / max(total, 1)
