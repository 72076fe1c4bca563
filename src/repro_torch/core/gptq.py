"""Round-to-nearest MX weight quantization (the RTN part of
``repro.core.gptq``; GPTQ itself comes with the PTQ slice)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from . import mx as mxlib

WEIGHT_KEYS = {"wq", "wk", "wv", "wo", "wg", "wu", "wd", "router",
               "eg", "eu", "ed", "sg", "su", "sd", "in_proj", "out_proj",
               "wx", "wy", "wor"}


def quantize_weights_rtn(params, cfg: ArchConfig, mxcfg: mxlib.MXConfig):
    """Fake-quantize every linear weight (a leaf named in WEIGHT_KEYS with
    ndim >= 2) along its input axis (-2). Returns a new nested dict."""
    del cfg

    def visit(name, leaf):
        if isinstance(leaf, dict):
            return {k: visit(k, v) for k, v in leaf.items()}
        if name in WEIGHT_KEYS and leaf.ndim >= 2:
            wq = mxlib.quantize(leaf.transpose(-1, -2), mxcfg)
            return wq.transpose(-1, -2).to(leaf.dtype).contiguous()
        return leaf

    return visit("", params)
