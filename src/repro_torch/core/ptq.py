"""PTQ pipeline of the port: ``apply_method`` for ``"rtn"`` (the learned
transforms and GPTQ come with the PTQ slice)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ArchConfig

from . import gptq as gptq_lib
from . import mx as mxlib
from .quantize import QuantMode

METHODS = ["rtn"]


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


def apply_method(method: str, params, cfg: ArchConfig, calib=None,
                 fmt: str = "mxfp4") -> PTQResult:
    """``"rtn"``: MX round-to-nearest on every linear weight, activations
    quantized at run time, no transform (as the JAX package's 'rtn')."""
    if method != "rtn":
        raise ValueError(f"method {method!r} is not ported yet "
                         f"(ported: {METHODS})")
    del calib
    mxcfg = mxlib.MXConfig(fmt=fmt, block_size=32)
    qm = QuantMode(enabled=True, act_cfg=mxcfg, weight_cfg=None, t3_block=0)
    return PTQResult(gptq_lib.quantize_weights_rtn(params, cfg, mxcfg), qm,
                     None, [], method)
