"""Shared pieces of the port's tests that run the JAX package's PTQ code
(``test_torch_paper*.py``, ``test_torch_examples.py``): both bench models,
and :func:`jax_jitted`, which puts the JAX package's hot functions under
``jax.jit`` for a module (eager JAX compiles each op anew, seconds a
call; the same functions, traced — the RTN weights come out bitwise
equal)."""
import contextlib
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from repro.core import gptq as jgptq  # noqa: E402
from repro.core import transforms as jtfm  # noqa: E402
from repro.core.folding import TransformSet  # noqa: E402
from repro.kernels import packing as jpacking  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.paper import common  # noqa: E402


def _jit_fold(fold):
    """``fold(params, cfg, tset)`` under ``jax.jit``: the TransformSet is
    a plain dataclass, so its fields go through as arguments."""
    core = jax.jit(lambda p, cfg, a1, v1, a2, v2, t3: fold(
        p, cfg, TransformSet(a1, v1, a2, v2, t3)), static_argnums=(1, 6))
    return lambda p, cfg, t: core(p, cfg, t.a1, t.v1, t.a2, t.v2,
                                  t.t3_block)


def _jit_pack(pack):
    """``pack_weight(w, fmt)`` under ``jax.jit``; the bundle's ``fmt`` and
    ``shape`` are added back outside."""
    core = jax.jit(lambda w, fmt: {k: v for k, v in pack(w, fmt).items()
                                   if k not in ("fmt", "shape")},
                   static_argnums=1)
    return lambda w, fmt="mxfp4": {**core(w, fmt), "fmt": fmt,
                                   "shape": tuple(w.shape)}


def _jit_unpack(unpack):
    """``unpack_weight(bundle, dtype)`` under ``jax.jit``."""
    core = jax.jit(lambda c, s, fmt, dtype: unpack(
        {"codes_packed": c, "scales_e8m0": s, "fmt": fmt}, dtype),
        static_argnums=(2, 3))
    return lambda b, dtype=jnp.float32: core(b["codes_packed"],
                                             b["scales_e8m0"], b["fmt"],
                                             dtype)


# (module, name, how to jit it): the static arguments are configs
JITTED = ((japi, "forward", dict(static_argnums=(1, 3))),
          (japi, "fold_norms", dict(static_argnums=1)),
          (japi, "fold", _jit_fold),
          (jgptq, "quantize_weights_rtn", dict(static_argnums=(1, 2))),
          (jtfm, "_init_matrix", dict(static_argnums=1)),
          (jtfm, "materialize", dict(static_argnums=1)),
          (jtfm, "transform_mse", dict(static_argnums=3)),
          (jpacking, "pack_weight", _jit_pack),
          (jpacking, "unpack_weight", _jit_unpack))


@contextlib.contextmanager
def jax_jitted():
    """The JAX package's functions of JITTED under ``jax.jit`` while open."""
    with pytest.MonkeyPatch.context() as m:
        for mod, name, how in JITTED:
            fn = getattr(mod, name)
            m.setattr(mod, name, how(fn) if callable(how)
                      else jax.jit(fn, **how))
        yield


@contextlib.contextmanager
def at_root():
    """Both packages find ``experiments/bench_model`` from the repo root."""
    here = os.getcwd()
    os.chdir(ROOT)
    try:
        yield
    finally:
        os.chdir(here)


@pytest.fixture(scope="module")
def models():
    """(JAX params, port params, JAX cfg, port cfg) of the bench model."""
    with jax_jitted():
        with at_root():
            jp, cfg = jcommon.get_model(log=lambda *_: None)
            tp, tcfg = common.get_model(log=lambda *_: None, device="cpu")
        yield jp, tp, cfg, tcfg


@pytest.fixture(scope="module")
def data(models):
    """Calibration and evaluation data of both packages (numpy seeds)."""
    jp, tp, cfg, tcfg = models
    return {"jcalib": jcommon.calib_batches(cfg),
            "calib": common.calib_batches(tcfg, device="cpu"),
            "jev": jcommon.eval_tokens(cfg),
            "ev": common.eval_tokens(tcfg, device="cpu"),
            "ev_batches": common.eval_batches(tcfg)}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree
