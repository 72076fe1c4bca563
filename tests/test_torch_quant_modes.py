"""The port's quant modes and MX numerics against the JAX package:
``QuantMode.mxint4`` / ``QuantMode.nvfp4`` field for field, NVFP4 routing
every linear to the reference path under the fused backend in both
packages, stochastic MX rounding bitwise jax's for the same key (and
nearest rounding without one, and a zero gradient, as ``jax.grad`` gives),
``jax.random.uniform`` in every float dtype, the packed byte counts,
``quantize_weight_for_kernel``, and the serve example under ``--quant
mxint4``. Inputs come from numpy seeds; each comparison states its bar."""
import dataclasses
import inspect
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_engine_helpers import BENCH, checkpoint, jax_tree
from repro.configs.base import ArchConfig as JArch
from repro.core import mx as jmx
from repro.core.quantize import QuantMode as JQM
from repro.kernels import ops as jops
from repro.kernels import packing as jpk
from repro.models import api as japi
from repro.obs import MetricsRegistry as JRegistry
from repro_torch import convert
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import mx as tmx
from repro_torch.core import prng
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packing as tpk
from repro_torch.models import api as tapi
from repro_torch.obs import MetricsRegistry as TRegistry

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# stochastic rounding's formats: MX at 4 and 8 bits, and NVFP4
STOCH = {"mxfp4": dict(fmt="mxfp4"), "mxint4": dict(fmt="mxint4"),
         "mxfp8": dict(fmt="mxfp8"),
         "nvfp4": dict(fmt="mxfp4", block_size=16, scale_mode="fp8")}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


# ---------------------------------------------------------------------------
# QuantMode.mxint4 / QuantMode.nvfp4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("off", "mxfp4", "mxint4", "nvfp4"))
def test_quant_mode_factories_take_jax_signatures(name):
    """Same parameter names and defaults: ``nvfp4`` has no ``backend``."""
    jp = inspect.signature(getattr(JQM, name)).parameters
    tp = inspect.signature(getattr(TQM, name)).parameters
    assert [(k, p.default) for k, p in tp.items()] == \
        [(k, p.default) for k, p in jp.items()]


@pytest.mark.parametrize("backend", ("ref", "fused"))
@pytest.mark.parametrize("t3", (True, False))
@pytest.mark.parametrize("weights", (True, False))
def test_mxint4_mode_equals_jax(weights, t3, backend):
    t = TQM.mxint4(weights=weights, t3=t3, backend=backend)
    j = JQM.mxint4(weights=weights, t3=t3, backend=backend)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.act_cfg.fmt == "mxint4" and t.backend == backend


@pytest.mark.parametrize("t3", (True, False))
@pytest.mark.parametrize("weights", (True, False))
def test_nvfp4_mode_equals_jax(weights, t3):
    t, j = TQM.nvfp4(weights=weights, t3=t3), JQM.nvfp4(weights=weights,
                                                       t3=t3)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.act_cfg == tmx.NVFP4 and t.backend == "ref"
    assert (t.weight_cfg == tmx.NVFP4) == weights


def _quant_labels(registry) -> set:
    return {(m.labels["op"], m.labels["path"], m.labels["role"])
            for m in registry if m.name == "quant_dispatch_total"}


def test_nvfp4_under_the_fused_backend_routes_ref_in_both_packages():
    """NVFP4's 16-blocks and FP8 scales are off the packed kernel's
    contract: under ``backend="fused"`` every linear takes the reference
    path in both packages, with the same ``quant_dispatch_total`` labels;
    no packed GEMM is dispatched. The bench model's logits under NVFP4
    agree within 1e-2 of max |logit| (the bar for MX ties, ROADMAP
    "Decided")."""
    tree = checkpoint()
    tokens = np.random.default_rng(5).integers(0, 512, (2, 24)).astype(
        np.int32)
    jcfg, tcfg = JArch(**BENCH), TArch(**BENCH)
    jqm, tqm = (JQM.nvfp4().with_backend("fused"),
                TQM.nvfp4().with_backend("fused"))
    jreg, treg = JRegistry(), TRegistry()
    jops.instrument(jreg)
    try:
        jl = np.asarray(jax.jit(lambda p, t: japi.forward(p, jcfg, t, jqm))(
            jax_tree(tree), jnp.asarray(tokens)))
    finally:
        jops.uninstrument()
    tops.instrument(treg)
    try:
        tl = tapi.forward(convert.params_from_numpy(tree, device="cpu"),
                          tcfg, torch.as_tensor(tokens).long(), tqm).numpy()
    finally:
        tops.uninstrument()
    labels = _quant_labels(treg)
    assert labels == _quant_labels(jreg)
    assert {p for _, p, _ in labels} == {"ref"}
    assert {r for _, _, r in labels} == {"qkv", "attn_out", "ffn_in",
                                         "ffn_down", "head"}
    assert not any(m.labels.get("op") == "mx_gemm_packed" for m in treg)
    assert np.abs(tl - jl).max() <= 1e-2 * np.abs(jl).max()


def test_serve_example_runs_under_mxint4():
    """``python -m repro_torch.examples.serve --quant mxint4 --device
    cpu`` exits 0 (it called a ``QuantMode.mxint4`` the port lacked)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve", "--quant",
         "mxint4", "--device", "cpu"], capture_output=True, text=True,
        env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "throughput:" in res.stdout and "(mxint4," in res.stdout


# ---------------------------------------------------------------------------
# Stochastic MX rounding
# ---------------------------------------------------------------------------

def _x(seed: int, shape=(8, 64)) -> np.ndarray:
    """Normal values with their rows spread over several binades."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp2(rng.integers(-3, 4, (shape[0], 1)))).astype(np.float32)


def _cfgs(name: str, stochastic: bool = True):
    kw = dict(STOCH[name], stochastic=stochastic)
    return tmx.MXConfig(**kw), jmx.MXConfig(**kw)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("name", tuple(STOCH))
def test_stochastic_quantize_is_bitwise_jax(name, dtype):
    """``quantize(x, cfg(stochastic=True), key=...)`` gives jax's values
    bit for bit under the same seed (equal threefry uniforms, the same
    bracketing and compare); the draws move some values off the nearest
    grid point, and another key moves others."""
    tdt, jdt = DTYPES[dtype]
    x = _x(1)
    tcfg, jcfg = _cfgs(name)
    outs = []
    for seed in (0, 7):
        t = tmx.quantize(torch.as_tensor(x).to(tdt), tcfg,
                         key=prng.prng_key(seed)).float().numpy()
        j = np.asarray(jmx.quantize(jnp.asarray(x, jdt), jcfg,
                                    key=jax.random.PRNGKey(seed))
                       .astype(jnp.float32))
        np.testing.assert_array_equal(t, j)
        outs.append(t)
    nearest = tmx.quantize(torch.as_tensor(x).to(tdt),
                           _cfgs(name, False)[0]).float().numpy()
    assert (outs[0] != nearest).any() and (outs[0] != outs[1]).any()


@pytest.mark.parametrize("name", tuple(STOCH))
def test_stochastic_config_without_a_key_rounds_to_nearest(name):
    """No key: round to nearest, as in JAX (bitwise both ways)."""
    x = _x(2)
    tcfg, jcfg = _cfgs(name)
    t = tmx.quantize(torch.as_tensor(x), tcfg).numpy()
    np.testing.assert_array_equal(
        t, tmx.quantize(torch.as_tensor(x), _cfgs(name, False)[0]).numpy())
    np.testing.assert_array_equal(t, np.asarray(jmx.quantize(
        jnp.asarray(x), jcfg)))


def test_stochastic_path_takes_no_straight_through_gradient():
    """With a key the gradient is zero, as ``jax.grad`` gives (no
    ``custom_vjp`` on that path); without one it passes straight through
    in both packages."""
    x, w = _x(3), _x(4)
    tcfg, jcfg = _cfgs("mxfp4")

    def jgrad(key):
        return np.asarray(jax.grad(lambda v: jnp.sum(
            jmx.quantize(v, jcfg, key=key) * w))(jnp.asarray(x)))

    def tgrad(key):
        xt = torch.as_tensor(x).clone().requires_grad_(True)
        (tmx.quantize(xt, tcfg, key=key) * torch.as_tensor(w)).sum() \
            .backward()
        return xt.grad.numpy()

    assert not jgrad(jax.random.PRNGKey(0)).any()
    assert not tgrad(prng.prng_key(0)).any()
    np.testing.assert_array_equal(jgrad(None), w)
    np.testing.assert_array_equal(tgrad(None), w)


@pytest.mark.parametrize("dtype", tuple(DTYPES))
def test_uniform_is_bitwise_jax_in_every_float_dtype(dtype):
    """``prng.uniform(key, shape, dtype=...)`` equals
    ``jax.random.uniform`` bit for bit: bfloat16 takes jax's 8-bit draw,
    float16 its 16-bit one."""
    tdt, jdt = DTYPES[dtype]
    t = prng.uniform(prng.prng_key(11), (4, 300), dtype=tdt)
    j = jax.random.uniform(jax.random.PRNGKey(11), (4, 300), jdt)
    assert t.dtype == tdt
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Packed byte counts and the unpacked kernel layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("fmt", ("mxfp4", "mxint4"))
def test_packed_weight_byte_counts_equal_jax(fmt, dtype):
    """``nbytes_packed`` (codes and scale bytes) and ``nbytes_dense``
    (the logical shape at the logical dtype's itemsize), stacked."""
    tdt, jdt = DTYPES[dtype]
    w = _x(5, (3 * 96, 40)).reshape(3, 96, 40)
    t = tpk.PackedWeight.from_dense(torch.as_tensor(w).to(tdt), fmt)
    j = jpk.PackedWeight.from_dense(jnp.asarray(w, jdt), fmt)
    assert (t.nbytes_packed, t.nbytes_dense) == \
        (j.nbytes_packed, j.nbytes_dense)
    assert t.nbytes_packed == 3 * (96 // 2 + 96 // 32) * 40


@pytest.mark.parametrize("fmt", tpk.KV_FMTS)
def test_packed_kv_byte_count_equals_jax(fmt):
    x = _x(6, (2 * 10, 64)).reshape(2, 10, 64)
    t = tpk.PackedKV.from_dense(torch.as_tensor(x), fmt)
    j = jpk.PackedKV.from_dense(jnp.asarray(x), fmt)
    assert t.nbytes_packed == j.nbytes_packed


@pytest.mark.parametrize("fmt", ("mxfp4", "mxint4", "mxfp8"))
def test_quantize_weight_for_kernel_equals_jax(fmt):
    """Codes byte for byte and scales exactly; the unpacked GEMM over them
    agrees with the JAX package's plain version within 1e-5 of max |y|
    (f32 products in another order)."""
    w, x = _x(7, (96, 40)), _x(8, (5, 96))
    tc, ts = tops.quantize_weight_for_kernel(torch.as_tensor(w), fmt)
    jc, js = jops.quantize_weight_for_kernel(jnp.asarray(w), fmt)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tuple(tc.shape) == (96, 40) and tuple(ts.shape) == (3, 40)
    y = tops.mx_gemm(torch.as_tensor(x), tc, ts, fmt).numpy()
    yj = np.asarray(jops.mx_matmul_ref(jnp.asarray(x), jc, js, fmt))
    assert np.abs(y - yj).max() <= 1e-5 * np.abs(yj).max()
