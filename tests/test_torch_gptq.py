"""The port's GPTQ and RTN against the JAX package's, on the CPU, and the
registry's methods that learn nothing (fp, rtn, gptq, quarot, quarot-rtn,
block_hadamard) end to end on the 2-layer config of
tests/test_ptq_pipeline.py.

Bars, and why:
- ``gptq_matrix`` on the data of tests/test_ptq_pipeline.py (and with a
  dead input, and over a stack of layers) gives the JAX package's codes
  exactly: float64 throughout, the same row order and grid lookup. The
  ties that part them are recorded (``GPTQ_TIES``, none on this data);
- ``rtn_matrix``: equal;
- ``capture_hessians``: 1e-5 of max |H| in FP; with the act quantizer on,
  1e-2 (an f32 sum an ulp to the other side of an MX snap midpoint moves
  one activation by a grid step: ROADMAP Queue 3, "MX ties");
- ``quantize_weights_gptq`` on the JAX package's Hessians: equal;
- ``apply_method`` end to end: every leaf equal, except that a quantized
  weight may part in at most ``TIE_SHARE`` of its elements (a tie in an
  f32 product, compensated through its column by GPTQ) and a float leaf
  within 1e-5 of its max |value| (the T1 products in another order); the
  perplexity within 1e-2 (a tie's code moves it by 0.3% on this random
  model)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArch
from repro.core import gptq as jg
from repro.core import mx as jmx
from repro.core import ptq as jptq
from repro.core.quantize import QuantMode as JQM
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro_torch import convert
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import gptq as tg
from repro_torch.core import mx as tmx
from repro_torch.core import ptq as tptq
from repro_torch.core.quantize import QuantMode as TQM

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

SMALL = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=128, attn_chunk=64)
JCFG, TCFG = JArch(**SMALL), TArch(**SMALL)
GPTQ_TIES = {"mxfp4": 0, "mxint4": 0, "nvfp4": 0}
TIE_SHARE = 0.12


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _cfgs(fmt):
    if fmt == "nvfp4":
        return jmx.NVFP4, tmx.NVFP4
    return jmx.MXConfig(fmt=fmt), tmx.MXConfig(fmt=fmt)


def _correlated():
    """The data of tests/test_ptq_pipeline.py's GPTQ test."""
    rng = np.random.default_rng(0)
    d_in, d_out, n = 96, 48, 1024
    mix = rng.standard_normal((d_in, d_in)) * 0.3 + np.eye(d_in)
    x = rng.standard_normal((n, d_in)) @ mix
    x[:, 5] *= 7.0
    w = rng.standard_normal((d_in, d_out)).astype(np.float32) * 0.2
    return x, w, x.T @ x


@pytest.mark.parametrize("fmt", ("mxfp4", "mxint4", "nvfp4"))
def test_gptq_matrix_matches_jax(fmt):
    x, w, H = _correlated()
    cj, ct = _cfgs(fmt)
    qj = jg.gptq_matrix(w.copy(), H, cj)
    qt = tg.gptq_matrix(torch.from_numpy(w.copy()), torch.from_numpy(H), ct)
    assert qt.dtype == torch.float32
    assert int((qt.numpy() != qj).sum()) == GPTQ_TIES[fmt]
    rt = tg.rtn_matrix(torch.from_numpy(w), ct)
    np.testing.assert_array_equal(rt.numpy(), jg.rtn_matrix(w, cj))
    # GPTQ beats RTN here; with pow2 scales it lands on RTN's grid (RTN of
    # it is itself; NVFP4's GPTQ takes unsnapped scales, as the JAX
    # package's does)
    mse = lambda q: float(np.mean((x @ w - x @ q) ** 2))  # noqa: E731
    assert mse(qt.numpy()) < mse(rt.numpy())
    if ct.scale_mode == "pow2":
        np.testing.assert_array_equal(tg.rtn_matrix(qt, ct).numpy(),
                                      qt.numpy())


def test_gptq_dead_inputs_and_layer_stack_match_jax():
    """A dead input (zero Hessian row) zeroes its weight row; a stack of
    layers in one sweep gives each layer's own result."""
    _, w, H = _correlated()
    H2 = H.copy()
    H2[7, :] = 0.0
    H2[:, 7] = 0.0
    ws, Hs = np.stack([w, 1.5 * w]), np.stack([H, H2])
    cj, ct = _cfgs("mxfp4")
    qt = tg.gptq_matrix(torch.from_numpy(ws), torch.from_numpy(Hs), ct)
    for i in range(2):
        np.testing.assert_array_equal(
            qt[i].numpy(), jg.gptq_matrix(ws[i].copy(), Hs[i], cj))
    assert not qt[1, 7].any()


@pytest.fixture(scope="module")
def setup():
    pj = japi.init(jax.random.PRNGKey(0), JCFG)
    pt = convert.params_from_numpy(_np(pj), "cpu")
    src = jsyn.make_source(JCFG, 4, 32, 0)
    calib = [src.batch(i) for i in range(2)]
    jcal = [{k: jnp.asarray(v) for k, v in b.items()} for b in calib]
    return pj, pt, calib, jcal


def _hessians(params_j, calib, jcal, qj, qt):
    hj = jg.capture_hessians(params_j, JCFG, jcal, qj)
    ht = tg.capture_hessians(convert.params_from_numpy(_np(params_j), "cpu"),
                             TCFG, calib, qt)
    return hj, ht


@pytest.mark.parametrize("quant", (False, True))
def test_capture_hessians_matches_jax(setup, quant):
    pj, _, calib, jcal = setup
    c = jmx.MXConfig()
    qj = (JQM(enabled=True, act_cfg=c, t3_block=32) if quant
          else JQM.off(32))
    qt = (TQM(enabled=True, act_cfg=tmx.MXConfig(), t3_block=32) if quant
          else TQM.off(32))
    hj, ht = _hessians(pj, calib, jcal, qj, qt)
    bar = 1e-2 if quant else 1e-5
    for f in dataclasses.fields(hj):
        a, b = getattr(ht, f.name), getattr(hj, f.name)
        assert a.dtype == torch.float64 and tuple(a.shape) == b.shape
        if f.name == "h_attn_out":          # not captured: wo takes RTN
            assert not a.any() and not b.any()
            continue
        assert np.abs(a.numpy() - b).max() <= bar * np.abs(b).max(), f.name


def test_quantize_weights_gptq_on_jax_hessians_matches_jax(setup):
    pj, _, calib, jcal = setup
    qj = JQM(enabled=True, act_cfg=jmx.MXConfig(), t3_block=0)
    hj = jg.capture_hessians(pj, JCFG, jcal, qj)
    ht = tg.HessianStats(*(torch.from_numpy(getattr(hj, f.name))
                           for f in dataclasses.fields(hj)))
    for fmt in ("mxfp4", "nvfp4"):
        cj, ct = _cfgs(fmt)
        outj = _np(jg.quantize_weights_gptq(pj, JCFG, hj, cj))
        outt = tg.quantize_weights_gptq(
            convert.params_from_numpy(_np(pj), "cpu"), TCFG, ht, ct)
        for k, v in outj["blocks"].items():
            np.testing.assert_array_equal(outt["blocks"][k].numpy(), v,
                                          err_msg=f"{fmt} {k}")


def _same_params(jtree, ttree, path=""):
    assert set(jtree) == set(ttree), path
    for k, v in jtree.items():
        if isinstance(v, dict):
            _same_params(v, ttree[k], path + k + "/")
            continue
        t = ttree[k].detach().numpy()
        assert t.shape == v.shape and t.dtype == v.dtype, path + k
        if k in tg.WEIGHT_KEYS:
            assert (t != v).mean() <= TIE_SHARE, (path + k, (t != v).mean())
        else:
            assert np.abs(t - v).max() <= 1e-5 * max(np.abs(v).max(), 1e-30), \
                path + k


@pytest.mark.parametrize("method", ("fp", "rtn", "gptq", "quarot",
                                    "quarot-rtn", "block_hadamard"))
def test_fixed_methods_match_jax(setup, method):
    """The methods that learn nothing: the quantized params, the quant
    mode and the transform set equal the JAX package's (bars above)."""
    pj, pt, calib, jcal = setup
    rj = jptq.apply_method(method, pj, JCFG, jcal, steps=2)
    rt = tptq.apply_method(method, pt, TCFG, calib, steps=2)
    _same_params(_np(rj.params), rt.params)
    for f in ("enabled", "t3_block", "quantize_head", "backend"):
        assert getattr(rt.qm, f) == getattr(rj.qm, f)
    assert rt.history == rj.history == []
    assert (rt.tset is None) == (rj.tset is None)
    if rj.tset is not None:
        np.testing.assert_array_equal(rt.tset.a1.numpy(),
                                      np.asarray(rj.tset.a1))
    if method != "fp":
        ev = jsyn.make_source(JCFG, 4, 32, 0).batch(50)["inputs"]
        np.testing.assert_allclose(
            tptq.eval_ppl(rt, TCFG, ev),
            jptq.eval_ppl(rj, JCFG, jnp.asarray(ev)), rtol=1e-2)


def test_method_names_match_jax():
    assert tptq.METHODS == jptq.METHODS
    with pytest.raises(ValueError):
        tptq.apply_method("no-such-method", {}, TCFG, [])
