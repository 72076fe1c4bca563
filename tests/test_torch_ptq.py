"""The registry's learned methods (spinquant, ostquant, flatquant, inv,
latmix-lu, latmix-qr, and latmix-lu at block granularity) through the
port's ``apply_method`` against the JAX package's, on the CPU, on the
2-layer config of tests/test_ptq_pipeline.py at 2 steps.

Each method runs once in the JAX package, which gives its initial Ω and
its learned transform set. The port then runs the method twice:
- from the same initial Ω: the first loss within 1e-3 relative (the
  orthogonal and QR kinds' ``matrix_exp`` parts from ``expm`` by 3e-6,
  which moves a few MX codes of the student: 2.4e-4 seen) and the second
  within 2e-2 (tests/test_torch_latmix.py says why the runs part after
  the first update);
- with the JAX package's learned set in place of its own stage 1: the
  stages after it (fold, Hessian capture, GPTQ) give the JAX package's
  params, a float leaf within 1e-5 of its max |value| and a quantized
  weight equal but in at most ``TIE_SHARE`` of its elements (an f32 tie
  in the fold or the Hessian, compensated through its column by GPTQ;
  the largest share seen on this data is 9.6%)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.latmix as jlx
from repro.configs.base import ArchConfig as JArch
from repro.core import ptq as jptq
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro_torch import convert
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import gptq as tg
from repro_torch.core import latmix as tlx
from repro_torch.core import ptq as tptq

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

SMALL = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=128, attn_chunk=64)
JCFG, TCFG = JArch(**SMALL), TArch(**SMALL)
TIE_SHARE = 0.12
LEARNED = ("spinquant", "ostquant", "flatquant", "inv", "latmix-lu",
           "latmix-qr", "latmix-lu-block")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def setup():
    pj = japi.init(jax.random.PRNGKey(0), JCFG)
    src = jsyn.make_source(JCFG, 4, 32, 0)
    calib = [src.batch(i) for i in range(2)]
    return pj, calib


def _jax_run(monkeypatch, pj, calib, method):
    """The JAX package's apply_method, with its initial Ω and its stage-1
    output kept."""
    seen = {}
    init, learn = jlx.init_omega, jlx.learn_transforms

    def init_kept(*a, **k):
        seen["omega0"] = _np(init(*a, **k))
        return init(*a, **k)

    def learn_kept(*a, **k):
        seen["learned"] = learn(*a, **k)
        return seen["learned"]

    monkeypatch.setattr(jlx, "init_omega", init_kept)
    monkeypatch.setattr(jlx, "learn_transforms", learn_kept)
    jcal = [{k: jnp.asarray(v) for k, v in b.items()} for b in calib]
    res = jptq.apply_method(method, pj, JCFG, jcal, steps=2)
    monkeypatch.setattr(jlx, "init_omega", init)
    monkeypatch.setattr(jlx, "learn_transforms", learn)
    return res, seen


@pytest.mark.parametrize("method", LEARNED)
def test_learned_method_matches_jax(setup, monkeypatch, method):
    pj, calib = setup
    rj, seen = _jax_run(monkeypatch, pj, calib, method)
    pt = convert.params_from_numpy(_np(pj), "cpu")

    # the port's own stage 1 from the JAX package's initial Ω
    monkeypatch.setattr(tlx, "init_omega", lambda key, cfg, lx:
                        convert.params_from_numpy(seen["omega0"], "cpu"))
    ra = tptq.apply_method(method, pt, TCFG, calib, steps=2)
    assert [h["step"] for h in ra.history] == [h["step"] for h in rj.history]
    np.testing.assert_allclose(ra.history[0]["loss"], rj.history[0]["loss"],
                               rtol=1e-3)
    np.testing.assert_allclose(ra.history[1]["loss"], rj.history[1]["loss"],
                               rtol=2e-2)
    assert ra.qm.t3_block == rj.qm.t3_block == 32

    # the stages after it on the JAX package's learned set
    omega, tset, hist = seen["learned"]
    monkeypatch.setattr(tlx, "learn_transforms", lambda *a, **k: (
        convert.params_from_numpy(_np(omega), "cpu"),
        convert.tset_from_numpy(tset, "cpu"), hist))
    rb = tptq.apply_method(method, pt, TCFG, calib, steps=2)
    jparams = _np(rj.params)
    assert set(jparams) == set(rb.params)
    for group in ("blocks", None):
        jt = jparams["blocks"] if group else jparams
        tt = rb.params["blocks"] if group else rb.params
        for k, v in jt.items():
            if isinstance(v, dict):
                continue
            t = tt[k].numpy()
            assert t.shape == v.shape and t.dtype == v.dtype, k
            if k in tg.WEIGHT_KEYS:
                assert (t != v).mean() <= TIE_SHARE, (k, (t != v).mean())
            else:
                assert np.abs(t - v).max() <= 1e-5 * max(
                    np.abs(v).max(), 1e-30), k
