"""The paper's experiments in the port (``repro_torch.paper``) against the
JAX package's (``benchmarks/``), on the CPU, on the trained bench model:
the model, Fig. 2, Table 3 and the runner (``test_torch_paper_tables.py``
holds Tables 1, 2 and 8).

The JAX side is called below each ``run()`` (its ``emit`` writes JSON into
``experiments/benchmarks/``): the same inputs, made with numpy seeds and
the bench checkpoint, go through both packages. Bars, and why:

- ``get_model``'s parameters (the checkpoint with the outlier fold) and
  the captured activations: 1e-6 of each tensor's max |value|;
- Fig. 2's fixed-transform MSEs at B = 8, 16, 32, 64 and the B = 32
  per-block profiles: 1e-4 relative (MX snaps of f32 products taken in
  another order);
- ``learn_affine_mse`` at 25 steps (5 would never reach its first
  best-iterate check, at step 25, and return its init): the returned A
  within 2 × lr × steps of each other and E(T) within 2e-2 relative —
  ``tests/test_torch_latmix.py``'s bars after the first Adam update;
- Table 3 at steps 0 and 1: perplexity within 1e-3 relative;
- ``run --only fig2 --fast`` prints the JAX runner's row names, and its
  JSON lands in its own directory, never under ``experiments/benchmarks``.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from _torch_paper_helpers import (ROOT, at_root, data, leaves,  # noqa: F401
                                  models, rel)

from benchmarks import common as jcommon
from benchmarks import fig2_mse as jfig2
from repro.core import latmix as jlx
from repro.core import mx as jmx
from repro.core import transforms as jtfm
from repro.core.quantize import QuantMode as JQM
from repro.models import api as japi
from repro_torch import convert
from repro_torch.models import api as tapi
from repro_torch.paper import common, fig2_mse, run as prun
from repro_torch.paper import table3_invariance

torch.set_num_threads(1)


def test_get_model_and_activations_equal_jax(models):
    jp, tp, cfg, tcfg = models
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = dict(leaves(tp))
    for name, w in leaves(want):
        assert rel(got[name], w) <= 1e-6, name
    batches = common.eval_batches(tcfg, n=2)
    jx = jfig2.capture_activations(jp, cfg, jcommon.eval_batches(cfg, n=2))
    x = fig2_mse.capture_activations(tp, tcfg, batches)
    assert x.shape == jx.shape
    assert rel(x, jx) <= 1e-6


@pytest.fixture(scope="module")
def acts(models):
    jp, tp, cfg, tcfg = models
    return (jfig2.capture_activations(jp, cfg, jcommon.eval_batches(cfg, n=2)),
            fig2_mse.capture_activations(tp, tcfg,
                                         common.eval_batches(tcfg, n=2)))


def _jax_fixed(x, kind, B, seed):
    spec = jtfm.TransformSpec(kind=kind, d=x.shape[-1], block=B)
    return jtfm.materialize(jtfm.init_params(jax.random.PRNGKey(seed), spec),
                            spec)


@functools.partial(jax.jit, static_argnums=3)
def _jax_profile(x, a, v, mxcfg):
    back = jtfm.backward(jmx.quantize(jtfm.forward(x, a, v), mxcfg,
                                      ste=False), jtfm.inverse(a), v)
    return jmx.blockwise_error(x, back, mxcfg.block_size)


def test_fig2_fixed_transforms_equal_jax(acts):
    jx, x = acts
    mse = jax.jit(jtfm.transform_mse, static_argnums=3)
    for B in (8, 16, 32, 64):
        got = fig2_mse.fixed_mse(x, B)
        mxcfg = jmx.MXConfig(fmt="mxfp4", block_size=B)
        for kind in fig2_mse.FIXED:
            want = float(mse(jx, *_jax_fixed(jx, kind, B, 1), mxcfg))
            assert abs(got[kind] - want) <= 1e-4 * want, (B, kind)
    mxcfg = jmx.MXConfig(fmt="mxfp4", block_size=32)
    prof = fig2_mse.fixed_profiles(x, 32)
    for kind in fig2_mse.FIXED:
        want = _jax_profile(jx, *_jax_fixed(jx, kind, 32, 2), mxcfg)
        assert rel(prof[kind], want) <= 1e-4, kind


def test_learn_affine_mse_within_the_latmix_bars(acts):
    jx, x = acts
    steps, lr = 25, 1e-3
    ja, jv = jfig2.learn_affine_mse(jx, 32, steps=steps, lr=lr)
    a, v = fig2_mse.learn_affine_mse(x, 32, steps=steps, lr=lr)
    assert float((a - torch.as_tensor(np.array(ja))).abs().max()) \
        <= 2 * lr * steps
    want = float(jtfm.transform_mse(jx, ja, jv, jmx.MXConfig("mxfp4", 32)))
    assert abs(fig2_mse.mse(x, 32, a, v) - want) <= 2e-2 * want


@pytest.mark.parametrize("steps", [0, 1])
def test_table3_equals_jax(models, data, steps):
    jp, tp, cfg, tcfg = models
    got = table3_invariance.fused_ppl(tapi.fold_norms(tp, tcfg), tcfg,
                                      data["calib"], data["ev"], steps)
    jpn = japi.fold_norms(jp, cfg)
    lx = jlx.LatmixConfig(kind="lu", steps=max(steps, 1),
                          lr=1e-3 if steps else 0.0)
    if steps == 0:
        tset = jlx.materialize_set(
            jlx.init_omega(jax.random.PRNGKey(0), cfg, lx), cfg, lx)
    else:
        _, tset, _ = jlx.learn_transforms(jpn, cfg, lx, data["jcalib"])
    want = japi.perplexity(japi.fold(jpn, cfg, tset), cfg, data["jev"],
                           JQM.off(t3=32))
    assert abs(got - want) <= 1e-3 * want


def test_run_fig2_prints_the_jax_row_names(tmp_path, capsys, monkeypatch):
    """The runner end to end, its learner cut to 25 steps (the rows'
    names and files do not depend on it)."""
    monkeypatch.setattr(common, "OUT_DIR", common.OUT_DIR)   # run sets it
    monkeypatch.setattr(fig2_mse, "learn_affine_mse", functools.partial(
        fig2_mse.learn_affine_mse, steps=25))
    before = sorted(p.name for p in (ROOT / "experiments" / "benchmarks")
                    .iterdir())
    with at_root():
        prun.main(["--only", "fig2", "--fast", "--device", "cpu",
                   "--out", str(tmp_path / "rows")])
    names = [line.split(",")[0] for line in
             capsys.readouterr().out.splitlines()[1:]]
    assert names == ["fig2a_mse_B8", "fig2a_mse_B16", "fig2a_mse_B32",
                     "fig2a_mse_B64", "fig2c_blockwise"]
    assert (tmp_path / "rows" / "fig2_mse.json").exists()
    assert sorted(p.name for p in (ROOT / "experiments" / "benchmarks")
                  .iterdir()) == before
