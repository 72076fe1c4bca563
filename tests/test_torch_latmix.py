"""The port's LATMiX stage against the JAX package's, on the CPU, on the
2-layer config of tests/test_ptq_pipeline.py: the calibration batches,
Ω's initialization, the norm and transform folds, the losses, the AdamW
update and ``learn_transforms`` itself.

Bars, and why:
- batches, ``fold_norms``, Ω's fixed leaves: equal;
- Ω's learned leaves at init: 1e-5 (the normal draw's last ulps);
- the folded tree: 1e-5 of each leaf's max |value| (f32 products in
  another order); folded FP logits: 1e-4 of max |logit| from the
  unfolded ones under an orthogonal T1/T2 without bias, where the fold is
  exact; under a learned set the RMSNorm does not commute with T1, so the
  fold moves the logits in both packages, and the port's folded logits
  are held within 1e-4 of max |logit| of the JAX package's;
- losses: 1e-6 relative; AdamW: 1e-6 after 1 and 3 steps;
- the task gradient at a carried-over Ω: 1e-4 (LU) and 5e-3 (QR, where
  ``matrix_exp`` and ``expm`` part by 3e-6) of each leaf's max |g|, except
  T2's bias v2: the folds cancel it exactly, so its gradient is rounding
  noise (below 1e-7 in both packages);
- ``learn_transforms`` from a carried-over Ω: the first loss within 1e-4
  relative. Adam turns v2's noise gradient into steps of the learning
  rate, and those move MX codes in the next forward, so after the first
  update the two runs part like two runs of the reference on inputs an
  ulp apart: later losses within 2e-2 relative, the final Ω within
  2 × lr × steps (an element whose gradient is near zero may step the
  other way), and after one LU step every leaf but v2 within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArch
from repro.core import latmix as jlx
from repro.core.quantize import QuantMode as JQM
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.training import optimizer as jopt
from repro_torch import convert
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import latmix as tlx
from repro_torch.core import prng
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.data import synthetic as tsyn
from repro_torch.models import api as tapi
from repro_torch.training import optimizer as topt

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

SMALL = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=128, attn_chunk=64)
JCFG, TCFG = JArch(**SMALL), TArch(**SMALL)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    pj = japi.init(jax.random.PRNGKey(0), JCFG)
    pt = convert.params_from_numpy(_np(pj), "cpu")
    src = jsyn.make_source(JCFG, 4, 32, 0)
    calib = [src.batch(i) for i in range(2)]
    jcal = [{k: jnp.asarray(v) for k, v in b.items()} for b in calib]
    return pj, pt, calib, jcal


@pytest.mark.parametrize("vocab,seed,step", ((128, 0, 0), (512, 3, 17),
                                             (151936, 0, 2)))
def test_synthetic_batches_equal_jax(vocab, seed, step):
    jdc = jsyn.DataConfig(vocab_size=vocab, seq_len=64, batch_size=8,
                          seed=seed)
    tdc = tsyn.DataConfig(vocab_size=vocab, seq_len=64, batch_size=8,
                          seed=seed)
    jb, tb = jsyn.SyntheticLM(jdc).batch(step), tsyn.SyntheticLM(tdc).batch(
        step)
    for k in ("inputs", "labels"):
        assert jb[k].dtype == tb[k].dtype
        np.testing.assert_array_equal(jb[k], tb[k])
    assert tsyn.unigram_ppl(tdc) == jsyn.unigram_ppl(jdc)


@pytest.mark.parametrize("kind,gran", (("lu", "full"), ("qr", "full"),
                                       ("lu", "block"), ("orth_scale",
                                                         "full")))
def test_init_omega_matches_jax(kind, gran):
    jl = jlx.LatmixConfig(kind=kind, granularity=gran)
    tl = tlx.LatmixConfig(kind=kind, granularity=gran)
    oj = _np(jlx.init_omega(jax.random.PRNGKey(0), JCFG, jl))
    ot = tlx.init_omega(prng.prng_key(0), TCFG, tl)
    assert set(oj) == set(ot) == {"t1", "t2"}
    for t in oj:
        for part in ("learn", "fixed"):
            assert set(oj[t][part]) == set(ot[t][part])
            for k, v in oj[t][part].items():
                got = ot[t][part][k].numpy()
                assert got.shape == v.shape and got.dtype == v.dtype
                if part == "fixed":
                    np.testing.assert_array_equal(got, v, err_msg=k)
                else:
                    np.testing.assert_allclose(got, v, atol=1e-5,
                                               err_msg=k)


def _carried_set(kind):
    jl, tl = jlx.LatmixConfig(kind=kind), tlx.LatmixConfig(kind=kind)
    oj = jlx.init_omega(jax.random.PRNGKey(0), JCFG, jl)
    ot = convert.params_from_numpy(_np(oj), "cpu")
    return (jlx.materialize_set(oj, JCFG, jl),
            tlx.materialize_set(ot, TCFG, tl))


def _tree_close(jtree, ttree, bar):
    assert set(jtree) == set(ttree)
    for k, v in jtree.items():
        if isinstance(v, dict):
            _tree_close(v, ttree[k], bar)
        else:
            assert _rel(ttree[k].numpy(), v) <= bar, k


@pytest.mark.parametrize("kind", ("lu", "hadamard"))
def test_fold_norms_and_fold_match_jax(setup, kind):
    pj, pt, calib, _ = setup
    pnj, pnt = japi.fold_norms(pj, JCFG), tapi.fold_norms(pt, TCFG)
    for k, v in _np(pnj)["blocks"].items():
        np.testing.assert_array_equal(pnt["blocks"][k].numpy(), v)
    np.testing.assert_array_equal(pnt["head"].numpy(), np.asarray(pnj["head"]))
    tsj, tst = _carried_set(kind)
    fj, ft = japi.fold(pnj, JCFG, tsj), tapi.fold(pnt, TCFG, tst)
    _tree_close(_np(fj), ft, 1e-5)
    x = calib[0]["inputs"]
    lj = np.asarray(japi.forward(pnj, JCFG, jnp.asarray(x)))
    lfj = np.asarray(japi.forward(fj, JCFG, jnp.asarray(x), JQM.off(32)))
    lt = tapi.forward(pnt, TCFG, _t(x)).numpy()
    lft = tapi.forward(ft, TCFG, _t(x), TQM.off(32)).numpy()
    np.testing.assert_allclose(lt, lj, atol=1e-4 * np.abs(lj).max())
    np.testing.assert_allclose(lft, lfj, atol=1e-4 * np.abs(lfj).max())
    if kind == "hadamard":     # orthogonal, no bias: the fold is exact
        np.testing.assert_allclose(lft, lt, atol=1e-4 * np.abs(lt).max())


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    lo = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    te = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    lab = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    J = jnp.asarray
    np.testing.assert_allclose(
        float(tapi.cross_entropy(_t(lo), _t(lab))),
        float(japi.cross_entropy(J(lo), J(lab))), rtol=1e-6)
    np.testing.assert_allclose(
        float(tapi.cross_entropy(_t(lo), _t(lab), _t(mask))),
        float(japi.cross_entropy(J(lo), J(lab), J(mask))), rtol=1e-6)
    for temp in (1.0, 1.5):
        np.testing.assert_allclose(
            float(tapi.kl_divergence(_t(te), _t(lo), temp)),
            float(japi.kl_divergence(J(te), J(lo), temp)), rtol=1e-5)


def test_lm_loss_and_perplexity_match_jax(setup):
    pj, pt, calib, _ = setup
    b = calib[0]
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: _t(v) for k, v in b.items()}
    np.testing.assert_allclose(float(tapi.lm_loss(pt, TCFG, bt)),
                               float(japi.lm_loss(pj, JCFG, bj)), rtol=1e-5)
    np.testing.assert_allclose(
        tapi.perplexity(pt, TCFG, _t(b["inputs"])),
        japi.perplexity(pj, JCFG, jnp.asarray(b["inputs"])), rtol=1e-5)


@pytest.mark.parametrize("clip", (1.0, 100.0))
def test_adamw_matches_jax(clip):
    """1 and 3 steps over a tree of 2-D and 1-D leaves: the clip (active
    at 1.0), the bias correction, the warmup and cosine, decay on 2-D
    leaves only."""
    rng = np.random.default_rng(1)
    params = {"a": {"W": rng.standard_normal((5, 4)).astype(np.float32),
                    "v": rng.standard_normal(4).astype(np.float32)},
              "b": rng.standard_normal((3, 2, 2)).astype(np.float32)}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params) for _ in range(3)]
    jc = jopt.AdamWConfig(lr=1e-2, weight_decay=0.1, warmup_steps=2,
                          total_steps=5, grad_clip=clip)
    tc = topt.AdamWConfig(lr=1e-2, weight_decay=0.1, warmup_steps=2,
                          total_steps=5, grad_clip=clip)
    jp, js = jax.tree.map(jnp.asarray, params), None
    tp = topt.tree_map(_t, params)
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for i, g in enumerate(grads):
        jp, js, jinfo = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                           js, jc)
        tp, ts, tinfo = topt.apply_updates(tp, topt.tree_map(_t, g), ts, tc)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tinfo["lr"], float(jinfo["lr"]),
                                   rtol=1e-6)
        if i in (0, 2):
            for a, b in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=0, atol=1e-6)
    for s in (0, 1, 4, 9):
        np.testing.assert_allclose(topt.schedule_lr(tc, s), float(
            jopt.schedule_lr(jc, jnp.asarray(s))), rtol=1e-6)


@pytest.mark.parametrize("kind,bar", (("lu", 1e-4), ("qr", 5e-3)))
def test_task_gradient_matches_jax(setup, kind, bar):
    """d KL / dΩ at a carried-over Ω, through fold and the STE quantizer."""
    pj, pt, calib, jcal = setup
    jl, tl = jlx.LatmixConfig(kind=kind), tlx.LatmixConfig(kind=kind)
    pnj, pnt = japi.fold_norms(pj, JCFG), tapi.fold_norms(pt, TCFG)
    oj = jlx.init_omega(jax.random.PRNGKey(0), JCFG, jl)
    fixed_j = {k: v["fixed"] for k, v in oj.items()}
    x = jcal[0]["inputs"]
    teacher = japi.forward(pnj, JCFG, x)

    def jloss(learn):
        om = {k: {"learn": learn[k], "fixed": fixed_j[k]} for k in learn}
        f = japi.fold(pnj, JCFG, jlx.materialize_set(om, JCFG, jl))
        return japi.kl_divergence(
            teacher, japi.forward(f, JCFG, x, jlx.student_qm(jl)),
            jl.temperature)

    gj = jax.grad(jloss)({k: v["learn"] for k, v in oj.items()})
    ot = convert.params_from_numpy(_np(oj), "cpu")
    learn = topt.tree_map(lambda a: a.requires_grad_(True),
                          {k: v["learn"] for k, v in ot.items()})
    om = {k: {"learn": learn[k], "fixed": ot[k]["fixed"]} for k in learn}
    f = tapi.fold(pnt, TCFG, tlx.materialize_set(om, TCFG, tl))
    xt = _t(calib[0]["inputs"])
    loss = tapi.kl_divergence(tapi.forward(pnt, TCFG, xt),
                              tapi.forward(f, TCFG, xt, tlx.student_qm(tl)),
                              tl.temperature)
    gt = tlx._grads(loss, learn)
    for t in gt:
        for k, g in gt[t].items():
            a, b = g.numpy(), np.asarray(gj[t][k])
            if t == "t2" and k == "v":     # cancelled exactly by the folds
                assert np.abs(a).max() < 1e-7 and np.abs(b).max() < 1e-7
            else:
                assert _rel(a, b) <= bar, (t, k, _rel(a, b))


@pytest.mark.parametrize("steps", (1, 3))
@pytest.mark.parametrize("kind", ("lu", "qr"))
def test_learn_transforms_matches_jax(setup, monkeypatch, kind, steps):
    pj, pt, calib, jcal = setup
    jl = jlx.LatmixConfig(kind=kind, steps=steps)
    tl = tlx.LatmixConfig(kind=kind, steps=steps)
    pnj, pnt = japi.fold_norms(pj, JCFG), tapi.fold_norms(pt, TCFG)
    o0 = _np(jlx.init_omega(jax.random.PRNGKey(jl.seed), JCFG, jl))
    oj, tsj, hj = jlx.learn_transforms(pnj, JCFG, jl, jcal)
    monkeypatch.setattr(tlx, "init_omega", lambda key, cfg, lx:
                        convert.params_from_numpy(o0, "cpu"))
    ot, tst, ht = tlx.learn_transforms(pnt, TCFG, tl, calib)
    assert [h["step"] for h in ht] == [h["step"] for h in hj]
    np.testing.assert_allclose(ht[0]["loss"], hj[0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(ht[0]["task"], hj[0]["task"], rtol=1e-4)
    for a, b in zip(ht[1:], hj[1:]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-2)
    for t in oj:
        for k, v in _np(oj[t]["learn"]).items():
            d = np.abs(ot[t]["learn"][k].numpy() - v).max()
            assert d <= 2 * jl.lr * steps, (t, k, d)
            if steps == 1 and kind == "lu" and not (t == "t2" and k == "v"):
                assert d <= 1e-6, (t, k, d)
    np.testing.assert_allclose(tst.a1.numpy(), np.asarray(tsj.a1),
                               atol=jl.lr * steps * 4)
    mj = jlx.transform_metrics(oj, JCFG, jl)
    mt = tlx.transform_metrics(ot, TCFG, tl)
    assert mt.keys() == mj.keys()
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=5e-2)


def test_fixed_kind_is_not_trained(setup):
    """A fixed kind (QuaRot's Hadamard) returns its init set and no
    history, as the JAX package does."""
    pj, pt, calib, jcal = setup
    jl = jlx.LatmixConfig(kind="hadamard", learn_bias=False, steps=5)
    tl = tlx.LatmixConfig(kind="hadamard", learn_bias=False, steps=5)
    _, tsj, hj = jlx.learn_transforms(japi.fold_norms(pj, JCFG), JCFG, jl,
                                      jcal)
    _, tst, ht = tlx.learn_transforms(tapi.fold_norms(pt, TCFG), TCFG, tl,
                                      calib)
    assert hj == ht == []
    np.testing.assert_array_equal(tst.a1.numpy(), np.asarray(tsj.a1))
    np.testing.assert_array_equal(tst.a2.numpy(), np.asarray(tsj.a2))
