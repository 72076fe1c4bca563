"""Training in the port against the JAX package, on the CPU.

``launch.steps.make_train_step`` runs three AdamW steps from the JAX
package's init (``PRNGKey(0)``, carried across with ``convert``) on the
synthetic batches both packages share, with ``accum`` 1 and 2, against the
JAX package's jitted step. Bars:
  * losses within 1e-5 relative at every step;
  * parameters: AdamW's normalised step m / (sqrt(v) + eps) turns a
    gradient that is rounding noise in both packages (|g| ~ 1e-9, its sign
    not fixed by the arithmetic) into a step of a full learning rate, as
    in stage 1 of LATMiX (``test_torch_latmix.py``). So each leaf is held
    within 3·lr of
    the JAX package's (three steps of at most lr each, plus weight decay),
    and the mean absolute difference over all parameters within 1e-3·lr —
    a bar that a port whose updates were wrong almost everywhere would not
    meet;
  * accumulation over 2 microbatches against the whole batch: the JAX
    test's bars (loss within 1e-4, parameters within 2e-4 + 2e-3 rel).
The custom-VJP cross-entropy is held against autograd of its formula, and
the remat forward (``cfg.remat``, per-block ``torch.utils.checkpoint``)
against the plain one, gradients bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ArchConfig as JArch
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.training import optimizer as jopt
from repro_torch import convert
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.training import optimizer as topt

torch.set_num_threads(1)

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, attn_chunk=64)
LR = 1e-3


def _ocfg(opt):
    return opt.AdamWConfig(lr=LR, warmup_steps=2, total_steps=10)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _batches(cfg, n, B=4, S=32):
    src = jsyn.make_source(cfg, B, S, 0)
    return [src.batch(i) for i in range(n)]


def _tb(b):
    return {k: torch.as_tensor(v).long() for k, v in b.items()}


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_jax(accum):
    jc, tc = JArch(**TINY), TArch(**TINY)
    jp = japi.init(jax.random.PRNGKey(0), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    jstep = jax.jit(jsteps.make_train_step(jc, _ocfg(jopt), accum=accum))
    tstep = tsteps.make_train_step(tc, _ocfg(topt), accum=accum)
    for b in _batches(jc, 3):
        jp, js, jl, _ = jstep(jp, js, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        tp, ts, tl, _ = tstep(tp, ts, _tb(b))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert ts.step == int(js.step) == 3
    tot = n = 0.0
    for k, v in _leaves(jax.tree.map(np.asarray, jp)):
        d = np.abs(dict(_leaves(tp))[k].numpy() - v)
        assert d.max() <= 3 * LR, (k, d.max())
        tot, n = tot + d.sum(), n + d.size
    assert tot / n <= 1e-3 * LR, tot / n


def test_grad_accum_equals_the_big_batch():
    """``test_grad_accum_equivalence`` in the port."""
    tc = TArch(**TINY)
    tp = tapi.init(torch.Generator().manual_seed(0), tc, device="cpu")
    state = topt.init_state(tp)
    b = _tb(_batches(JArch(**TINY), 1, B=8)[0])
    p1, _, l1, _ = tsteps.make_train_step(tc, _ocfg(topt), accum=1)(
        tp, state, b)
    p4, _, l4, _ = tsteps.make_train_step(tc, _ocfg(topt), accum=4)(
        tp, state, b)
    assert abs(float(l1) - float(l4)) < 1e-4
    for (k, a), (_, c) in zip(_leaves(p1), _leaves(p4)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-4,
                                   rtol=2e-3, err_msg=k)


def test_cross_entropy_vjp_against_autograd():
    """The custom-VJP mean CE: value and gradient against autograd of
    logsumexp - gold (within 1e-6 of max |g|), bf16 logits included."""
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        logits = (torch.randn((3, 7, 50), generator=g) * 3).to(dtype)
        labels = torch.randint(0, 50, (3, 7), generator=g)
        a = logits.clone().requires_grad_(True)
        ce = tapi.cross_entropy(a, labels)
        (ga,) = torch.autograd.grad(ce, a)
        b = logits.clone().requires_grad_(True)
        lf = b.float()
        ref = (torch.logsumexp(lf, -1)
               - lf.gather(-1, labels[..., None])[..., 0]).mean()
        (gb,) = torch.autograd.grad(ref, b)
        assert ga.dtype == dtype
        assert abs(float(ce) - float(ref)) <= 1e-6 * abs(float(ref))
        scale = float(gb.float().abs().max())
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        np.testing.assert_allclose(ga.float().numpy(), gb.float().numpy(),
                                   atol=tol * scale, rtol=0)


def test_remat_forward_gives_the_plain_gradients():
    tc = TArch(**TINY)
    tr = dataclasses.replace(tc, remat=True)
    tp = tapi.init(torch.Generator().manual_seed(1), tc, device="cpu")
    b = _tb(_batches(JArch(**TINY), 1)[0])
    out = []
    for cfg in (tc, tr):
        out.append(tsteps._value_and_grad(tp, cfg, b, TQM.off()))
    assert float(out[0][0]) == float(out[1][0])
    for (k, a), (_, c) in zip(_leaves(out[0][1]), _leaves(out[1][1])):
        assert torch.equal(a, c), k


def test_a_jax_optimizer_state_resumes_in_the_port():
    """``convert.opt_state_from_numpy``: the JAX package's params and AdamW
    state after its first step, carried across, take the second step in
    the port to the JAX package's second loss (1e-5 relative) and
    parameters (within 2·lr, the bar of the three-step test)."""
    jc, tc = JArch(**TINY), TArch(**TINY)
    jp = japi.init(jax.random.PRNGKey(0), jc)
    js = jopt.init_state(jp)
    jstep = jax.jit(jsteps.make_train_step(jc, _ocfg(jopt)))
    b0, b1 = _batches(jc, 2)
    jp, js, _, _ = jstep(jp, js, {k: jnp.asarray(v) for k, v in b0.items()})
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts.step == 1
    jp, js, jl, _ = jstep(jp, js, {k: jnp.asarray(v) for k, v in b1.items()})
    tp, ts, tl, _ = tsteps.make_train_step(tc, _ocfg(topt))(tp, ts, _tb(b1))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k, v in _leaves(jax.tree.map(np.asarray, jp)):
        assert np.abs(dict(_leaves(tp))[k].numpy() - v).max() <= 2 * LR, k
