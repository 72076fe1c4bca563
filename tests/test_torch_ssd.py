"""Mamba2 SSD (Mamba2-130M's reduced config: 3 layers, d_model 96, 12
heads of 16, state 16, chunk 16) in the port against the JAX package, on
the CPU.

Weights are the JAX package's init carried across with
``convert.params_from_numpy``; inputs are numpy-seeded. Bars:
  * ``ssd_chunked`` (output and final state) within 1e-5 of max |y|, at a
    length of whole chunks, a ragged even length and an odd one (one token
    per chunk: the chunk rule ``while l % q: q //= 2``), from zero and from
    a given state;
  * ``causal_conv1d``, ``conv1d_step`` and ``rms_norm_gated`` within 1e-6;
  * forward, prefill and decode against the JAX package's: atol 2e-4,
    rtol 2e-3 (``tests/test_archs_smoke.py``'s bars), at an odd prompt
    length too;
  * ``lm_loss`` within 1e-4 relative and every gradient leaf within 1e-4
    of its max |g|;
  * the identity fold within 5e-4 and the JAX fold within 1e-5;
  * RTN mxfp4, fused (the plain versions here) and reference backends,
    logits within 1e-2 of max |logit| of the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import folding as jfold
from repro.core import gptq as jgptq
from repro.core import mx as jmx
from repro.core.quantize import QuantMode as JQM
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import ssd as jssd
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.artifacts.store import pack_params
from repro_torch.core import folding as tfold
from repro_torch.core import mx as tmx
from repro_torch.core import ptq as tptq
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import ssd as tssd

torch.set_num_threads(1)

NAME = "mamba2-130m"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    jc, tc = jconfigs.get_reduced(NAME), tconfigs.get_reduced(NAME)
    jp = jax.jit(japi.init, static_argnums=1)(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, convert.params_from_numpy(_np(jp), "cpu")


def _toks(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("L,init", [(64, False), (40, True), (37, False)],
                         ids=["whole-chunks", "ragged-from-state", "odd"])
def test_ssd_chunked_matches_jax(L, init):
    rng = np.random.default_rng(L)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, L, h, p)).astype(np.float32)
    dA = -rng.uniform(0.01, 0.5, (b, L, h)).astype(np.float32)
    B = rng.standard_normal((b, L, h, n)).astype(np.float32)
    C = rng.standard_normal((b, L, h, n)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, n)).astype(np.float32) if init
          else None)
    assert tssd.chunk_len(L, 16) == {64: 16, 40: 8, 37: 1}[L]
    wy, ws = jssd.ssd_chunked(*map(jnp.asarray, (x, dA, B, C)), 16,
                              None if s0 is None else jnp.asarray(s0))
    gy, gs = tssd.ssd_chunked(*map(torch.from_numpy, (x, dA, B, C)), 16,
                              None if s0 is None else torch.from_numpy(s0))
    for g, w in ((gy, wy), (gs, ws)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_conv_and_gated_norm_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    st = rng.standard_normal((2, 24, 3)).astype(np.float32)
    want = np.asarray(jlayers.causal_conv1d(*map(jnp.asarray, (x, w, bias))))
    got = tlayers.causal_conv1d(*map(torch.from_numpy, (x, w, bias)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    wy, ws = jlayers.conv1d_step(*map(jnp.asarray, (st, x[:, 0], w, bias)))
    gy, gs = tlayers.conv1d_step(*map(torch.from_numpy,
                                      (st, x[:, 0], w, bias)))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=1e-6)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    z = rng.standard_normal((2, 9, 24)).astype(np.float32)
    gam = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    want = np.asarray(jlayers.rms_norm_gated(*map(jnp.asarray, (x, z, gam))))
    got = tlayers.rms_norm_gated(*map(torch.from_numpy, (x, z, gam)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_forward_matches_jax(pair):
    jc, tc, jp, tp = pair
    toks = _toks(jc, 2, 48)
    want = np.asarray(jax.jit(japi.forward, static_argnums=1)(
        jp, jc, jnp.asarray(toks)))
    with torch.no_grad():
        got = tapi.forward(tp, tc, torch.from_numpy(toks)).numpy()
    assert got.shape == (2, 48, tc.vocab_size)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("S", [32, 21], ids=["chunked", "odd"])
def test_prefill_then_decode_match_jax(pair, S):
    """Prefill S tokens, then 4 decode steps, each against the JAX
    package's decode on its own cache and against the forward."""
    jc, tc, jp, tp = pair
    toks = _toks(jc, 2, S + 4, seed=S)
    full = np.asarray(jax.jit(japi.forward, static_argnums=1)(
        jp, jc, jnp.asarray(toks)))
    jl, jcache = japi.prefill(jp, jc, jnp.asarray(toks[:, :S]), max_len=64)
    with torch.no_grad():
        tl, tcache = tapi.prefill(tp, tc, torch.from_numpy(toks[:, :S]),
                                  max_len=64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(tl.numpy(), full[:, S - 1], atol=2e-4,
                               rtol=2e-3)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=2e-4,
                                   rtol=2e-3, err_msg=key)
    jdec = jax.jit(japi.decode, static_argnums=1)
    for t in range(S, S + 3):
        jl, jcache = jdec(jp, jc, jcache, jnp.asarray(toks[:, t]),
                          jnp.int32(t))
        with torch.no_grad():
            tl, tcache = tapi.decode(tp, tc, tcache,
                                     torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                                   rtol=2e-3, err_msg=f"step {t}")
        np.testing.assert_allclose(tl.numpy(), full[:, t], atol=2e-4,
                                   rtol=2e-3, err_msg=f"step {t}")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def test_lm_loss_and_grads_match_jax(pair):
    jc, tc, jp, tp = pair
    b = jsyn.make_source(jc, 2, 32, 0).batch(0)
    loss_j, g_j = jax.jit(jax.value_and_grad(japi.lm_loss),
                          static_argnums=1)(
        jp, jc, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = [(k, t.clone().requires_grad_(True)) for k, t in _leaves(tp)]
    it = iter(dict(leaves).values())

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return next(it)
    loss_t = tapi.lm_loss(rebuild(tp), tc, {k: torch.as_tensor(v).long()
                                            for k, v in b.items()})
    grads = torch.autograd.grad(loss_t, [t for _, t in leaves])
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    gj = dict(_leaves(_np(g_j)))
    assert sorted(gj) == [k for k, _ in leaves]
    for (k, _), g in zip(leaves, grads):
        scale = float(np.abs(gj[k]).max())
        np.testing.assert_allclose(g.numpy(), gj[k], rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)


def test_identity_fold_keeps_the_function_and_matches_jax(pair):
    jc, tc, jp, tp = pair
    toks = _toks(jc, 2, 16)
    with torch.no_grad():
        ref = tapi.forward(tp, tc, torch.from_numpy(toks)).numpy()
        ts = tfold.identity_set(tc.d_model, tc.n_layers, 16, t3_block=32)
        tf = tapi.fold(tapi.fold_norms(tp, tc), tc, ts)
        out = tapi.forward(tf, tc, torch.from_numpy(toks),
                           TQM.off(t3=32)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    js = jfold.identity_set(jc.d_model, jc.n_layers, 16, t3_block=32)
    jf = japi.fold(japi.fold_norms(jp, jc), jc, js)
    for (kt, t), (kj, j) in zip(_leaves(tf), _leaves(_np(jf))):
        assert kt == kj
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5, err_msg=kt)


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_rtn_logits_match_jax(pair, backend):
    """RTN mxfp4 (the JAX package's weights): ``in_proj``'s N = 2·192 +
    2·16 + 12 = 428 is no multiple of 16, as Mamba2-130M's 3352 is not."""
    jc, tc, jp, _ = pair
    mx = jmx.MXConfig(fmt="mxfp4", block_size=32)
    jq = jax.jit(jgptq.quantize_weights_rtn, static_argnums=(1, 2))(jp, jc,
                                                                   mx)
    jqm = JQM(enabled=True, act_cfg=mx)
    toks = _toks(jc, 2, 32, seed=5)
    want = np.asarray(jax.jit(japi.forward, static_argnums=(1, 3))(
        jq, jc, jnp.asarray(toks), jqm))
    tq = convert.params_from_numpy(_np(jq), "cpu")
    tqm = TQM(enabled=True, act_cfg=tmx.MXConfig(fmt="mxfp4", block_size=32),
              backend=backend)
    tree = (pack_params(tptq.PTQResult(tq, tqm, None, [], "rtn"))
            if backend == "fused" else tq)
    assert tq["blocks"]["in_proj"].shape[-1] == 428
    with torch.no_grad():
        got = tapi.forward(tree, tc, torch.from_numpy(toks), tqm).numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_affine_fold_matches_jax(pair):
    """A random affine T1 carried across with ``convert.tset_from_numpy``
    (T2 does not apply: no value path): every folded leaf within 1e-5 of
    the JAX package's, the folded forward within 2e-4."""
    jc, tc, jp, tp = pair
    rng = np.random.default_rng(3)
    d, hd, L = jc.d_model, 16, jc.n_layers
    ts = dict(a1=np.eye(d, dtype=np.float32)
              + 0.05 * rng.standard_normal((d, d)).astype(np.float32),
              v1=0.05 * rng.standard_normal(d).astype(np.float32),
              a2=np.tile(np.eye(hd, dtype=np.float32), (L, 1, 1)),
              v2=np.zeros((L, hd), np.float32), t3_block=32)
    js = jfold.TransformSet(**{k: (jnp.asarray(v) if k != "t3_block" else v)
                               for k, v in ts.items()})
    jf = japi.fold(japi.fold_norms(jp, jc), jc, js)
    with torch.no_grad():
        tf = tapi.fold(tapi.fold_norms(tp, tc), tc,
                       convert.tset_from_numpy(ts, "cpu"))
    for (kt, t), (kj, j) in zip(_leaves(tf), _leaves(_np(jf))):
        assert kt == kj
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(j).max()),
                                   err_msg=kt)
    toks = _toks(jc, 2, 24)
    want = np.asarray(japi.forward(jf, jc, jnp.asarray(toks)))
    with torch.no_grad():
        got = tapi.forward(tf, tc, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
