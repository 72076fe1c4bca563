"""Griffin (RecurrentGemma-2B's reduced config: one super-block of (rec,
rec, attn) and two trailing recurrent layers, MQA of 4 heads over one KV
head of 32, window 32) in the port against the JAX package, on the CPU,
and the layers it brought: GeGLU's GELU, the flash attention of training
and prefill, the associative scan.

Weights are the JAX package's init carried across with
``convert.params_from_numpy``; inputs are numpy-seeded. Bars:
  * ``gated_mlp(act="gelu")`` within 1e-6 of max |y| (the tanh form, as
    ``jax.nn.gelu``; the exact erf form parts by ~1e-4);
  * ``flash_attention`` forward within 1e-6, its (dq, dk, dv) against
    ``jax.grad`` within 1e-5 of each max |g|, windowed and causal over 3
    KV chunks;
  * ``associative_scan`` within 1e-6 relative (the same association tree
    as ``jax.lax.associative_scan``; an FMA on either side moves an ulp);
  * forward, prefill and decode against the JAX package's: atol 2e-4,
    rtol 2e-3 (``tests/test_archs_smoke.py``'s bars), a prompt longer than
    the window so the ring wraps, and decode steps past the wrap;
  * ``lm_loss`` within 1e-4 relative and every gradient leaf within 1e-4
    of its max |g| (remat on and off);
  * the identity fold within 5e-4 (``test_transforms_folding.py``);
  * RTN mxfp4 with T3, fused (the plain versions here) and reference
    backends, logits within 1e-2 of max |logit| of the JAX package's, also
    prefill then decode over the mxfp8 ring;
  * ``latmix-lu``'s first loss from the JAX package's Ω within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import folding as jfold
from repro.core import gptq as jgptq
from repro.core import latmix as jlx
from repro.core import mx as jmx
from repro.core.quantize import KVCacheQuant as JKVQ
from repro.core.quantize import QuantMode as JQM
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.artifacts.store import pack_params
from repro_torch.core import folding as tfold
from repro_torch.core import latmix as tlx
from repro_torch.core import mx as tmx
from repro_torch.core import ptq as tptq
from repro_torch.core.quantize import KVCacheQuant as TKVQ
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.data import synthetic as tsyn
from repro_torch.models import api as tapi
from repro_torch.models import griffin as tgriffin
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

NAME = "recurrentgemma-2b"


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


def test_gated_mlp_gelu_is_jax_tanh_form():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    wg, wu = (rng.standard_normal((64, 96)).astype(np.float32) * 0.4
              for _ in range(2))
    wd = rng.standard_normal((96, 64)).astype(np.float32) * 0.1
    want = np.asarray(jlayers.gated_mlp(
        *map(jnp.asarray, (x, wg, wu, wd)), JQM.off(), act="gelu"))
    got = tlayers.gated_mlp(*map(torch.from_numpy, (x, wg, wu, wd)),
                            TQM.off(), act="gelu").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _fa_inputs(seed=0, B=2, S=48, H=4, K=2, Dh=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, Dh), (B, S, K, Dh), (B, S, K, Dh),
                           (B, S, H, Dh)))


FA = dict(causal=True, window=20, chunk=16)   # 3 KV chunks of 16


def test_flash_attention_forward_matches_jax():
    q, k, v, _ = _fa_inputs()
    want = np.asarray(jlayers.flash_attention(
        *map(jnp.asarray, (q, k, v)), **FA))
    got = tlayers.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  **FA).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the same function as the online-softmax attention of decode
    dense = tlayers.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                              q_pos=torch.arange(48), window=20, chunk=16)
    np.testing.assert_allclose(got, dense.numpy(), rtol=0, atol=1e-6)


def test_flash_attention_grads_match_jax():
    q, k, v, g = _fa_inputs(seed=1)

    def jloss(q, k, v):
        return jnp.sum(jlayers.flash_attention(q, k, v, **FA) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (tlayers.flash_attention(*ts, **FA) * torch.from_numpy(g)).sum().backward()
    for t, w, n in zip(ts, want, "qkv"):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)


@pytest.mark.parametrize("S", [1, 37, 64])
def test_associative_scan_matches_jax(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 24)).astype(np.float32)
    b = rng.standard_normal((2, S, 24)).astype(np.float32)

    def op(e1, e2):
        return e1[0] * e2[0], e1[1] * e2[0] + e2[1]

    wa, wb = jax.lax.associative_scan(op, (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    ga, gb = tgriffin.associative_scan(torch.from_numpy(a),
                                       torch.from_numpy(b))
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(wb)).max())


def test_forward_matches_jax(pair):
    jc, tc, jp, tp = pair
    toks = _toks(jc, 2, 48)
    want = np.asarray(jax.jit(japi.forward, static_argnums=1)(
        jp, jc, jnp.asarray(toks)))
    with torch.no_grad():
        got = tapi.forward(tp, tc, torch.from_numpy(toks)).numpy()
    assert got.shape == (2, 48, tc.vocab_size)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("S", [16, 40], ids=["within-window", "wrapped"])
def test_prefill_then_decode_match_jax(pair, S):
    """Prefill S tokens into a 64-slot request (a ring of window = 32
    slots), then 6 decode steps; at S = 40 the prefill ring-packs the last
    32 keys and every step writes past the wrap. Each step against the JAX
    package's decode on its own cache and against the forward."""
    jc, tc, jp, tp = pair
    toks = _toks(jc, 2, S + 6, seed=S)
    full = np.asarray(japi.forward(jp, jc, jnp.asarray(toks)))
    jl, jcache = japi.prefill(jp, jc, jnp.asarray(toks[:, :S]), max_len=64)
    with torch.no_grad():
        tl, tcache = tapi.prefill(tp, tc, torch.from_numpy(toks[:, :S]),
                                  max_len=64)
    assert tcache["attn_k"].shape == (1, 2, 32, tc.kv_dim)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(tl.numpy(), full[:, S - 1], atol=2e-4,
                               rtol=2e-3)
    for key in ("attn_k", "rec_h", "rec_conv", "tail_h", "tail_conv"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=2e-4,
                                   rtol=2e-3, err_msg=key)
    jdec = jax.jit(japi.decode, static_argnums=1)
    for t in range(S, S + 5):
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


def _loss_and_grads(tp, tc, batch):
    leaves = [(k, t.clone().requires_grad_(True)) for k, t in _leaves(tp)]
    it = iter(dict(leaves).values())

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return next(it)
    loss = tapi.lm_loss(rebuild(tp), tc, batch)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return loss, dict(zip([k for k, _ in leaves], grads))


@pytest.fixture(scope="module")
def jax_grads(pair):
    jc, _, jp, _ = pair
    b = jsyn.make_source(jc, 2, 40, 0).batch(0)
    loss, g = jax.jit(jax.value_and_grad(japi.lm_loss), static_argnums=1)(
        jp, jc, {k: jnp.asarray(v) for k, v in b.items()})
    return b, float(loss), dict(_leaves(_np(g)))


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_match_jax(pair, jax_grads, remat):
    _, tc, _, tp = pair
    b, loss_j, gj = jax_grads
    tc = dataclasses.replace(tc, remat=remat)
    loss_t, g_t = _loss_and_grads(
        tp, tc, {k: torch.as_tensor(v).long() for k, v in b.items()})
    assert abs(loss_t.item() - loss_j) <= 1e-4 * abs(loss_j)
    assert sorted(gj) == sorted(g_t)
    for k, g in g_t.items():
        scale = float(np.abs(gj[k]).max())
        np.testing.assert_allclose(g.numpy(), gj[k], rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)


def test_identity_fold_keeps_the_function_and_matches_jax(pair):
    jc, tc, jp, tp = pair
    toks = _toks(jc, 2, 16)
    with torch.no_grad():
        ref = tapi.forward(tp, tc, torch.from_numpy(toks)).numpy()
        ts = tfold.identity_set(tc.d_model, tc.n_super_blocks, tc.head_dim,
                                t3_block=32)
        tf = tapi.fold(tapi.fold_norms(tp, tc), tc, ts)
        out = tapi.forward(tf, tc, torch.from_numpy(toks),
                           TQM.off(t3=32)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    js = jfold.identity_set(jc.d_model, jc.n_super_blocks, jc.head_dim,
                            t3_block=32)
    jf = japi.fold(japi.fold_norms(jp, jc), jc, js)
    for (kt, t), (kj, j) in zip(_leaves(tf), _leaves(_np(jf))):
        assert kt == kj
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5, err_msg=kt)


@pytest.fixture(scope="module")
def rtn(pair):
    """RTN mxfp4 weights (the JAX package's) with T3 before ffn_down: the
    port's dense copy, its packed serving tree and quant mode, and the JAX
    package's logits of a forward, of a prefill past the window into the
    mxfp8 ring and of the decode step after it."""
    jc, tc, jp, _ = pair
    mx = jmx.MXConfig(fmt="mxfp4", block_size=32)
    jq = jax.jit(jgptq.quantize_weights_rtn, static_argnums=(1, 2))(jp, jc,
                                                                   mx)
    jqm = JQM(enabled=True, act_cfg=mx, t3_block=32)
    toks = _toks(jc, 2, 40, seed=5)
    fwd = jax.jit(japi.forward, static_argnums=(1, 3))(
        jq, jc, jnp.asarray(toks), jqm)
    jl, jcache = japi.prefill(jq, jc, jnp.asarray(toks[:, :36]), jqm,
                              max_len=64, kv_quant=JKVQ("mxfp8"))
    jd, _ = japi.decode(jq, jc, jcache, jnp.asarray(toks[:, 36]),
                        jnp.int32(36), jqm)
    tq = convert.params_from_numpy(_np(jq), "cpu")
    tqm = TQM(enabled=True, act_cfg=tmx.MXConfig(fmt="mxfp4", block_size=32),
              t3_block=32)
    packed = pack_params(tptq.PTQResult(tq, tqm, None, [], "rtn"))
    return toks, [np.asarray(a) for a in (fwd, jl, jd)], tq, packed, tqm


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_rtn_t3_logits_match_jax(pair, rtn, backend):
    _, tc, _, _ = pair
    toks, want, tq, packed, tqm = rtn
    tree, qm = (packed if backend == "fused" else tq), tqm.with_backend(
        backend)
    with torch.no_grad():
        fwd = tapi.forward(tree, tc, torch.from_numpy(toks), qm)
        tl, tcache = tapi.prefill(tree, tc, torch.from_numpy(toks[:, :36]),
                                  qm, max_len=64, kv_quant=TKVQ("mxfp8"))
        td, _ = tapi.decode(tree, tc, tcache, torch.from_numpy(toks[:, 36]),
                            36, qm)
    for g, w in zip((fwd, tl, td), want):
        assert np.abs(g.numpy() - w).max() <= 1e-2 * np.abs(w).max()


def test_latmix_lu_first_loss_matches_jax(pair, monkeypatch):
    """``learn_transforms`` (kind lu: T1 and the T2 of the one attention
    layer) from the JAX package's initial Ω: its first loss and task loss
    against the JAX package's stage-1 loss at that Ω (the KL of the folded
    fake-quant student to the teacher, plus the regularizer) within 1e-4
    relative."""
    jc, tc, jp, tp = pair
    jl = jlx.LatmixConfig(kind="lu", steps=1)
    tl = tlx.LatmixConfig(kind="lu", steps=1)
    b = jsyn.make_source(jc, 1, 16, 0).batch(0)
    o0 = jlx.init_omega(jax.random.PRNGKey(jl.seed), jc, jl)
    assert {a.shape[0] for a in jax.tree.leaves(o0["t2"])} == {
        jc.n_super_blocks}

    @jax.jit
    def stage1(o0, pn, x):
        student = japi.forward(japi.fold(pn, jc, jlx.materialize_set(
            o0, jc, jl)), jc, x, jlx.student_qm(jl))
        task = japi.kl_divergence(japi.forward(pn, jc, x), student,
                                  jl.temperature)
        return task, task + jlx.reg_loss(o0, jc, jl)

    task, loss = map(float, stage1(o0, japi.fold_norms(jp, jc),
                                   jnp.asarray(b["inputs"])))
    monkeypatch.setattr(tlx, "init_omega", lambda key, cfg, lx:
                        convert.params_from_numpy(_np(o0), "cpu"))
    _, tset, ht = tlx.learn_transforms(tapi.fold_norms(tp, tc), tc, tl,
                                       [tsyn.make_source(tc, 1, 16, 0)
                                        .batch(0)])
    assert tset.a2.shape == (tc.n_super_blocks, tc.head_dim, tc.head_dim)
    np.testing.assert_allclose(ht[0]["loss"], loss, rtol=1e-4)
    np.testing.assert_allclose(ht[0]["task"], task, rtol=1e-4)


def _affine_set(jc, n_t2, seed=3):
    """A random affine T1 (d_model) and per-layer T2 (head_dim, stacked
    over ``n_t2`` layers) near the identity, as numpy arrays."""
    rng = np.random.default_rng(seed)
    d, hd = jc.d_model, jc.head_dim
    return dict(
        a1=np.eye(d, dtype=np.float32)
        + 0.05 * rng.standard_normal((d, d)).astype(np.float32),
        v1=0.05 * rng.standard_normal(d).astype(np.float32),
        a2=np.eye(hd, dtype=np.float32)
        + 0.05 * rng.standard_normal((n_t2, hd, hd)).astype(np.float32),
        v2=0.05 * rng.standard_normal((n_t2, hd)).astype(np.float32),
        t3_block=32)


def test_affine_fold_matches_jax(pair):
    """An affine set (T2 stacked over the super-blocks) carried across with
    ``convert.tset_from_numpy``: every folded leaf within 1e-5 of the JAX
    package's, the folded forward (T3 online) within 2e-4."""
    jc, tc, jp, tp = pair
    ts = _affine_set(jc, jc.n_super_blocks)
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
    want = np.asarray(japi.forward(jf, jc, jnp.asarray(toks), JQM.off(t3=32)))
    with torch.no_grad():
        got = tapi.forward(tf, tc, torch.from_numpy(toks),
                           TQM.off(t3=32)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
