"""The port's transform parameterizations, folds, straight-through MX
quantizer and ``jax.random`` draws against the JAX package's, on the CPU.

Bars: the keys, bits, uniforms and rademacher signs equal ``jax.random``'s
bitwise; a normal draw parts from jax's by at most 4 float32 ulps (XLA's
``erf_inv`` polynomial, whose ``log1p`` may part in the last bit). An
initial matrix built from those draws keeps every fixed leaf (``perm``,
``sign``) and puts the learned ones within 1e-5. From an ω carried over
from the JAX package, A and v are within 2e-5 (the LU's f32 products;
``matrix_exp`` against ``jax.scipy.linalg.expm``, two approximations of
exp); the folds within 1e-5 of max |value|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import folding as jfl
from repro.core import mx as jmx
from repro.core import transforms as jtf
from repro_torch import convert
from repro_torch.core import folding as tfl
from repro_torch.core import mx as tmx
from repro_torch.core import prng
from repro_torch.core import transforms as ttf

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

KINDS = ["lu", "qr", "orthogonal", "invertible", "hadamard",
         "block_hadamard", "kron", "identity", "orth_scale"]
CASES = [(k, g) for k in KINDS for g in ("full", "block")
         if g == "full" or k in ttf._BLOCKABLE]
ULP_BAR = 4


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b).max()


@pytest.mark.parametrize("seed", (0, 1, 12345, 2 ** 32 - 1))
def test_prng_draws_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    js = np.asarray(jax.random.split(jk, 7)).astype(np.int64)
    ts = prng.split(tk, 7)
    np.testing.assert_array_equal(js[:, 0], [k[0].item() for k in ts])
    np.testing.assert_array_equal(js[:, 1], [k[1].item() for k in ts])
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (5, 9))).astype(np.int64),
        prng.random_bits(tk, (5, 9)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.rademacher(jk, (333,), jnp.float32)),
        prng.rademacher(tk, (333,)).numpy())
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (64,), minval=lo, maxval=1.0)
                   ).view(np.int32),
        prng.uniform(tk, (64,), lo, 1.0).numpy().view(np.int32))
    jn = np.asarray(jax.random.normal(jk, (48, 40)))
    assert _ulps(jn, prng.normal(tk, (48, 40)).numpy()) <= ULP_BAR


def _specs(kind, gran, d=64, block=32):
    kw = dict(kind=kind, d=d, block=block, granularity=gran)
    return jtf.TransformSpec(**kw), ttf.TransformSpec(**kw)


def _same_tree(jtree, ttree, atol):
    assert set(jtree) == set(ttree)
    for k, v in jtree.items():
        if isinstance(v, dict):
            _same_tree(v, ttree[k], atol)
            continue
        t = ttree[k].detach().numpy()
        assert t.dtype == v.dtype and t.shape == v.shape, k
        if v.dtype.kind in "iu" or k == "sign":
            np.testing.assert_array_equal(t, v, err_msg=k)
        else:
            np.testing.assert_allclose(t, v, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("kind,gran", CASES)
def test_init_params_match_jax(kind, gran):
    """init_params from the same key: fixed leaves equal, learned leaves
    within 1e-5 (the noise of BD inits is a normal draw)."""
    sj, st = _specs(kind, gran)
    pj = _np(jtf.init_params(jax.random.PRNGKey(3), sj))
    pt = ttf.init_params(prng.prng_key(3), st)
    _same_tree(pj, pt, 1e-5)


@pytest.mark.parametrize("kind,gran", CASES)
def test_transform_functions_match_jax(kind, gran):
    """From an ω carried over: materialize, inverse, the regularizers,
    forward and backward, the quantization error of Definition 3.2 and the
    Fig. 3 metrics."""
    sj, st = _specs(kind, gran)
    pj = jtf.init_params(jax.random.PRNGKey(5), sj)
    pt = convert.params_from_numpy(_np(pj), "cpu")
    aj, vj = jtf.materialize(pj, sj)
    at, vt = ttf.materialize(pt, st)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=2e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=2e-5)
    np.testing.assert_allclose(ttf.inverse(at).numpy(),
                               np.asarray(jtf.inverse(aj)), atol=1e-4)
    np.testing.assert_allclose(float(ttf.loss_vol(pt, st)),
                               float(jtf.loss_vol(pj, sj)), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(float(ttf.diag_reg(pt)),
                               float(jtf.diag_reg(pj)), rtol=1e-5)
    x = np.random.default_rng(1).standard_normal((6, 64)).astype(np.float32)
    aj, vj = jnp.asarray(at.numpy()), jnp.asarray(vt.numpy())
    y = ttf.forward(_t(x), at, vt)
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jtf.forward(jnp.asarray(x), aj, vj)), atol=1e-5)
    back = ttf.backward(y, ttf.inverse(at), vt)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-3)
    cfg_j, cfg_t = jmx.MXConfig(), tmx.MXConfig()
    np.testing.assert_allclose(
        float(ttf.transform_mse(_t(x), at, vt, cfg_t)),
        float(jtf.transform_mse(jnp.asarray(x), aj, vj, cfg_j)), rtol=1e-4)
    np.testing.assert_allclose(float(ttf.orthogonality_deviation(at)),
                               float(jtf.orthogonality_deviation(aj)),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(ttf.offblock_norm(at, 32)),
                               float(jtf.offblock_norm(aj, 32)),
                               rtol=1e-4, atol=1e-6)


def test_kron_and_stacked_leaves_materialize_per_layer():
    """Leaves with a leading layer axis materialize layer by layer (the
    JAX package vmaps): kron, LU and block-granular QR."""
    for kind, gran in (("kron", "full"), ("lu", "full"), ("qr", "block")):
        sj, st = _specs(kind, gran, d=16, block=8)
        keys = jax.random.split(jax.random.PRNGKey(9), 3)
        per = [jtf.init_params(k, sj) for k in keys]
        if kind == "kron":        # identity at init: make it nontrivial
            per = [jax.tree.map(lambda a, i=i: a * (1.0 + 0.1 * i), p)
                   for i, p in enumerate(per)]
        stacked = ttf.stack_trees([convert.params_from_numpy(_np(p), "cpu")
                                   for p in per])
        at, vt = ttf.materialize(stacked, st)
        for i, p in enumerate(per):
            aj, vj = jtf.materialize(p, sj)
            np.testing.assert_allclose(at[i].numpy(), np.asarray(aj),
                                       atol=2e-5)
            np.testing.assert_allclose(vt[i].numpy(), np.asarray(vj),
                                       atol=2e-5)
        vol = ttf.loss_vol(stacked, st)
        np.testing.assert_allclose(
            vol.numpy(), [float(jtf.loss_vol(p, sj)) for p in per],
            rtol=1e-5, atol=1e-6)


def test_constructions_match_jax():
    k = jax.random.PRNGKey(4)
    tk = prng.prng_key(4)
    np.testing.assert_array_equal(ttf.random_hadamard(tk, 32).numpy(),
                                  np.asarray(jtf.random_hadamard(k, 32)))
    np.testing.assert_allclose(ttf.random_orthogonal(tk, 32).numpy(),
                               np.asarray(jtf.random_orthogonal(k, 32)),
                               atol=1e-5)
    for kind in ("hadamard", "orthogonal", "identity"):
        np.testing.assert_allclose(
            ttf.block_diag_init(tk, 64, 16, kind).numpy(),
            np.asarray(jtf.block_diag_init(k, 64, 16, kind)), atol=1e-5)
    blocks = np.random.default_rng(2).standard_normal((2, 3, 4, 4))
    bd = ttf.block_diagonal(_t(blocks.astype(np.float32))).numpy()
    # the port places the blocks exactly; XLA's einsum rounds them once
    np.testing.assert_allclose(
        bd, np.stack([np.asarray(jtf.block_diagonal(jnp.asarray(b)))
                      for b in blocks]), rtol=1e-6, atol=0)
    assert np.array_equal(bd[0, :4, :4], blocks[0, 0].astype(np.float32))


def test_ste_quantizer_forward_and_gradient():
    """The STE quantizer's forward is the plain quantizer's (and the JAX
    package's), its gradient the identity; without STE nothing flows.
    quantization_mse and blockwise_error equal the JAX package's."""
    x = np.random.default_rng(3).standard_normal((5, 96)).astype(np.float32)
    for cfg_j, cfg_t in ((jmx.MXConfig(), tmx.MXConfig()),
                         (jmx.NVFP4, tmx.NVFP4),
                         (jmx.MXConfig(fmt="mxint4"),
                          tmx.MXConfig(fmt="mxint4"))):
        xt = _t(x).requires_grad_(True)
        q = tmx.quantize(xt, cfg_t)
        np.testing.assert_array_equal(
            q.detach().numpy(), np.asarray(jmx.quantize(jnp.asarray(x),
                                                        cfg_j)))
        w = torch.arange(x.size, dtype=torch.float32).reshape(x.shape)
        (g,) = torch.autograd.grad((q * w).sum(), xt)
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        jg = jax.grad(lambda a: jnp.sum(jmx.quantize(a, cfg_j)
                                        * jnp.asarray(w.numpy())))(
            jnp.asarray(x))
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
        np.testing.assert_allclose(
            float(tmx.quantization_mse(_t(x), cfg_t)),
            float(jmx.quantization_mse(jnp.asarray(x), cfg_j)), rtol=1e-6)
        qn = q.detach()
        np.testing.assert_allclose(
            tmx.blockwise_error(_t(x), qn, cfg_t.block_size).numpy(),
            np.asarray(jmx.blockwise_error(jnp.asarray(x),
                                           jnp.asarray(qn.numpy()),
                                           cfg_t.block_size)), rtol=1e-6)
    xt = _t(x).requires_grad_(True)
    q = tmx.quantize(xt, tmx.MXConfig(), ste=False)
    (g,) = torch.autograd.grad(q.sum(), xt, allow_unused=True)
    jg = jax.grad(lambda a: jnp.sum(jmx.quantize(a, jmx.MXConfig(),
                                                 ste=False)))(jnp.asarray(x))
    assert not np.asarray(jg).any() and (g is None or not g.any())


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_role_folds_match_jax():
    """Each fold_* helper on stacked (layer-leading) weights."""
    rng = np.random.default_rng(6)
    L, d, n_kv, n_h, dh, f = 2, 32, 2, 4, 8, 64
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a1, v1 = np.eye(d, dtype=np.float32) + 0.1 * r(d, d), r(d)
    a2, v2 = np.eye(dh, dtype=np.float32) + 0.1 * r(L, dh, dh), r(L, dh)
    a1i = np.linalg.inv(a1).astype(np.float32)
    a2i = np.linalg.inv(a2).astype(np.float32)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    w, b = r(L, d, 48), r(L, 48)
    for jb, tb in ((None, None), (J(b), _t(b))):
        ej = jfl.fold_read(J(w), jb, J(a1i), J(v1))
        et = tfl.fold_read(_t(w), tb, _t(a1i), _t(v1))
        assert all(_rel(t.numpy(), j) < 1e-5 for t, j in zip(et, ej))
    wt, bw = r(L, 48, d), r(L, d)
    ej = jfl.fold_write(J(wt), J(bw), J(a1))
    et = tfl.fold_write(_t(wt), _t(bw), _t(a1))
    assert all(_rel(t.numpy(), j) < 1e-5 for t, j in zip(et, ej))
    e = r(50, d)
    assert _rel(tfl.fold_embed(_t(e), _t(a1), _t(v1)).numpy(),
                jfl.fold_embed(J(e), J(a1), J(v1))) < 1e-5
    wv, bv = r(L, d, n_kv * dh), r(L, n_kv * dh)
    ej = jfl.fold_value(J(wv), J(bv), J(a1i), J(v1), J(a2), J(v2), n_kv)
    et = tfl.fold_value(_t(wv), _t(bv), _t(a1i), _t(v1), _t(a2), _t(v2),
                        n_kv)
    assert all(_rel(t.numpy(), j) < 1e-5 for t, j in zip(et, ej))
    wo = r(L, n_h * dh, d)
    ej = jfl.fold_attn_out(J(wo), None, J(a1), J(a2i), J(v2), n_h)
    et = tfl.fold_attn_out(_t(wo), None, _t(a1), _t(a2i), _t(v2), n_h)
    assert all(_rel(t.numpy(), j) < 1e-5 for t, j in zip(et, ej))
    wd = r(L, f, d)
    np.testing.assert_allclose(tfl.fold_t3(_t(wd), 32).numpy(),
                               np.asarray(jfl.fold_t3(J(wd), 32)), atol=1e-5)
    g = 1.0 + 0.1 * r(L, d)
    oj, wj = jfl.fold_norm_into(J(g), J(w))
    ot, wt_ = tfl.fold_norm_into(_t(g), _t(w))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(wt_[0].numpy(), np.asarray(wj[0]))
    ij = jfl.identity_set(d, L, dh)
    it = tfl.identity_set(d, L, dh)
    for k in ("a1", "v1", "a2", "v2"):
        np.testing.assert_array_equal(getattr(it, k).numpy(),
                                      np.asarray(getattr(ij, k)))
    ct = convert.tset_from_numpy(ij, "cpu")
    assert ct.t3_block == ij.t3_block
    np.testing.assert_array_equal(ct.a2.numpy(), np.asarray(ij.a2))
