"""The rest of the transformer zoo in the port against the JAX package, on
the CPU: DeepSeek-67B's reduced config (dense, 8 query heads over one KV
head: G = 8), HuBERT-XLarge's (encoder, non-causal, stub frame embeddings)
and InternVL2-26B's (vlm, stub patch embeddings, no token table).

Weights are the JAX package's init (``PRNGKey(0)``) carried across with
``convert.params_from_numpy``; batches are the numpy-seeded synthetic
source both packages share. Bars:
  * logits of ``api.forward`` within 1e-5 absolute (max |logit| ~ 4);
  * ``lm_loss`` within 1e-5 relative, each gradient leaf within 1e-5 of
    its max |g| (f32 sums in another order);
  * prefill then decode against forward: the JAX test's 2e-4 (both
    packages), and with the mxfp8 packed KV under ``QuantMode(backend=
    "fused")`` — the plain versions here — the decode reads the cache's
    round trip, so 2e-2 of max |logit|, as
    ``tests/test_torch_model.py``'s packed-cache parity;
  * the stub-frontend fold preserves the function within 1e-4 of max
    |logit| and matches the JAX fold within 1e-5;
  * ``apply_method('rtn' | 'latmix-lu')`` for vlm and encoder: the port's
    artifact bytes equal the JAX package's packing of the same result —
    for the learned method, stages 2-3 on one affine transform set (stage
    1 of two packages parts by up to the learning rate after its first
    Adam update, as ``test_torch_ptq.py`` records) — with at most a few
    codes apart at the MX ties of ROADMAP Queue 3.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import ptq as jptq
from repro.core.quantize import KVCacheQuant as JKVQ
from repro.core.quantize import QuantMode as JQM
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.serving.engine import Engine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import gptq as tgptq
from repro_torch.core import ptq as tptq
from repro_torch.core.quantize import KVCacheQuant as TKVQ
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.models import api as tapi
from repro_torch.serving.engine import Engine as TEngine

torch.set_num_threads(1)

ZOO = ["deepseek-67b", "hubert-xlarge", "internvl2-26b"]


def _pair(name, seed=0):
    jc, tc = jconfigs.get_reduced(name), tconfigs.get_reduced(name)
    jp = japi.init(jax.random.PRNGKey(seed), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _batch(cfg, B=2, S=32, seed=0):
    return jsyn.make_source(cfg, B, S, seed).batch(0)


def _t(b):
    return {k: (torch.as_tensor(v).float() if v.dtype.kind == "f"
                else torch.as_tensor(v).long()) for k, v in b.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("name", ZOO)
def test_forward_loss_and_grads_match_jax(name):
    """The port's counterpart of ``test_archs_smoke.py::
    test_forward_and_grad_step`` for the new families: forward, loss and
    every gradient leaf against the JAX package's."""
    jc, tc, jp, tp = _pair(name)
    b = _batch(jc)
    lj = np.asarray(jax.jit(japi.forward, static_argnums=1)(
        jp, jc, jnp.asarray(b["inputs"])))
    lt = tapi.forward(tp, tc, _t(b)["inputs"]).detach().numpy()
    assert lt.shape == (2, 32, tc.vocab_size)
    np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)

    loss_j, g_j = jax.jit(jax.value_and_grad(japi.lm_loss),
                          static_argnums=1)(
        jp, jc, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = [(k, t.clone().requires_grad_(True)) for k, t in _leaves(tp)]
    it = iter(dict(leaves).values())

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return next(it)
    loss_t = tapi.lm_loss(rebuild(tp), tc, _t(b))
    grads = torch.autograd.grad(loss_t, [t for _, t in leaves])
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    gj = dict(_leaves(jax.tree.map(np.asarray, g_j)))
    assert sorted(gj) == [k for k, _ in leaves]
    for (k, _), g in zip(leaves, grads):
        scale = float(np.abs(gj[k]).max())
        np.testing.assert_allclose(g.numpy(), gj[k], rtol=0,
                                   atol=1e-5 * scale + 1e-12, err_msg=k)


@pytest.mark.parametrize("name,packed", [
    ("deepseek-67b", False), ("internvl2-26b", False),
    ("internvl2-26b", True)], ids=["dense", "vlm", "vlm-mxfp8"])
def test_prefill_then_decode_equals_forward(name, packed):
    """``test_prefill_decode_consistency`` in the port: prefill 16 inputs,
    decode one more, each against the forward of the whole sequence — and
    the JAX package's decode logits on the same cache. The packed cache
    needs kv_dim % 32 == 0: DeepSeek's reduced config has one KV head of
    16, so the mxfp8 case is the vlm's (2 KV heads of 16)."""
    jc, tc, jp, tp = _pair(name, seed=1)
    b = _batch(jc, B=2, S=17, seed=0)["inputs"]
    inputs, nxt = b[:, :16], b[:, 16]
    qm = TQM.off().with_backend("fused") if packed else TQM.off()
    kvq = TKVQ.parse("mxfp8") if packed else None
    ti = _t({"x": inputs})["x"]
    tn = _t({"x": nxt})["x"]
    with torch.no_grad():
        full = tapi.forward(tp, tc, _t({"x": b})["x"])
        last, cache = tapi.prefill(tp, tc, ti, qm, max_len=32, kv_quant=kvq)
        lg, _ = tapi.decode(tp, tc, cache, tn, 16, qm)
    tol = 2e-2 * float(full.abs().max()) if packed else 2e-4
    np.testing.assert_allclose(last.numpy(), full[:, 15].numpy(), atol=tol,
                               rtol=0 if packed else 2e-3)
    np.testing.assert_allclose(lg.numpy(), full[:, 16].numpy(), atol=tol,
                               rtol=0 if packed else 2e-4)
    jkv = JKVQ.parse("mxfp8") if packed else None
    _, jcache = japi.prefill(jp, jc, jnp.asarray(inputs), max_len=32,
                             kv_quant=jkv)
    jlg, _ = japi.decode(jp, jc, jcache, jnp.asarray(nxt), jnp.int32(16))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=0)


def test_encoder_has_no_prefill_or_decode_in_either_package():
    jc, tc, jp, tp = _pair("hubert-xlarge")
    x = _batch(jc, B=1, S=8)["inputs"]
    for api_, p, c, xi in ((japi, jp, jc, jnp.asarray(x)),
                           (tapi, tp, tc, torch.as_tensor(x))):
        with pytest.raises(ValueError, match="no decode/prefill step"):
            api_.prefill(p, c, xi)
        with pytest.raises(ValueError, match="no decode step"):
            api_.decode(p, c, None, xi[:, 0], 0)


def test_engines_refuse_encoder_and_vlm():
    """Both engines refuse an encoder; a vlm is refused on the continuous
    paths by both, and by the port on the wave path too, where the JAX
    engine builds and then fails on its first request (token prompts do
    not unpack as embeddings)."""
    from repro.serving.engine import Request as JRequest
    for name, msg in (("hubert-xlarge", "not served autoregressively"),):
        jc, tc, jp, tp = _pair(name)
        with pytest.raises(ValueError, match=msg):
            JEngine(jp, jc, JQM.off())
        with pytest.raises(ValueError, match=msg):
            TEngine(tp, tc, TQM.off(), device="cpu")
    jc, tc, jp, tp = _pair("internvl2-26b")
    for kw in (dict(scheduler="continuous"),
               dict(scheduler="continuous", kv_layout="paged")):
        with pytest.raises(ValueError):
            JEngine(jp, jc, JQM.off(), **kw)
        with pytest.raises(ValueError):
            TEngine(tp, tc, TQM.off(), device="cpu", **kw)
    with pytest.raises(ValueError, match="token prompts"):
        TEngine(tp, tc, TQM.off(), device="cpu")
    eng = JEngine(jp, jc, JQM.off(), batch_size=1, max_len=64)
    with pytest.raises(ValueError, match="not enough values to unpack"):
        eng.generate([JRequest(prompt=np.arange(8, dtype=np.int32),
                               max_new=2)])


def _random_tset(cfg, seed, orthogonal=False):
    """An invertible T1 / T2 set with biases (numpy), the shapes a learned
    LATMiX set has; ``orthogonal``: T1 a rotation without bias, so the
    fold commutes with the RMSNorms and preserves the function."""
    rng = np.random.default_rng(seed)
    d, dh, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    a1 = np.eye(d) + 0.1 * rng.standard_normal((d, d)) / np.sqrt(d)
    if orthogonal:
        a1 = np.linalg.qr(rng.standard_normal((d, d)))[0]
    a2 = np.eye(dh)[None] + 0.1 * rng.standard_normal((L, dh, dh)) / np.sqrt(dh)
    return dict(a1=a1.astype(np.float32),
                v1=(0.0 if orthogonal else 0.05)
                * rng.standard_normal(d).astype(np.float32),
                a2=a2.astype(np.float32),
                v2=(0.05 * rng.standard_normal((L, dh))).astype(np.float32),
                t3_block=0)


@pytest.mark.parametrize("name", ["internvl2-26b", "hubert-xlarge"])
def test_stub_frontend_fold_preserves_function_and_matches_jax(name):
    """Under a rotation T1 (and any invertible T2 with bias: the value path
    is exact) the folded model, T1 applied to the stub embeddings as
    ``input_transform``, computes the unfolded one's logits; under a
    general affine set the folded leaves equal the JAX fold's."""
    from repro.core.folding import TransformSet as JTS
    jc, tc, jp, tp = _pair(name)
    x = _batch(jc, B=2, S=16)["inputs"]
    with torch.no_grad():
        pn = tapi.fold_norms(tp, tc)
        rot = convert.tset_from_numpy(_random_tset(tc, 3, True), "cpu")
        ref = tapi.forward(tp, tc, torch.as_tensor(x))
        got = tapi.forward(tapi.fold(pn, tc, rot), tc, torch.as_tensor(x))
        ts = _random_tset(tc, 3)
        folded = tapi.fold(pn, tc, convert.tset_from_numpy(ts, "cpu"))
    assert set(folded["input_transform"]) == {"a", "v"}
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4 * scale,
                               rtol=0)
    jts = JTS(**{k: (jnp.asarray(v) if k != "t3_block" else v)
                 for k, v in ts.items()})
    jf = japi.fold(japi.fold_norms(jp, jc), jc, jts)
    for k, v in _leaves(jax.tree.map(np.asarray, jf)):
        tv = dict(_leaves(folded))[k]
        np.testing.assert_allclose(tv.numpy(), v, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(v).max()),
                                   err_msg=k)


def _npz(path):
    out = {}
    for f in ("weights.npz", "aux.npz"):
        with np.load(path / f) as z:
            out.update({f"{f}:{k}": z[k] for k in z.files})
    return out


def _jax_packed(jparams, fmt="mxfp4"):
    """The JAX package's artifact arrays of a fake-quantized tree, keyed as
    in ``_npz``: its own ``pack_weight`` (jitted) for every weight key, the
    raw leaves as they are."""
    from repro.artifacts.store import _flatten, _is_quantized_key
    from repro.kernels import packing as jpacking
    pack = jax.jit(lambda w: {k: v for k, v in
                              jpacking.pack_weight(w, fmt).items()
                              if k in ("codes_packed", "scales_e8m0")})
    out = {}
    for k, v in _flatten(jax.tree.map(np.asarray, jparams)).items():
        if _is_quantized_key(k, v):
            b = pack(jnp.asarray(v))
            out[f"weights.npz:{k}.codes"] = np.asarray(b["codes_packed"])
            out[f"weights.npz:{k}.scales"] = np.asarray(b["scales_e8m0"])
        else:
            out[f"aux.npz:{k}"] = v
    return out


@pytest.mark.parametrize("name", ["internvl2-26b", "hubert-xlarge"])
@pytest.mark.parametrize("method", ["rtn", "latmix-lu"])
def test_apply_method_artifact_bytes_match_jax(name, method, tmp_path):
    """RTN weights for the non-dense families (GPTQ is dense-only in both
    packages), T1 left as ``input_transform``: the port's exported artifact
    holds the bytes the JAX package packs for the same result, and loads
    back. ``rtn`` runs ``apply_method`` in both packages. For ``latmix-lu``
    the port's ``apply_method`` runs (one step of stage 1 on the stub
    embeddings, then the fold and RTN), and stages 2-3 are held against
    the JAX package's on one transform set (an affine T1, T2 with biases:
    stage 1 of two packages parts by up to the learning rate after its
    first Adam update). At most a few codes may part, at the MX
    ties of ROADMAP Queue 3."""
    from repro.core import gptq as jgptq
    from repro.core.folding import TransformSet as JTS
    from repro_torch.artifacts import load_artifact
    jc, tc, jp, tp = _pair(name)
    src = jsyn.make_source(jc, 2, 32, 0)
    calib = [src.batch(i) for i in range(2)]
    mxcfg = tptq._mx_cfg("mxfp4")
    jmx = jptq._mx_cfg("mxfp4")
    if method == "rtn":
        tres = tptq.apply_method(method, tp, tc, calib)
        jq = jax.jit(lambda p: jptq.apply_method("rtn", p, jc, []).params)(
            jp)
    else:
        res = tptq.apply_method(method, tp, tc, calib, steps=1)
        assert set(res.params["input_transform"]) == {"a", "v"}
        assert np.isfinite(res.history[0]["loss"])
        ts = _random_tset(tc, 4)
        tset = convert.tset_from_numpy(ts, "cpu")
        with torch.no_grad():
            folded = tapi.fold(tapi.fold_norms(tp, tc), tc, tset)
        tres = tptq.PTQResult(tgptq.quantize_weights_rtn(folded, tc, mxcfg),
                              res.qm, tset, [], method)
        jts = JTS(**{k: (jnp.asarray(v) if k != "t3_block" else v)
                     for k, v in ts.items()})
        jq = jax.jit(lambda p: jgptq.quantize_weights_rtn(
            japi.fold(japi.fold_norms(p, jc), jc, jts), jc, jmx))(jp)
    tres.export(tc, tmp_path / "port")
    a, b = _npz(tmp_path / "port"), _jax_packed(jq)
    assert sorted(a) == sorted(b)
    apart = 0
    for k in a:
        if k.startswith("weights.npz:"):
            apart += int((a[k] != b[k]).sum())
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    assert apart <= 4, apart
    tparams, tcfg, _ = load_artifact(tmp_path / "port", device="cpu")
    assert tcfg.family == tc.family
    if method != "rtn":
        assert set(tparams["input_transform"]) == {"a", "v"}
        np.testing.assert_array_equal(tparams["input_transform"]["a"],
                                      ts["a1"])
