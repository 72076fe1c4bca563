"""The port's MoE family (``models/moe.py``, ``core/quantize.qeinsum``)
against the JAX package's, on the CPU, at the reduced configs of
Qwen1.5-MoE-A2.7B and Moonlight-16B-A3B (the JAX package's random weights,
carried across as numpy). The JAX side runs under ``jax.jit`` with the
config static: eager JAX compiles each operation of a scan anew, which
took seconds a call.

Bars, and why:
- ``capacity``, the router's top-k indices, capacity positions and keep
  mask, ``_parse_expert_spec``: equal;
- the top-k order among equal probabilities: jax's (the lower index first);
- ``moe_ffn`` at f32 under ``QuantMode.off()``: 1e-5 of max |y|, the two
  aux losses 1e-6 relative (f32 sums in another order);
- the combine run twice: bitwise equal;
- ``qeinsum`` fused (the plain version here) against the JAX reference
  path: 1e-4 absolute, the bar of the JAX package's own test;
- forward, prefill, chunked prefill, decode, paged prefill and decode,
  verify and verify_paged under ``QuantMode.off()`` with a dense cache:
  1e-4 of max |logit|. (With an mxfp8 cache random weights put a few of a
  prefill's K/V values an ulp from a snap midpoint, in both layouts: 3
  codes of 131072 part, and later logits by up to 2e-3 of max |logit|;
  tests/test_torch_moe_engine.py serves the mxfp8 cache on artifacts,
  under ROADMAP's MX-tie bars.)
- the identity and a random orthogonal fold keep the model: 5e-4 / 1e-3
  (the JAX package's bar, tests/test_transforms_folding.py), and the
  port's folded tree within 1e-5 of each leaf's max |value| of the JAX
  package's;
- ``latmix-lu`` for 2 steps from a carried-over Ω: the first loss within
  1e-4 relative, the second within 2e-2 (test_torch_latmix.py's bars: the
  first Adam update parts the two runs by up to the learning rate).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import folding as jfold
from repro.core import latmix as jlx
from repro.core import quantize as jq
from repro.core.quantize import QuantMode as JQM
from repro.data import synthetic as jsyn
from repro.kernels.packing import PackedWeight as JPW
from repro.models import api as japi
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import latmix as tlx
from repro_torch.core import mx as tmx
from repro_torch.core import quantize as tq
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.kernels.packing import PackedWeight as TPW
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX config, port config, JAX params, port params)."""
    jc = jconfigs.get_reduced(request.param)
    tc = tconfigs.get_reduced(request.param)
    jp = jax.jit(jmoe.init, static_argnums=(1,))(jax.random.PRNGKey(0), jc)
    return request.param, jc, tc, jp, convert.params_from_numpy(_np(jp),
                                                                "cpu")


def _jit(fn, static=(1,), names=()):
    return jax.jit(fn, static_argnums=static, static_argnames=names)


# the JAX package's model API, compiled: the config, quant mode, cache
# length and KV format static
JAPI = types.SimpleNamespace(
    prefill=_jit(japi.prefill, names=("max_len", "kv_quant")),
    **{n: _jit(getattr(japi, n)) for n in (
        "decode", "prefill_chunk", "prefill_chunk_paged", "decode_paged",
        "verify", "verify_paged")},
    init_cache=japi.init_cache, init_cache_paged=japi.init_cache_paged)
MOE_FFN = _jit(jmoe.moe_ffn, static=(2, 3))


def _layer0(jp):
    pl = {k: v[0] for k, v in jp["blocks"].items()}
    return pl, {k: torch.from_numpy(np.array(v)) for k, v in pl.items()}


def test_configs_and_module_match_jax():
    for name in ARCHS:
        for get in ("get", "get_reduced"):
            assert (dataclasses.asdict(getattr(tconfigs, get)(name))
                    == dataclasses.asdict(getattr(jconfigs, get)(name)))
        assert tapi.module_for(tconfigs.get(name)) is tmoe


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)
    for t in range(1, 700):
        assert tmoe.capacity(tc, t) == jmoe.capacity(jc, t)
        assert tmoe.capacity(jconfigs.get_reduced(arch), t) == jmoe.capacity(
            jconfigs.get_reduced(arch), t)


def _jax_routing(x, pl, cfg, C):
    """The routing lines of the JAX ``moe_ffn``: top_i, pos, keep."""
    G, Tg, _ = x.shape
    logits = jq.qlinear(x, pl["router"], None, JQM.off(),
                        "router").astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_i = jax.lax.top_k(probs, cfg.top_k)
    flat_e = top_i.reshape(G, Tg * cfg.top_k)
    oh = jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=1) - 1,
                              flat_e[..., None], axis=-1)[..., 0]
    return np.asarray(top_i), np.asarray(pos), np.asarray(pos < C)


@pytest.mark.parametrize("G,Tg", ((1, 40), (4, 17)))
def test_routing_matches_jax(model, G, Tg):
    """Top-k indices, capacity positions and the keep mask, equal — with a
    capacity small enough that some (token, slot)s are dropped."""
    _, jc, tc, jp, _ = model
    pl, tpl = _layer0(jp)
    x = np.random.default_rng(1).standard_normal(
        (G, Tg, jc.d_model)).astype(np.float32)
    C = 8
    ti, tpos, tkeep = _jax_routing(jnp.asarray(x), pl, jc, C)
    _, top_i, _, _ = tmoe.route(torch.from_numpy(x), tpl, tc, TQM.off())
    _, pos, keep = tmoe.positions(top_i, tc.n_experts, C)
    np.testing.assert_array_equal(top_i.numpy(), ti)
    np.testing.assert_array_equal(pos.numpy(), tpos.reshape(G, -1))
    np.testing.assert_array_equal(keep.numpy(), tkeep.reshape(G, -1))
    if G == 1:
        assert not tkeep.all()


def test_top_k_ties_follow_jax():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    rng = np.random.default_rng(3)
    many = rng.integers(0, 3, (64, 60)).astype(np.float32) / 4
    for p, k in ((probs, 3), (probs, 4), (many, 4), (many, 6)):
        jv, ji = jax.lax.top_k(jnp.asarray(p), k)
        tv, ti = tmoe.top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("shape", ((2, 24), (3, 1), (1, 130)))
def test_moe_ffn_matches_jax(model, shape):
    """Output, load-balance and z losses at f32 (groups of 1, 3 and 32
    tokens; the 130-token batch drops tokens at capacity)."""
    _, jc, tc, jp, _ = model
    pl, tpl = _layer0(jp)
    x = np.random.default_rng(2).standard_normal(
        (*shape, jc.d_model)).astype(np.float32)
    jy, (jl, jz) = MOE_FFN(jnp.asarray(x), pl, jc, JQM.off())
    ty, (tl, tz) = tmoe.moe_ffn(torch.from_numpy(x), tpl, tc, TQM.off())
    jy = np.asarray(jy)
    assert np.abs(ty.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tz), float(jz), rtol=1e-6)


def test_combine_is_repeatable(model):
    _, jc, tc, jp, _ = model
    _, tpl = _layer0(jp)
    x = torch.randn(4, 33, tc.d_model, generator=torch.Generator().
                    manual_seed(0))
    a, _ = tmoe.moe_ffn(x, tpl, tc, TQM.off())
    b, _ = tmoe.moe_ffn(x, tpl, tc, TQM.off())
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# qeinsum
# ---------------------------------------------------------------------------

def _packed(shape, fmt, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.3
    jw = JPW.from_dense(jnp.asarray(w), fmt)
    tw = TPW(torch.from_numpy(np.array(jw.codes_packed)),
             torch.from_numpy(np.array(jw.scales_e8m0)), fmt)
    return jw, tw


def _modes(fmt, t3):
    jm = getattr(JQM, fmt)(weights=False, t3=t3)
    tm = TQM(enabled=True, act_cfg=tmx.MXConfig(fmt=fmt, block_size=32),
             t3_block=32 if t3 else 0)
    return jm, tm


@pytest.mark.parametrize("fmt", ("mxfp4", "mxint4"))
@pytest.mark.parametrize("t3", (False, True))
@pytest.mark.parametrize("spec", ("gecd,edf->gecf", "gecf,efd->gecd",
                                  "ecd,edf->ecf"))
def test_qeinsum_matches_jax(fmt, t3, spec):
    """The port's qeinsum under both backends against the JAX reference
    path (the JAX test's shapes), and the fused decision counted."""
    role = "ffn_down" if t3 else "ffn_in"
    jw, tw = _packed((3, 64, 32), fmt, 5)
    shape = (2, 3, 4, 64) if spec.startswith("gec") else (3, 5, 64)
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    jm, tm = _modes(fmt, t3)
    want = np.asarray(jq.qeinsum(spec, jnp.asarray(x), jw,
                                 jm.with_backend("ref"), role))
    for backend in ("ref", "fused"):
        tops.reset_launches()
        got = tq.qeinsum(spec, torch.from_numpy(x), tw,
                         tm.with_backend(backend), role)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
        assert tops.quant_paths == {("qeinsum", backend, role): 1}


SPECS = ("gecd,edf->gecf", "gecf,efd->gecd", "ecd,edf->ecf",
         "ed,edf->ef", "gecd,efd->gecf", "gecd,edf->gecd", "gecd,edf->gcef",
         "ggcd,edf->ggcf", "gecd,edfx->gecf", "gecd;edf->gecf",
         "cd,edf->cf", "gecd,edf->gecfx", "bgecd,edf->bgecf")


def test_parse_expert_spec_matches_jax():
    for spec in SPECS:
        assert tq._parse_expert_spec(spec) == jq._parse_expert_spec(spec), \
            spec


def test_qeinsum_rejects_rank_mismatch_like_jax():
    """A rank-mismatched activation raises under both backends, as in the
    JAX package (tests/test_dispatch.py)."""
    jw, tw = _packed((3, 64, 32), "mxfp4", 7)
    _, tm = _modes("mxfp4", False)
    for backend in ("ref", "fused"):
        with pytest.raises(Exception):
            jq.qeinsum("gecd,edf->gecf", jnp.zeros((2, 3, 4, 7, 64)), jw,
                       JQM.mxfp4(backend=backend), "ffn_in")
        with pytest.raises(Exception):
            tq.qeinsum("gecd,edf->gecf", torch.zeros(2, 3, 4, 7, 64), tw,
                       tm.with_backend(backend), "ffn_in")


# ---------------------------------------------------------------------------
# The model: forward and the serving functions
# ---------------------------------------------------------------------------

def _close(t, j, bar=1e-4):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= bar * np.abs(j).max()


def test_forward_and_lm_loss_match_jax(model):
    _, jc, tc, jp, tp = model
    b = jsyn.make_source(jc, 2, 24, 0).batch(0)
    jl, (jlb, jz) = jax.jit(jmoe.forward, static_argnums=(1, 3, 4))(
        jp, jc, jnp.asarray(b["inputs"]), JQM.off(), True)
    tl, (tlb, tz) = tmoe.forward(tp, tc, torch.from_numpy(b["inputs"]),
                                 return_aux=True)
    _close(tl, jl)
    np.testing.assert_allclose(float(tlb), float(jlb), rtol=1e-5)
    np.testing.assert_allclose(float(tz), float(jz), rtol=1e-5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    np.testing.assert_allclose(float(tapi.lm_loss(tp, tc, tb)),
                               float(_jit(japi.lm_loss)(jp, jc, jb)),
                               rtol=1e-5)


def _contiguous_calls(api, params, cfg, kv, toks, arr, kw):
    """Full prefill + 2 decode steps; chunked prefill (2 chunks) + 1 decode
    step + a verify of 4 slots. Returns the logits of every call."""
    out = []
    C = cfg.attn_chunk
    lg, cache = api.prefill(params, cfg, arr(toks[:, :C + 9]),
                            max_len=4 * C, kv_quant=kv)
    out.append(lg)
    cur = C + 9
    for _ in range(2):
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
        lg, cache = api.decode(params, cfg, cache, arr(nxt), cur)
        out.append(lg)
        cur += 1
    cache = api.init_cache(cfg, 2, 4 * C, kv_quant=kv, **kw)
    for ci, last in ((0, C - 1), (1, 20)):
        lg, cache = api.prefill_chunk(params, cfg, cache,
                                      arr(toks[:, ci * C:(ci + 1) * C]),
                                      ci * C, last)
        out.append(lg)
    nxt = np.asarray(lg).argmax(-1).astype(np.int32)
    cl = np.array([C + 21, C + 21], np.int32)
    lg, cache = api.decode(params, cfg, cache, arr(nxt), arr(cl))
    out.append(lg)
    ver = np.stack([np.asarray(lg).argmax(-1), toks[:, 3], toks[:, 5],
                    toks[:, 7]], 1).astype(np.int32)
    lg, _ = api.verify(params, cfg, cache, arr(ver), arr(cl + 1),
                       arr(np.array([4, 2], np.int32)))
    out.append(lg)
    return [np.asarray(o) for o in out]


def _paged_calls(api, params, cfg, kv, toks, arr, kw):
    """Two paged chunk steps with per-lane starts, two decode steps, and a
    paged verify, through scattered block tables."""
    P, C = 64, cfg.attn_chunk
    cache = api.init_cache_paged(cfg, 8, P, kv_quant=kv, **kw)
    bt = arr(np.array([[5, 2, 7], [3, 6, 1]], np.int32))
    out = []
    for ci, last in ((0, [C - 1, C - 1]), (1, [10, 40])):
        lg, cache = api.prefill_chunk_paged(
            params, cfg, cache, bt, arr(toks[:, ci * C:(ci + 1) * C]),
            arr(np.array([ci * C, ci * C], np.int32)),
            arr(np.array(last, np.int32)))
        out.append(lg)
    cur = np.array([C + 11, C + 41], np.int32)
    for _ in range(2):
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
        lg, cache = api.decode_paged(params, cfg, cache, arr(nxt), arr(cur),
                                     bt)
        out.append(lg)
        cur = cur + 1
    ver = np.stack([np.asarray(lg).argmax(-1), toks[:, 2], toks[:, 4]],
                   1).astype(np.int32)
    lg, _ = api.verify_paged(params, cfg, cache, arr(ver), arr(cur),
                             arr(np.array([3, 1], np.int32)), bt)
    out.append(lg)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("calls", (_contiguous_calls, _paged_calls),
                         ids=("contiguous", "paged"))
def test_serving_functions_match_jax(model, calls):
    _, jc, tc, jp, tp = model
    toks = np.random.default_rng(4).integers(
        0, jc.vocab_size, (2, 2 * jc.attn_chunk)).astype(np.int32)
    lj = calls(JAPI, jp, jc, None, toks, jnp.asarray, {})
    lt = calls(tapi, tp, tc, None, toks, torch.from_numpy, {"device": "cpu"})
    for a, b in zip(lt, lj):
        _close(a, b)


# ---------------------------------------------------------------------------
# PTQ: the folds and the LATMiX student
# ---------------------------------------------------------------------------

def _orthogonal_set(jc, seed):
    """Random orthogonal T1 and per-layer T2 (numpy QR), no bias."""
    rng = np.random.default_rng(seed)

    def orth(n):
        return np.linalg.qr(rng.standard_normal((n, n)))[0].astype(
            np.float32)

    return jfold.TransformSet(
        a1=jnp.asarray(orth(jc.d_model)), v1=jnp.zeros(jc.d_model),
        a2=jnp.asarray(np.stack([orth(jc.head_dim)
                                 for _ in range(jc.n_layers)])),
        v2=jnp.zeros((jc.n_layers, jc.head_dim)), t3_block=32)


@pytest.mark.parametrize("kind", ("identity", "orthogonal"))
def test_folds_match_jax(model, kind):
    _, jc, tc, jp, tp = model
    toks = jsyn.make_source(jc, 2, 16, 0).batch(0)["inputs"]
    fwd = _jit(japi.forward, static=(1, 3))
    ref = np.asarray(fwd(jp, jc, jnp.asarray(toks), JQM.off()))
    jts = (jfold.identity_set(jc.d_model, jc.n_layers, jc.head_dim,
                              t3_block=32)
           if kind == "identity" else _orthogonal_set(jc, 4))
    jf = jax.jit(lambda p: japi.fold(japi.fold_norms(p, jc), jc, jts))(jp)
    tf = tapi.fold(tapi.fold_norms(tp, tc), tc,
                   convert.tset_from_numpy(jts, "cpu"))
    assert set(tf["blocks"]) == set(jf["blocks"])
    for k, v in jf["blocks"].items():
        v = np.asarray(v)
        assert np.abs(tf["blocks"][k].numpy() - v).max() <= (
            1e-5 * max(np.abs(v).max(), 1e-30)), k
    out = tapi.forward(tf, tc, torch.from_numpy(toks),
                       TQM.off(t3=32)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)


def test_latmix_lu_two_steps_match_jax(monkeypatch):
    """``learn_transforms`` (kind lu, the LATMiX student over the MoE
    family, fake-quant experts and shared experts) from the JAX package's
    initial Ω, on the Qwen1.5-MoE reduced config."""
    jc = jconfigs.get_reduced(ARCHS[0])
    tc = tconfigs.get_reduced(ARCHS[0])
    jp = jax.jit(jmoe.init, static_argnums=(1,))(jax.random.PRNGKey(1), jc)
    tp = convert.params_from_numpy(_np(jp), "cpu")
    steps = 2
    jl = jlx.LatmixConfig(kind="lu", steps=steps)
    tl = tlx.LatmixConfig(kind="lu", steps=steps)
    src = jsyn.make_source(jc, 2, 32, 0)
    jcal = [{k: jnp.asarray(v) for k, v in src.batch(0).items()}]
    calib = [tsyn.make_source(tc, 2, 32, 0).batch(0)]
    for a, b in zip(calib, jcal):
        np.testing.assert_array_equal(np.asarray(a["inputs"]),
                                      np.asarray(b["inputs"]))
    o0 = _np(jlx.init_omega(jax.random.PRNGKey(jl.seed), jc, jl))
    _, _, hj = jlx.learn_transforms(japi.fold_norms(jp, jc), jc, jl, jcal)
    monkeypatch.setattr(tlx, "init_omega", lambda key, cfg, lx:
                        convert.params_from_numpy(o0, "cpu"))
    _, _, ht = tlx.learn_transforms(tapi.fold_norms(tp, tc), tc, tl, calib)
    assert [h["step"] for h in ht] == [h["step"] for h in hj]
    np.testing.assert_allclose(ht[0]["loss"], hj[0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(ht[0]["task"], hj[0]["task"], rtol=1e-4)
    for a, b in zip(ht[1:], hj[1:]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-2)
