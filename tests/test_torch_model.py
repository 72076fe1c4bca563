"""The port's dense transformer and artifact store against the JAX package,
on the trained 4-layer checkpoint in experiments/bench_model: logits of the
full forward, of full and chunked prefill and of decode over the
contiguous cache, and of paged chunked prefill and paged decode; artifacts
exported by either package load byte-equal in the other; tampering
raises."""
import dataclasses
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.artifacts import export_artifact as j_export
from repro.artifacts import load_artifact as j_load
from repro.configs.base import ArchConfig as JArch
from repro.core import mx as jmx
from repro.core import ptq as jptq
from repro.core import transforms as jtfm
from repro.core.quantize import KVCacheQuant as JKV
from repro.core.quantize import QuantMode as JQM
from repro.kernels.packing import PackedWeight as JPW
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.artifacts import (IntegrityError, export_artifact,
                                   load_artifact, verify_artifact)
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import mx as tmx
from repro_torch.core import ptq as tptq
from repro_torch.core import transforms as ttfm
from repro_torch.core.quantize import KVCacheQuant as TKV
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.kernels.packing import PackedWeight as TPW
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "experiments" / "bench_model" / "step_00000250" / "arrays.npz"
BENCH = dict(name="bench-llama", family="dense", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=4, head_dim=16, d_ff=352, vocab_size=512,
             attn_chunk=64)
JCFG, TCFG = JArch(**BENCH), TArch(**BENCH)


def _bench_params():
    with np.load(CKPT) as z:
        flat = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _numpy_tree(tree):
    """JAX params (PackedWeight nodes included) -> numpy leaves."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, JPW):
        return {"codes_packed": np.asarray(tree.codes_packed),
                "scales_e8m0": np.asarray(tree.scales_e8m0),
                "fmt": tree.fmt, "dtype": tree.dtype}
    return np.asarray(tree)


def _close(a, b, rel):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), \
        (np.abs(a - b).max(), np.abs(b).max())


@pytest.fixture(scope="module")
def bench():
    np_params = _bench_params()
    return np_params, _jax_tree(np_params), convert.params_from_numpy(
        np_params, device="cpu")


@pytest.fixture(scope="module")
def jax_artifact(bench, tmp_path_factory):
    """The bench model, RTN mxfp4 by the JAX package, with the T3 rotation
    on so the ffn_down prologue runs; exported by the JAX package."""
    _, jparams, _ = bench
    res = jptq.apply_method("rtn", jparams, JCFG, calib=[])
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    out = tmp_path_factory.mktemp("art") / "bench-mxfp4"
    j_export(res, JCFG, out)
    return out


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, BENCH["vocab_size"], shape).astype(np.int32)


def test_forward_matches_jax_unquantized(bench):
    _, jparams, tparams = bench
    toks = _tokens(0, (2, 40))
    lj = jtf.forward(jparams, JCFG, jnp.asarray(toks), JQM.off())
    lt = ttf.forward(tparams, TCFG, torch.from_numpy(toks), TQM.off())
    _close(lt.numpy(), lj, 1e-4)


def _init_kw(mod):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    return {"device": "cpu"} if mod is ttf else {}


def _paged_run(mod, params, cfg, qm, kv, toks, as_array):
    """Two chunked-prefill calls (per-lane starts) then three decode steps
    through scattered block tables; returns the logits of every call."""
    P, C = 64, cfg.attn_chunk
    cache = mod.init_cache_paged(cfg, 8, P, kv_quant=kv, **_init_kw(mod))
    bt = as_array(np.array([[5, 2, 7], [3, 6, 1]], np.int32))
    out = []
    for ci, last in ((0, [63, 63]), (1, [10, 40])):
        lg, cache = mod.prefill_chunk_paged(
            params, cfg, cache, bt, as_array(toks[:, ci * C:(ci + 1) * C]),
            as_array(np.array([ci * C, ci * C], np.int32)),
            as_array(np.array(last, np.int32)), qm)
        out.append(np.asarray(lg))
    cur = np.array([C + 11, C + 41], np.int32)
    nxt = out[-1].argmax(-1).astype(np.int32)
    for _ in range(3):
        lg, cache = mod.decode_paged(params, cfg, cache, as_array(nxt),
                                     as_array(cur), bt, qm)
        lg = np.asarray(lg)
        out.append(lg)
        nxt, cur = lg.argmax(-1).astype(np.int32), cur + 1
    return out


@pytest.mark.parametrize("kv", ("none", "mxfp8"))
def test_paged_prefill_decode_match_jax_unquantized(bench, kv):
    _, jparams, tparams = bench
    toks = _tokens(1, (2, 128))
    lj = _paged_run(jtf, jparams, JCFG, JQM.off(), JKV.parse(kv), toks,
                    jnp.asarray)
    lt = _paged_run(ttf, tparams, TCFG, TQM.off(), TKV.parse(kv), toks,
                    torch.from_numpy)
    for a, b in zip(lt, lj):
        _close(a, b, 1e-4)


def _scalar(mod, v):
    return jnp.int32(v) if mod is jtf else int(v)


def _contiguous_run(mod, params, cfg, qm, kv, toks, as_array):
    """The contiguous cache both ways: a full prefill of ``toks`` into a
    128-row cache then three decode steps at one shared position (the
    wave scheduler); and two chunked-prefill calls into a fresh cache
    then three decode steps at per-lane positions (the continuous
    scheduler). Returns the logits of every call."""
    C, S = cfg.attn_chunk, 40
    out = []
    lg, cache = mod.prefill(params, cfg, as_array(toks[:, :S]), qm,
                            max_len=128, kv_quant=kv)
    out.append(np.asarray(lg))
    nxt = out[-1].argmax(-1).astype(np.int32)
    for t in range(3):
        lg, cache = mod.decode(params, cfg, cache, as_array(nxt),
                               _scalar(mod, S + t), qm)
        out.append(np.asarray(lg))
        nxt = out[-1].argmax(-1).astype(np.int32)
    cache = mod.init_cache(cfg, 2, 128, kv_quant=kv, **_init_kw(mod))
    for ci, last in ((0, 63), (1, 40)):
        lg, cache = mod.prefill_chunk(
            params, cfg, cache, as_array(toks[:, ci * C:(ci + 1) * C]),
            _scalar(mod, ci * C), _scalar(mod, last), qm)
        out.append(np.asarray(lg))
    cur = np.array([C + 11, C + 41], np.int32)
    nxt = out[-1].argmax(-1).astype(np.int32)
    for _ in range(3):
        lg, cache = mod.decode(params, cfg, cache, as_array(nxt),
                               as_array(cur), qm)
        out.append(np.asarray(lg))
        nxt, cur = out[-1].argmax(-1).astype(np.int32), cur + 1
    return out


@pytest.mark.parametrize("backend", ("ref", "fused"))
@pytest.mark.parametrize("kv", ("none", "mxfp8"))
def test_contiguous_prefill_decode_match_jax(bench, kv, backend):
    """Full and chunked prefill and both decode forms over the contiguous
    cache, the f32 checkpoint, the same backend on both sides: logits
    within 1e-4 of max |logit|."""
    _, jparams, tparams = bench
    toks = _tokens(4, (2, 128))
    lj = _contiguous_run(jtf, jparams, JCFG, JQM.off().with_backend(backend),
                         JKV.parse(kv), toks, jnp.asarray)
    lt = _contiguous_run(ttf, tparams, TCFG, TQM.off().with_backend(backend),
                         TKV.parse(kv), toks, torch.from_numpy)
    for a, b in zip(lt, lj):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("backend", ("ref", "fused"))
def test_contiguous_artifact_matches_jax(jax_artifact, backend):
    """The mxfp4 artifact (weights, activations, T3) over the contiguous
    cache, the same backend on both sides: within 1e-2 of max |logit| of
    the JAX package, the bar of the paged path, with a dense cache and
    with an mxfp8 cache (on the paged test's traffic). Where the two
    packages part instead, the cause is a one-ulp tie at an MX snap
    midpoint (see the test below); on such traffic the port's fused path
    (the kernels' plain versions) still gives its reference path's logits
    bit for bit."""
    jp, _, jqm = j_load(jax_artifact)
    tp, _, tqm = load_artifact(jax_artifact, device="cpu")
    for kv, seed in ((None, 4), ("mxfp8", 3)):
        toks = _tokens(seed, (2, 128))
        lj = _contiguous_run(jtf, jp, JCFG, jqm.with_backend(backend),
                             kv and JKV(kv), toks, jnp.asarray)
        lt = _contiguous_run(ttf, tp, TCFG, tqm.with_backend(backend),
                             kv and TKV(kv), toks, torch.from_numpy)
        for a, b in zip(lt, lj):
            _close(a, b, 1e-2)
    toks = _tokens(4, (2, 128))
    lt = _contiguous_run(ttf, tp, TCFG, tqm.with_backend(backend),
                         TKV("mxfp8"), toks, torch.from_numpy)
    other = "ref" if backend == "fused" else "fused"
    lo = _contiguous_run(ttf, tp, TCFG, tqm.with_backend(other),
                         TKV("mxfp8"), toks, torch.from_numpy)
    for a, b in zip(lt, lo):
        np.testing.assert_array_equal(a, b)


def _record_activations(monkeypatch):
    """Record the activation handed to every quantized linear of both
    packages' dense models, in call order, as numpy arrays."""
    rec = {"j": [], "t": []}

    def hook(mod, side, record):
        inner = mod.qlinear

        def wrapped(x, w, b, qm, role=""):
            record(role, x)
            return inner(x, w, b, qm, role)
        monkeypatch.setattr(mod, "qlinear", wrapped)

    def record_jax(role, x):
        # inside the package's compiled layer scan, as it runs there
        jax.debug.callback(
            lambda v: rec["j"].append((role, np.asarray(v))), x,
            ordered=True)
    for mod in (jtf, jlayers):
        hook(mod, "j", record_jax)
    for mod in (ttf, tlayers):
        hook(mod, "t", lambda role, x: rec["t"].append(
            (role, x.detach().numpy().copy())))
    return rec


def _jax_act(x, qm, role):
    """What the JAX package's quantized linear snaps: (value, snapped)."""
    x = jnp.asarray(x)
    if qm.t3_block and role == "ffn_down":
        x = jtfm.apply_blockwise(x, jtfm.hadamard_matrix(qm.t3_block))
    return np.asarray(x), np.asarray(jmx.quantize(x, qm.act_cfg))


def _port_act(x, qm, role):
    x = torch.tensor(x)
    if qm.t3_block and role == "ffn_down":
        x = ttfm.apply_blockwise(x, ttfm.hadamard_matrix(qm.t3_block))
    return x.numpy(), tmx.quantize(x, qm.act_cfg).numpy()


def _tie(a, b, edge):
    """``a`` and ``b`` lie on either side of ``edge`` (or on it), within
    four ulps of each other."""
    lo, hi = sorted((np.float32(a), np.float32(b)))
    edge = np.float32(edge)
    assert lo <= edge <= hi and hi - lo <= 4 * abs(np.spacing(edge)), \
        (a, b, edge)


@pytest.mark.parametrize("backend", ("ref", "fused"))
@pytest.mark.parametrize("kind,seed",
                         [("chunk-mxfp8", s) for s in (3, 4, 5, 6)]
                         + [("left-pads", n) for n in (0, 10, 60)])
def test_artifact_parts_from_jax_only_at_ulp_ties(jax_artifact, monkeypatch,
                                                  kind, seed, backend):
    """Where the mxfp4 artifact's logits part from the JAX package's, the
    cause is an MX tie decided by the last bits of an f32 sum, not the
    port. One call runs in both packages, the same backend on both sides:
    the first chunk of a chunked prefill into an mxfp8 contiguous cache
    (tokens from ``seed``), or a full prefill with lane 0 left-padded by
    ``seed`` zero tokens. Every quantized linear's activation is recorded
    (on the JAX side inside its compiled layer scan). Up to the first
    activation code that differs, the port's quantizer gives the JAX
    package's codes on the JAX package's own activation. In the first
    linear where codes differ, every differing 32-block is a tie: either
    its amax lies within four ulps on either side of a power of two (the
    block scale), or each differing element lies within four ulps on
    either side of the midpoint of its two codes (both packages round a
    midpoint away from zero). With no differing code, the logits agree
    within 1e-4 of max |logit|."""
    rec = _record_activations(monkeypatch)
    jp, _, jqm = j_load(jax_artifact)
    tp, _, tqm = load_artifact(jax_artifact, device="cpu")
    jqm, tqm = jqm.with_backend(backend), tqm.with_backend(backend)
    toks = _tokens(seed, (2, 128))
    if kind == "chunk-mxfp8":
        C = JCFG.attn_chunk
        cache = jtf.init_cache(JCFG, 2, 128, kv_quant=JKV("mxfp8"))
        lj, _ = jtf.prefill_chunk(jp, JCFG, cache, jnp.asarray(toks[:, :C]),
                                  jnp.int32(0), jnp.int32(C - 1), jqm)
        cache = ttf.init_cache(TCFG, 2, 128, kv_quant=TKV("mxfp8"),
                               device="cpu")
        lt, _ = ttf.prefill_chunk(tp, TCFG, cache,
                                  torch.from_numpy(toks[:, :C]), 0, C - 1,
                                  tqm)
    else:
        toks[0, :seed] = 0
        lj, _ = jtf.prefill(jp, JCFG, jnp.asarray(toks), jqm)
        lt, _ = ttf.prefill(tp, TCFG, torch.from_numpy(toks), tqm)
    jax.effects_barrier()
    assert len(rec["j"]) == len(rec["t"]) > 0
    for (role, aj), (role_t, at) in zip(rec["j"], rec["t"]):
        assert role == role_t
        if role == "head" and not jqm.quantize_head:
            continue
        xj, qj = _jax_act(aj, jqm, role)
        np.testing.assert_array_equal(_port_act(aj, tqm, role)[1], qj)
        xt, qt = _port_act(at, tqm, role)
        if np.array_equal(qj, qt):
            continue
        blk = qj.shape[:-1] + (-1, 32)
        xj, xt = xj.reshape(blk), xt.reshape(blk)
        qj, qt = qj.reshape(blk), qt.reshape(blk)
        for i in map(tuple, np.argwhere((qj != qt).any(-1))):
            aj, at = np.abs(xj[i]).max(), np.abs(xt[i]).max()
            if np.frexp(aj)[1] != np.frexp(at)[1]:
                # the block's amax straddles a power of two: its scale
                _tie(aj, at, np.float32(2.0 ** (np.frexp(max(aj, at))[1]
                                                - 1)))
                continue
            for k in np.flatnonzero(qj[i] != qt[i]):
                # one element straddles the midpoint of its two codes
                _tie(xj[i][k], xt[i][k], (qj[i][k] + qt[i][k]) / 2)
        return
    _close(lt.numpy(), np.asarray(lj), 1e-4)


def test_artifact_loads_byte_equal_and_serves(bench, jax_artifact):
    jp, jcfg, jqm = j_load(jax_artifact)
    tp, tcfg, tqm = load_artifact(jax_artifact, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tqm == TQM(enabled=True, act_cfg=tqm.act_cfg, weight_cfg=None,
                      t3_block=32)
    for k, v in jp["blocks"].items():
        t = tp["blocks"][k]
        if isinstance(v, JPW):
            assert isinstance(t, TPW)
            np.testing.assert_array_equal(t.codes_packed.numpy(),
                                          np.asarray(v.codes_packed))
            np.testing.assert_array_equal(t.scales_e8m0.numpy(),
                                          np.asarray(v.scales_e8m0))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(v))
    np.testing.assert_array_equal(tp["embed"].numpy(),
                                  np.asarray(jp["embed"]))
    # the same weights handed over in memory
    conv = convert.params_from_numpy(_numpy_tree(jp), device="cpu")
    assert torch.equal(conv["blocks"]["wd"].codes_packed,
                       tp["blocks"]["wd"].codes_packed)
    toks = _tokens(2, (2, 48))
    lj = np.asarray(jtf.forward(jp, JCFG, jnp.asarray(toks), jqm))
    for backend in ("ref", "fused"):
        lt = ttf.forward(tp, TCFG, torch.from_numpy(toks),
                         tqm.with_backend(backend))
        _close(lt.numpy(), lj, 1e-2)
    toks = _tokens(3, (2, 128))
    lj = _paged_run(jtf, jp, JCFG, jqm, JKV("mxfp8"), toks, jnp.asarray)
    lt = _paged_run(ttf, tp, TCFG, tqm.with_backend("fused"), TKV("mxfp8"),
                    toks, torch.from_numpy)
    for a, b in zip(lt, lj):
        _close(a, b, 1e-2)


def test_bf16_leaves_load_byte_equal(bench, tmp_path):
    _, jparams, _ = bench
    p = dict(jparams)
    p["embed"] = jparams["embed"].astype(jnp.bfloat16)
    p["ln_f"] = jparams["ln_f"].astype(jnp.bfloat16)
    res = jptq.apply_method("rtn", p, JCFG, calib=[])
    out = tmp_path / "bf16"
    j_export(res, JCFG, out)
    jp, _, _ = j_load(out)
    tp, _, _ = load_artifact(out, device="cpu")
    for key in ("embed", "ln_f"):
        assert tp[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp[key].view(torch.int16).numpy(),
            np.asarray(jp[key]).view(np.int16))
    # and back: the port's export of those leaves reloads in JAX
    tres = tptq.PTQResult(tp, TQM(enabled=True,
                                  act_cfg=tptq.mxlib.MXConfig()), None, [],
                          "rtn")
    tp["blocks"] = {k: (v.to_dense() if isinstance(v, TPW) else v)
                    for k, v in tp["blocks"].items()}
    back = tmp_path / "bf16-port"
    export_artifact(tres, TCFG, back)
    jp2, _, _ = j_load(back)
    np.testing.assert_array_equal(np.asarray(jp2["embed"]).view(np.int16),
                                  np.asarray(jp["embed"]).view(np.int16))
    np.testing.assert_array_equal(np.asarray(jp2["blocks"]["wq"].codes_packed),
                                  np.asarray(jp["blocks"]["wq"].codes_packed))


def test_port_rtn_export_matches_jax_rtn(bench, tmp_path):
    np_params, jparams, tparams = bench
    jres = jptq.apply_method("rtn", jparams, JCFG, calib=[])
    tres = tptq.apply_method("rtn", tparams, TCFG)
    j_export(jres, JCFG, tmp_path / "j")
    export_artifact(tres, TCFG, tmp_path / "t")
    jp, _, _ = j_load(tmp_path / "t")
    tp, _, _ = load_artifact(tmp_path / "j", device="cpu")
    for k in ("wq", "wd"):
        np.testing.assert_array_equal(tp["blocks"][k].codes_packed.numpy(),
                                      np.asarray(jp["blocks"][k].codes_packed))
    assert verify_artifact(tmp_path / "t")["ok"]


def test_tampered_artifact_raises(jax_artifact, tmp_path):
    bad = tmp_path / "bad"
    shutil.copytree(jax_artifact, bad)
    with np.load(bad / "weights.npz") as z:
        arrs = {k: z[k].copy() for k in z.files}
    arrs["blocks/wq.codes"].reshape(-1)[0] ^= 0x11
    np.savez(bad / "weights.npz", **arrs)
    with pytest.raises(IntegrityError):
        load_artifact(bad, device="cpu")
    with pytest.raises(IntegrityError):
        verify_artifact(bad)
    (bad / "aux.npz").write_bytes(b"not a zip")
    with pytest.raises(IntegrityError):
        load_artifact(bad, device="cpu", verify=False)


WIDE_HEADS = dict(name="wide-heads", family="dense", n_layers=2, d_model=256,
                  n_heads=2, n_kv_heads=1, head_dim=128, d_ff=512,
                  vocab_size=512, qkv_bias=True, attn_chunk=64)


def _wide_heads_params(seed):
    """Random numpy weights of WIDE_HEADS in the packages' layout
    (layer-stacked blocks, (in, out) matrices, QKV bias, untied head)."""
    rng = np.random.default_rng(seed)
    c = WIDE_HEADS
    L, d, f = c["n_layers"], c["d_model"], c["d_ff"]
    qd = c["n_heads"] * c["head_dim"]
    kd = c["n_kv_heads"] * c["head_dim"]

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    def b(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    ones = lambda *shape: np.ones(shape, np.float32)  # noqa: E731
    blocks = {"ln1": ones(L, d), "wq": w(L, d, qd), "wk": w(L, d, kd),
              "wv": w(L, d, kd), "wo": w(L, qd, d), "ln2": ones(L, d),
              "wg": w(L, d, f), "wu": w(L, d, f), "wd": w(L, f, d),
              "bq": b(L, qd), "bk": b(L, kd), "bv": b(L, kd)}
    return {"blocks": blocks, "ln_f": ones(d),
            "embed": (rng.standard_normal((c["vocab_size"], d))
                      ).astype(np.float32),
            "head": w(d, c["vocab_size"])}


def test_paged_path_at_head_dim_128_matches_jax():
    """A 2-layer model with heads of 128 (two over one KV head), the same
    numpy weights in both packages (the port's through ``convert``): paged
    chunked prefill and decode over an mxfp8 pool through the fused path
    of both (the port's kernels' plain versions here, the Pallas kernels
    in interpret mode there): logits within 1e-2 of max |logit|, the paged
    path's bar."""
    jcfg, tcfg = JArch(**WIDE_HEADS), TArch(**WIDE_HEADS)
    npp = _wide_heads_params(5)
    tp = convert.params_from_numpy(npp, device="cpu")
    toks = np.random.default_rng(6).integers(
        0, WIDE_HEADS["vocab_size"], (2, 128)).astype(np.int32)
    lj = _paged_run(jtf, _jax_tree(npp), jcfg, JQM.off().with_backend("fused"),
                    JKV("mxfp8"), toks, jnp.asarray)
    lt = _paged_run(ttf, tp, tcfg, TQM.off().with_backend("fused"),
                    TKV("mxfp8"), toks, torch.from_numpy)
    for a, b in zip(lt, lj):
        _close(a, b, 1e-2)


def test_qwen2_7b_config_matches_jax():
    """The port's copy of the Qwen2-7B config (CONFIG and REDUCED) equals
    the JAX package's field for field."""
    from repro.configs import qwen2_7b as jq
    from repro_torch import configs as tconfigs
    from repro_torch.configs import qwen2_7b as tq
    for name in ("CONFIG", "REDUCED"):
        assert (dataclasses.asdict(getattr(tq, name))
                == dataclasses.asdict(getattr(jq, name)))
    assert tconfigs.get("qwen2-7b") is tq.CONFIG
    assert tconfigs.get_reduced("qwen2-7b") is tq.REDUCED
