"""The port's dense transformer and artifact store against the JAX package,
on the trained 4-layer checkpoint in experiments/bench_model: logits of the
full forward, paged chunked prefill and paged decode; artifacts exported by
either package load byte-equal in the other; tampering raises."""
import dataclasses
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.artifacts import export_artifact as j_export
from repro.artifacts import load_artifact as j_load
from repro.configs.base import ArchConfig as JArch
from repro.core import ptq as jptq
from repro.core.quantize import KVCacheQuant as JKV
from repro.core.quantize import QuantMode as JQM
from repro.kernels.packing import PackedWeight as JPW
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.artifacts import (IntegrityError, export_artifact,
                                   load_artifact, verify_artifact)
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import ptq as tptq
from repro_torch.core.quantize import KVCacheQuant as TKV
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.kernels.packing import PackedWeight as TPW
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
        np_params)


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


def _paged_run(mod, params, cfg, qm, kv, toks, as_array):
    """Two chunked-prefill calls (per-lane starts) then three decode steps
    through scattered block tables; returns the logits of every call."""
    P, C = 64, cfg.attn_chunk
    cache = mod.init_cache_paged(cfg, 8, P, kv_quant=kv)
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
    conv = convert.params_from_numpy(_numpy_tree(jp))
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
