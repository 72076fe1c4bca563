"""MoE artifacts through both packages' engines and artifact stores, on the
CPU, at the reduced configs of Qwen1.5-MoE-A2.7B (two shared experts,
QKV bias) and Moonlight-16B-A3B (no shared experts).

- The JAX package's RTN mxfp4 artifact of Qwen1.5-MoE (with T3: every
  expert stack packed as (L, E, K/2, N)) served by the port's engine on all
  three paths under both backends: greedy tokens, schedule counters and
  resident KV bytes equal the JAX engine's (reference backend: its fused
  path runs Pallas in interpret mode here) on traffic that puts no pad in
  a lane (ROADMAP, "MX ties": tokens are compared exactly only there).
  Under speculative decoding (k = 3) on both continuous layouts the
  port's greedy tokens equal the JAX engine's non-speculative ones.
- The port's own RTN artifact of Moonlight verifies and loads in the JAX
  package, byte for byte, and its logits there are the port's within 1e-2
  of max |logit| (the MX-tie bar).
- The CLI exports a reduced MoE artifact; the engine takes dense and moe
  on every path and refuses the families it does not serve, naming the
  slice that brings each.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.artifacts import export_artifact as j_export
from repro.artifacts import load_artifact as j_load
from repro.artifacts import verify_artifact as j_verify
from repro.core import gptq as jgptq
from repro.core import mx as jmx
from repro.core import ptq as jptq
from repro.core.quantize import QuantMode as JQM
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.artifacts import cli
from repro_torch.artifacts import load_artifact as t_load
from repro_torch.core import ptq as tptq
from repro_torch.kernels import ops as tops
from repro_torch.kernels.packing import PackedWeight
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.policy import SpecConfig as TSpec

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

QWEN, MOONLIGHT = "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"
PATHS = (("wave", "contiguous"), ("continuous", "contiguous"),
         ("continuous", "paged"))
COUNTERS = ("admitted", "decode_steps", "slot_steps", "prefill_chunk_steps",
            "prefill_lane_steps", "prefill_batched_steps",
            "prefix_hit_tokens", "useful_decode_tokens")


def _traffic():
    """Four one-chunk prompts (64 tokens: no lane carries a pad on any
    path), two of them sharing their first 32 tokens."""
    rng = np.random.default_rng(12)
    ps = [rng.integers(0, 512, 64).astype(np.int32) for _ in range(4)]
    ps[1][:32] = ps[0][:32]
    return [(p, m) for p, m in zip(ps, (8, 6, 8, 3))]


def _kw(sched, layout):
    return dict(batch_size=4, max_len=128, scheduler=sched, kv_layout=layout,
                kv_cache="mxfp8")


def _serve(eng, Request, traffic):
    reqs = [Request(prompt=p, max_new=m) for p, m in traffic()]
    eng.generate(reqs)
    return reqs


def _jit_init(name):
    jc = jconfigs.get_reduced(name)
    return jc, jax.jit(jmoe.init, static_argnums=(1,))(
        jax.random.PRNGKey(3), jc)


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    """The JAX package's RTN mxfp4 (``apply_method('rtn')``'s mode, its
    weight RTN compiled), with the T3 rotation before ``ffn_down``."""
    jc, jp = _jit_init(QWEN)
    mx = jmx.MXConfig(fmt="mxfp4", block_size=32)
    qp = jax.jit(jgptq.quantize_weights_rtn, static_argnums=(1, 2))(jp, jc,
                                                                   mx)
    res = jptq.PTQResult(qp, JQM(enabled=True, act_cfg=mx, t3_block=32),
                         None, [], "rtn")
    out = tmp_path_factory.mktemp("moe") / "qwen2-moe-smoke-rtn"
    j_export(res, jc, out)
    return out


@pytest.fixture(scope="module")
def jax_runs(jax_artifact):
    """The JAX engine and its requests on each path."""
    out = {}
    for sched, layout in PATHS:
        eng = JEngine(*j_load(jax_artifact), backend="ref",
                      **_kw(sched, layout))
        out[sched, layout] = eng, _serve(eng, JRequest, _traffic)
    return out


def _same(teng, treqs, jeng, jreqs, counters=COUNTERS):
    for a, b in zip(treqs, jreqs):
        assert a.state.value == b.state.value == "finished"
        np.testing.assert_array_equal(a.out, b.out)
    ts, js = teng.stats(), jeng.stats()
    assert {k: ts[k] for k in counters} == {k: js[k] for k in counters}
    assert teng.kv_bytes_resident() == jeng.kv_bytes_resident()


def test_jax_artifact_loads_expert_stacks(jax_artifact):
    params, cfg, qm = t_load(jax_artifact, device="cpu")
    assert tapi.module_for(cfg) is tmoe and qm.t3_block == 32
    b = params["blocks"]
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    for k, shape in (("eg", (d, f)), ("eu", (d, f)), ("ed", (f, d))):
        assert isinstance(b[k], PackedWeight)
        assert b[k].codes_packed.shape == (cfg.n_layers, E, shape[0] // 2,
                                           shape[1])
        assert b[k][1].codes_packed.shape == (E, shape[0] // 2, shape[1])
    assert isinstance(b["router"], PackedWeight) and "sg" in b


@pytest.mark.parametrize("sched,layout", PATHS)
def test_jax_artifact_engine_matches_jax_engine(jax_artifact, jax_runs,
                                                sched, layout):
    """Tokens, counters and KV bytes under both backends; under the fused
    backend every expert projection is one expert-stacked qeinsum."""
    jeng, jreqs = jax_runs[sched, layout]
    for backend in ("ref", "fused"):
        teng = TEngine(*t_load(jax_artifact, device="cpu"), device="cpu",
                       backend=backend, **_kw(sched, layout))
        tops.reset_launches()
        treqs = _serve(teng, TRequest, _traffic)
        _same(teng, treqs, jeng, jreqs)
        # fused: every routed expert projection is an expert-stacked
        # qeinsum on the kernel; only the f32 head takes the reference path
        want = {("qeinsum", backend, "ffn_in"), ("qeinsum", backend,
                                                 "ffn_down")}
        assert want <= set(tops.quant_paths)
        ref = {k for k in tops.quant_paths if k[1] == "ref"}
        assert ref == ({("qlinear", "ref", "head")} if backend == "fused"
                       else ref)


@pytest.mark.parametrize("layout", ("contiguous", "paged"))
def test_spec_matches_jax_engine(jax_artifact, jax_runs, layout):
    """Spec k = 3 (the verify forward over both layouts): greedy tokens
    equal the JAX engine's non-speculative ones."""
    _, jreqs = jax_runs["continuous", layout]
    teng = TEngine(*t_load(jax_artifact, device="cpu"), device="cpu",
                   backend="fused", spec=TSpec(k=3),
                   **_kw("continuous", layout))
    treqs = _serve(teng, TRequest, _traffic)
    for a, b in zip(treqs, jreqs):
        np.testing.assert_array_equal(a.out, b.out)
    assert teng.stats()["spec_proposed_tokens"] > 0


def test_port_artifact_serves_in_jax(tmp_path):
    """The port's RTN artifact of Moonlight: the JAX package verifies and
    loads it byte for byte, and its logits there are the port's."""
    jc, jp = _jit_init(MOONLIGHT)
    tc = tconfigs.get_reduced(MOONLIGHT)
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                       "cpu")
    out = tptq.apply_method("rtn", params, tc, fmt="mxfp4").export(
        tc, tmp_path / "port-moonlight-rtn")
    assert j_verify(out)["method"] == "rtn"
    jp2, jc2, jq = j_load(out)
    tp2, tc2, tq = t_load(out, device="cpu")
    assert dataclasses.asdict(jc2) == dataclasses.asdict(tc2)
    for k in ("eg", "eu", "ed", "router"):
        np.testing.assert_array_equal(np.asarray(jp2["blocks"][k].codes_packed),
                                      tp2["blocks"][k].codes_packed.numpy())
    toks = np.random.default_rng(5).integers(0, 512, (2, 40)).astype(np.int32)
    for backend in ("ref", "fused"):
        t = tapi.forward(tp2, tc2, torch.from_numpy(toks),
                         tq.with_backend(backend)).numpy()
        j = np.asarray(jax.jit(japi.forward, static_argnums=(1, 3))(
            jp2, jc2, jnp.asarray(toks), jq.with_backend("ref")))
        assert np.abs(t - j).max() <= 1e-2 * np.abs(j).max()


def test_cli_exports_a_moe_artifact(tmp_path):
    out = tmp_path / "cli-moe"
    assert cli.main(["export", "--arch", MOONLIGHT, "--reduced", "--method",
                     "rtn", "--calib-batches", "1", "--device", "cpu",
                     "--out", str(out)]) == 0
    assert cli.main(["verify", str(out)]) == 0
    params, cfg, _ = t_load(out, device="cpu")
    assert cfg.family == "moe" and cfg.n_experts == 8
    assert params["blocks"]["eg"].codes_packed.shape[:2] == (
        cfg.n_layers, cfg.n_experts)


@pytest.mark.parametrize("family,kw,match", (
    pytest.param("ssm", {"scheduler": "continuous"},
                 "recurrent-state families must use scheduler='wave'",
                 id="ssm-recurrent families"),
    pytest.param("hybrid", {"scheduler": "continuous"},
                 "recurrent-state families must use scheduler='wave'",
                 id="hybrid-recurrent families"),
    pytest.param("vlm", {}, "token prompts", id="vlm-token prompts")))
def test_engine_refuses_unported_families(family, kw, match):
    """The JAX engine's gates, then the port's own: the recurrent families
    are served by the wave scheduler only (the continuous one raises), and
    a vlm not at all (it takes embeddings, and every scheduler feeds token
    prompts)."""
    cfg = dataclasses.replace(tconfigs.get_reduced(QWEN), family=family)
    with pytest.raises(ValueError, match=match):
        TEngine({}, cfg, tptq.QuantMode.off(), device="cpu", **kw)
    with pytest.raises(ValueError, match="recurrent"):
        TEngine({}, cfg, tptq.QuantMode.off(), device="cpu",
                scheduler="continuous", kv_layout="paged")
    enc = dataclasses.replace(cfg, family="encoder")
    with pytest.raises(ValueError, match="autoregressively"):
        TEngine({}, enc, tptq.QuantMode.off(), device="cpu")
