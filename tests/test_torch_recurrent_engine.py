"""The recurrent families (RecurrentGemma-2B's and Mamba2-130M's reduced
configs) through the port's engine, artifact store and entry points, on
the CPU, against the JAX package's.

- The wave engine on the contiguous cache (the one path both packages
  serve these families on): greedy tokens, schedule counters and resident
  KV bytes equal the JAX engine's on f32 weights (the JAX package's init),
  and on the JAX package's RTN mxfp4 artifact (T3 before ``ffn_down``)
  under both backends (fused: the plain versions here). Traffic puts no
  pad in a lane: Griffin's prompts are one attention chunk (64 tokens,
  twice its 32-token window, so the ring wraps), Mamba2's are unbucketed
  (its chunk of 1024 exceeds ``max_len``). Griffin keeps an mxfp8 ring,
  Mamba2 serves with ``kv_cache='none'``.
- The refusals: the engine's paged, continuous, spec and (ssm) kv_cache
  cases and the API's chunked-prefill, paged, verify and (ssm) kv_quant
  calls raise with the JAX package's messages, word for word.
- The port's artifacts of both families verify and load in the JAX
  package; its logits there are the port's within 1e-2 of max |logit|
  (the MX-tie bar). ``launch.serve --arch ... --reduced --device cpu`` and
  ``launch.train --arch ... --reduced --device cpu`` run both.
- Four bf16 AdamW steps (``launch.steps.make_train_step``) from the JAX
  package's bf16 init against its jitted step: the first loss within
  1e-4 relative, the later ones within 2e-3 (bf16 parameters round the
  two packages' updates apart by an ulp).
"""
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
from repro.core.quantize import KVCacheQuant as JKVQ
from repro.core.quantize import QuantMode as JQM
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.policy import SpecConfig as JSpec
from repro.training import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.artifacts import cli as tcli
from repro_torch.artifacts import load_artifact as t_load
from repro_torch.core.quantize import KVCacheQuant as TKVQ
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.kernels.packing import PackedWeight
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.policy import SpecConfig as TSpec
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt

torch.set_num_threads(1)

GRIFFIN, MAMBA = "recurrentgemma-2b", "mamba2-130m"
KV = {GRIFFIN: "mxfp8", MAMBA: "none"}
PROMPT = {GRIFFIN: 64, MAMBA: 24}
COUNTERS = ("admitted", "decode_steps", "slot_steps", "prefill_chunk_steps",
            "useful_decode_tokens")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _traffic(name):
    rng = np.random.default_rng(13)
    return [(rng.integers(0, 512, PROMPT[name]).astype(np.int32), m)
            for m in (8, 5, 8, 3, 6)]


def _kw(name):
    return dict(batch_size=4, max_len=128, scheduler="wave",
                kv_layout="contiguous", kv_cache=KV[name])


def _serve(eng, Request, name):
    reqs = [Request(prompt=p, max_new=m) for p, m in _traffic(name)]
    eng.generate(reqs)
    return reqs


def _same(teng, treqs, jeng, jreqs):
    for a, b in zip(treqs, jreqs):
        assert a.state.value == b.state.value == "finished"
        np.testing.assert_array_equal(a.out, b.out)
    ts, js = teng.stats(), jeng.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert teng.kv_bytes_resident() == jeng.kv_bytes_resident()


@pytest.fixture(scope="module", params=[GRIFFIN, MAMBA])
def family(request, tmp_path_factory):
    """(name, JAX config, JAX f32 params, the port's copy, the JAX
    package's RTN artifact of those weights)."""
    name = request.param
    jc = jconfigs.get_reduced(name)
    jp = jax.jit(japi.init, static_argnums=1)(jax.random.PRNGKey(2), jc)
    mx = jmx.MXConfig(fmt="mxfp4", block_size=32)
    qp = jax.jit(jgptq.quantize_weights_rtn, static_argnums=(1, 2))(jp, jc,
                                                                   mx)
    art = tmp_path_factory.mktemp("rec") / f"{name}-rtn"
    j_export(jptq.PTQResult(qp, JQM(enabled=True, act_cfg=mx, t3_block=32),
                            None, [], "rtn"), jc, art)
    return name, jc, jp, convert.params_from_numpy(_np(jp), "cpu"), art


def test_wave_engine_matches_jax_on_f32_weights(family):
    name, jc, jp, tp, _ = family
    jeng = JEngine(jp, jc, JQM.off(), **_kw(name))
    jreqs = _serve(jeng, JRequest, name)
    teng = TEngine(tp, tconfigs.get_reduced(name), TQM.off(), device="cpu",
                   **_kw(name))
    _same(teng, _serve(teng, TRequest, name), jeng, jreqs)


@pytest.fixture(scope="module")
def jax_artifact_run(family):
    name, _, _, _, art = family
    jeng = JEngine(*j_load(art), backend="ref", **_kw(name))
    return jeng, _serve(jeng, JRequest, name)


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_jax_artifact_served_by_the_port(family, jax_artifact_run, backend):
    name, _, _, _, art = family
    params, cfg, qm = t_load(art, device="cpu")
    wx = params["super"]["r1"]["wx"] if name == GRIFFIN else \
        params["blocks"]["in_proj"]
    assert isinstance(wx, PackedWeight) and qm.t3_block == 32
    teng = TEngine.from_artifact(art, backend=backend, device="cpu",
                                 **_kw(name))
    _same(teng, _serve(teng, TRequest, name), *jax_artifact_run)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["paged", "continuous", "spec",
                                  "kv_cache"])
def test_engine_refusals_are_the_jax_engines(family, case):
    name, jc, jp, tp, _ = family
    tc = tconfigs.get_reduced(name)
    kw = {"paged": dict(scheduler="continuous", kv_layout="paged"),
          "continuous": dict(scheduler="continuous"),
          "spec": dict(scheduler="wave"),
          "kv_cache": dict(kv_cache="mxfp8")}[case]
    if case == "kv_cache" and name == GRIFFIN:
        TEngine(tp, tc, TQM.off(), device="cpu", **kw)    # a ring serves
        return
    jspec = JSpec(k=2) if case == "spec" else None
    tspec = TSpec(k=2) if case == "spec" else None
    want = _message(lambda: JEngine(jp, jc, JQM.off(), spec=jspec, **kw))
    assert _message(lambda: TEngine(tp, tc, TQM.off(), spec=tspec,
                                    device="cpu", **kw)) == want


def test_api_refusals_are_the_jax_packages(family):
    name, jc, jp, tp, _ = family
    tc = tconfigs.get_reduced(name)
    x = np.zeros((1, 4), np.int32)
    calls = [
        (lambda: japi.prefill_chunk(jp, jc, None, x, 0, 3),
         lambda: tapi.prefill_chunk(tp, tc, None, torch.from_numpy(x), 0, 3)),
        (lambda: japi.prefill_chunk_paged(jp, jc, None, None, x, 0, 3),
         lambda: tapi.prefill_chunk_paged(tp, tc, None, None, x, 0, 3)),
        (lambda: japi.decode_paged(jp, jc, None, x[:, 0], 0, None),
         lambda: tapi.decode_paged(tp, tc, None, x[:, 0], 0, None)),
        (lambda: japi.init_cache_paged(jc, 4, 64),
         lambda: tapi.init_cache_paged(tc, 4, 64, device="cpu")),
        (lambda: japi.verify(jp, jc, None, x, x[:, 0], x[:, 0]),
         lambda: tapi.verify(tp, tc, None, x, x[:, 0], x[:, 0])),
        (lambda: japi.verify_paged(jp, jc, None, x, x[:, 0], x[:, 0], None),
         lambda: tapi.verify_paged(tp, tc, None, x, x[:, 0], x[:, 0], None)),
    ]
    if name == MAMBA:
        calls += [
            (lambda: japi.prefill(jp, jc, x, kv_quant=JKVQ("mxfp8")),
             lambda: tapi.prefill(tp, tc, torch.from_numpy(x),
                                  kv_quant=TKVQ("mxfp8"))),
            (lambda: japi.init_cache(jc, 1, 8, kv_quant=JKVQ("mxfp8")),
             lambda: tapi.init_cache(tc, 1, 8, kv_quant=TKVQ("mxfp8"),
                                     device="cpu"))]
    for jfn, tfn in calls:
        assert _message(tfn) == _message(jfn)


def test_port_artifact_serves_in_jax(family, tmp_path):
    """The CLI's RTN export of the arch (seeded init on the CPU) verifies
    and loads in the JAX package, and its logits there are the port's."""
    name = family[0]
    out = tmp_path / "art"
    assert tcli.main(["export", "--arch", name, "--reduced", "--method",
                      "rtn", "--calib-batches", "1", "--device", "cpu",
                      "--out", str(out)]) == 0
    assert tcli.main(["verify", str(out)]) == 0
    assert j_verify(out)["n_tensors"] > 0
    tp, tc, tqm = t_load(out, device="cpu")
    jp, jc, jqm = j_load(out)
    assert jc.family == tc.family
    toks = np.random.default_rng(4).integers(0, 512, (2, 24)).astype(
        np.int32)
    with torch.no_grad():
        got = tapi.forward(tp, tc, torch.from_numpy(toks), tqm).numpy()
    want = np.asarray(jax.jit(japi.forward, static_argnums=(1, 3))(
        jp, jc, jnp.asarray(toks), jqm))
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_launch_serve_and_train_take_the_arch(family, tmp_path, capsys):
    name = family[0]
    ck = tmp_path / "ck"
    assert ttrain.main(["--arch", name, "--reduced", "--steps", "2",
                        "--batch", "2", "--seq", "32", "--ckpt-dir", str(ck),
                        "--ckpt-every", "2", "--device", "cpu"]) == 0
    assert tckpt.latest_step(ck) == 2
    assert tserve.main(["--arch", name, "--reduced", "--ckpt-dir", str(ck),
                        "--method", "rtn", "--device", "cpu", "--kv-cache",
                        KV[name], "--requests", "2", "--prompt-len", "16",
                        "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "loaded checkpoint step 2" in out and '"tokens": 8' in out


@pytest.mark.parametrize("name", [GRIFFIN, MAMBA])
def test_bf16_train_steps_match_jax(name):
    jc, tc = jconfigs.get_reduced(name), tconfigs.get_reduced(name)
    jp = jax.jit(japi.init, static_argnums=(1, 2))(jax.random.PRNGKey(0), jc,
                                                   jnp.bfloat16)
    tp = convert.params_from_numpy(_np(jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    js, ts = jopt.init_state(jp), topt.init_state(tp)

    def ocfg(o):
        return o.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(jc, ocfg(jopt)))
    tstep = tsteps.make_train_step(tc, ocfg(topt))
    src = jsyn.make_source(jc, 4, 32, 0)
    for i in range(4):
        b = src.batch(i)
        jp, js, jl, _ = jstep(jp, js, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        tp, ts, tl, _ = tstep(tp, ts, {k: torch.as_tensor(v).long()
                                       for k, v in b.items()})
        bar = 1e-4 if i == 0 else 2e-3
        assert abs(float(tl) - float(jl)) <= bar * abs(float(jl)), i
