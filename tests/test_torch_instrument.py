"""The port's kernel-dispatch instrumentation (``kernels.ops.instrument``)
against the JAX package's, an mxint4 engine against the JAX engine, and
the ``--metrics`` / ``--eager`` entry points.

One fused paged run of each engine on an RTN mxint4 artifact of the
trained bench model gives the same op and
(op, path, role) label sets in both registries; the port's counts equal
its wrapper calls and its ``quant_paths``, every one ``traced="false"``
(the JAX engine's calls run inside ``jit`` and carry ``traced="true"``).
The mxint4 engine holds to the JAX engine under the bars for MX ties
(ROADMAP "Decided"): greedy tokens equal on unpadded traffic, logits
within 1e-2 of max |logit|."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_engine_helpers import BENCH, checkpoint
from repro.artifacts import load_artifact as j_load
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.obs import MetricsRegistry as JRegistry
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import convert
from repro_torch.artifacts import export_artifact as t_export
from repro_torch.artifacts import load_artifact as t_load
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import ptq as tptq
from repro_torch.kernels import ops as tops
from repro_torch.kernels.packing import PackedWeight
from repro_torch.models import api as tapi
from repro_torch.obs import MetricsRegistry as TRegistry
from repro_torch.obs import Tracer as TTracer
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest

torch.set_num_threads(1)

KW = dict(batch_size=2, max_len=128, scheduler="continuous",
          kv_layout="paged", kv_cache="mxfp8")
PUBLIC = ("mx_quantize", "t3_quantize", "mx_gemm", "mx_gemm_packed",
          "mx_flash_decode", "mx_flash_decode_paged", "mx_flash_prefill")


def _traffic():
    """Two requests, no pads on the paged path."""
    rng = np.random.default_rng(21)
    return [(rng.integers(0, 512, n).astype(np.int32), m)
            for n, m in ((20, 5), (41, 4))]


def _dispatch(registry) -> dict:
    """{(name, op, traced): value} of the kernel-dispatch counters."""
    return {(m.name, m.labels["op"], m.labels["traced"]): m.value
            for m in registry if m.name.startswith("kernel_dispatch_")}


def _quant(registry) -> dict:
    return {(m.labels["op"], m.labels["path"], m.labels["role"]): m.value
            for m in registry if m.name == "quant_dispatch_total"}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """RTN mxint4 of the trained bench model, T3 on, exported by the port
    (the JAX package reads it; its own RTN and export take 12 s here)."""
    cfg = TArch(**BENCH)
    res = tptq.apply_method("rtn", convert.params_from_numpy(
        checkpoint(), device="cpu"), cfg, fmt="mxint4")
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    out = tmp_path_factory.mktemp("instrument") / "bench-mxint4"
    t_export(res, cfg, out)
    return out


@pytest.fixture(scope="module")
def jax_run(artifact):
    """The JAX engine's fused paged run, instrumented: (tokens, registry)."""
    reg = JRegistry()
    jops.instrument(reg)
    try:
        eng = JEngine.from_artifact(artifact, backend="fused", **KW)
        reqs = [JRequest(prompt=p, max_new=m) for p, m in _traffic()]
        eng.generate(reqs)
    finally:
        jops.uninstrument()
    return [np.asarray(r.out) for r in reqs], reg


def _port_run(artifact, monkeypatch, tracer=None):
    """The port's fused paged run on the CPU, instrumented, with each
    public wrapper's calls counted: (tokens, registry, calls)."""
    calls = dict.fromkeys(PUBLIC, 0)

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call
    for name in PUBLIC:
        monkeypatch.setattr(tops, name, counted(name, getattr(tops, name)))
    reg = TRegistry()
    eng = TEngine.from_artifact(artifact, backend="fused", device="cpu",
                                metrics=reg, tracer=tracer, **KW)
    reqs = [TRequest(prompt=p, max_new=m) for p, m in _traffic()]
    tops.reset_launches()
    tops.instrument(reg, tracer)
    try:
        eng.generate(reqs)
    finally:
        tops.uninstrument()
    return [r.out for r in reqs], reg, calls


def test_dispatch_metrics_match_jax_and_count_every_call(artifact, jax_run,
                                                         monkeypatch):
    _, jreg = jax_run
    _, treg, calls = _port_run(artifact, monkeypatch)
    got = _dispatch(treg)
    ops = {op for _, op, _ in got}
    assert ops == {op for _, op, _ in _dispatch(jreg)} == {
        "mx_gemm_packed", "mx_flash_prefill", "mx_flash_decode_paged"}
    assert {t for _, _, t in got} == {"false"}
    assert {op: got[("kernel_dispatch_calls_total", op, "false")]
            for op in ops} == {op: n for op, n in calls.items() if n}
    assert all(got[("kernel_dispatch_seconds_total", op, "false")] > 0
               for op in ops)
    quant = _quant(treg)
    assert set(quant) == set(_quant(jreg))
    assert quant == tops.quant_paths
    assert sum(n for (_, path, _), n in quant.items() if path == "fused") \
        == calls["mx_gemm_packed"]


def test_mxint4_engine_matches_jax(artifact, jax_run, monkeypatch):
    """Greedy tokens equal the JAX engine's (unpadded traffic); the
    artifact's logits under its serving mode within 1e-2 of max |logit|,
    the port's fused backend against the JAX package's reference."""
    jtoks, _ = jax_run
    ttoks, _, _ = _port_run(artifact, monkeypatch)
    for a, b in zip(ttoks, jtoks):
        np.testing.assert_array_equal(a, b)
    jp, jcfg, jqm = j_load(artifact)
    tp, tcfg, tqm = t_load(artifact, device="cpu", backend="fused")
    assert tqm.act_cfg.fmt == "mxint4"
    tokens = np.stack([p[:20] for p, _ in _traffic()])
    jl = np.asarray(jax.jit(lambda p, t: japi.forward(p, jcfg, t, jqm))(
        jp, jnp.asarray(tokens)))
    tl = tapi.forward(tp, tcfg, torch.as_tensor(tokens).long(), tqm).numpy()
    assert np.abs(tl - jl).max() <= 1e-2 * np.abs(jl).max()


def test_one_dispatch_span_per_call_and_nothing_after_uninstrument():
    """With a tracer each call leaves one ``dispatch:<op>`` complete event
    (cat ``kernel``); a call that raises propagates and records nothing;
    after :func:`uninstrument` nothing is recorded, though ``quant_paths``
    still counts."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 64, generator=g)
    w = PackedWeight.from_dense(torch.randn(64, 32, generator=g))
    reg, tracer = TRegistry(), TTracer()
    tops.instrument(reg, tracer)
    try:
        for _ in range(3):
            tops.mx_quantize(x, "mxint4")
        tops.t3_quantize(x)
        tops.mx_gemm_packed(x, w.codes_packed, w.scales_e8m0)
        tops.record_quant_path("qlinear", "ref", "qkv")
        with pytest.raises(ValueError, match="contract"):
            tops.mx_quantize(x[:, :40])
    finally:
        tops.uninstrument()
    spans = [e for e in tracer.events() if e["name"].startswith("dispatch:")]
    assert [e["name"] for e in spans] == ["dispatch:mx_quantize"] * 3 + [
        "dispatch:t3_quantize", "dispatch:mx_gemm_packed"]
    assert {e["cat"] for e in spans} == {"kernel"}
    got = _dispatch(reg)
    assert {k: v for k, v in got.items()
            if k[0] == "kernel_dispatch_calls_total"} == {
        ("kernel_dispatch_calls_total", "mx_quantize", "false"): 3,
        ("kernel_dispatch_calls_total", "t3_quantize", "false"): 1,
        ("kernel_dispatch_calls_total", "mx_gemm_packed", "false"): 1}
    assert _quant(reg) == {("qlinear", "ref", "qkv"): 1}
    n, before = len(reg), dict(tops.quant_paths)
    tops.mx_quantize(x)
    tops.record_quant_path("qlinear", "ref", "qkv")
    assert len(reg) == n and len(tracer.events()) == len(spans)
    assert tops.quant_paths[("qlinear", "ref", "qkv")] == \
        before.get(("qlinear", "ref", "qkv"), 0) + 1


def test_replicated_call_counts_once_under_its_own_name(tmp_path):
    """A ``DTensor`` operand takes ``on_whole``: one dispatch of the
    wrapper, one ("replicated") decision, the local call not counted
    again."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    reg = TRegistry()
    try:
        mesh = init_device_mesh("cpu", (1,))
        x = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
        tops.reset_launches()
        tops.instrument(reg)
        codes, _ = tops.mx_quantize(DTensor.from_local(x, mesh, [Shard(0)]))
    finally:
        tops.uninstrument()
        dist.destroy_process_group()
    assert torch.equal(codes.to_local(), tops.mx_quantize(x)[0])
    assert _dispatch(reg)[("kernel_dispatch_calls_total", "mx_quantize",
                           "false")] == 1
    assert _quant(reg) == tops.quant_paths == {
        ("mx_quantize", "replicated", ""): 1}


def _run_main(main, argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def test_launch_serve_eager_metrics_and_epilogue(artifact):
    """``--eager`` dequantizes at load as the JAX package does (the same
    dense weights, bitwise), so every linear routes ``ref``; ``--metrics``
    prints the dispatch metrics (the paged prefill kernel, no packed GEMM)
    and, as JAX's ``_obs_finish``, the spec-acceptance and latency
    lines; the wrappers are uninstrumented afterwards."""
    from repro_torch.launch import serve
    jp, _, _ = j_load(artifact, eager=True)
    tp, _, _ = t_load(artifact, eager=True, device="cpu")
    for name, wt in tp["blocks"].items():
        assert not isinstance(wt, PackedWeight)
        np.testing.assert_array_equal(wt.numpy(),
                                      np.asarray(jp["blocks"][name]))
    out = _run_main(serve.main, [
        "--artifact", str(artifact), "--eager", "--metrics", "--device",
        "cpu", "--scheduler", "continuous", "--kv-layout", "paged",
        "--spec-k", "2", "--requests", "2", "--prompt-len", "16",
        "--max-new", "4"])
    assert tops._instr is None
    assert any(s.startswith("speculative decoding: ") for s in out)
    assert any(s.startswith("latency: ttft p50=") for s in out)
    text = "\n".join(out)
    assert 'path="fused"' not in text and 'path="ref"' in text
    assert 'op="mx_gemm_packed"' not in text
    assert ('kernel_dispatch_calls_total{op="mx_flash_prefill",'
            'traced="false"}') in text


def test_serve_example_metrics_instrument_the_wrappers():
    from repro_torch.examples import serve
    out = _run_main(serve.main, [
        "--device", "cpu", "--batch", "2", "--new", "4", "--kv-cache",
        "mxfp8", "--kv-layout", "paged", "--metrics"])
    assert tops._instr is None
    text = "\n".join(out)
    assert ('kernel_dispatch_calls_total{op="mx_flash_decode_paged",'
            'traced="false"}') in text
    assert 'quant_dispatch_total{op="qlinear",path="ref",role="qkv"}' in text
