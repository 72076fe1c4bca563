"""The port's serving engine against the JAX engine: the same
shared-prefix requests through ``repro_torch`` (CPU, fused backend, paged
mxfp8 pool) and ``repro`` (reference backend) give the same greedy tokens
and the same schedule counters, and leave the allocator clean; the
engines' defaults agree; the entry point and the import rules hold. The
contiguous layout's engine tests are in test_torch_engine_contiguous.py."""
import dataclasses
import inspect
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.artifacts import export_artifact as j_export
from repro.configs.base import ArchConfig as JArch
from repro.core import ptq as jptq
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "experiments" / "bench_model" / "step_00000250" / "arrays.npz"
BENCH = dict(name="bench-llama", family="dense", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=4, head_dim=16, d_ff=352, vocab_size=512,
             attn_chunk=64)
COUNTERS = ("admitted", "decode_steps", "slot_steps", "prefill_chunk_steps",
            "prefill_lane_steps", "prefill_batched_steps",
            "prefix_hit_tokens", "useful_decode_tokens")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    with np.load(CKPT) as z:
        flat = {k[len("params/"):]: jnp.asarray(z[k]) for k in z.files
                if k.startswith("params/")}
    params = {"blocks": {}}
    for key, v in flat.items():
        if key.startswith("blocks/"):
            params["blocks"][key[len("blocks/"):]] = v
        else:
            params[key] = v
    cfg = JArch(**BENCH)
    res = jptq.apply_method("rtn", params, cfg, calib=[])
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    out = tmp_path_factory.mktemp("engine") / "bench-mxfp4"
    j_export(res, cfg, out)
    return out


def _prompts():
    """Two requests share a 64-token prefix (one chunk), two do not, and a
    fifth is exactly the first 128 prompt tokens of the first: with
    128-token pages it resumes inside a cached page (copy-on-write)."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 512, 128).astype(np.int32)
    ps = [np.concatenate([prefix, rng.integers(0, 512, 20).astype(np.int32)]),
          np.concatenate([prefix[:64],
                          rng.integers(0, 512, 45).astype(np.int32)])]
    ps += [rng.integers(0, 512, t).astype(np.int32) for t in (30, 90)]
    return ps + [prefix.copy()]


@pytest.mark.parametrize("page_size", (None, 128))
def test_engine_matches_jax_engine(artifact, page_size):
    kw = dict(batch_size=4, max_len=192, scheduler="continuous",
              kv_layout="paged", kv_cache="mxfp8", page_size=page_size)
    jeng = JEngine.from_artifact(artifact, backend="ref", **kw)
    teng = TEngine.from_artifact(artifact, backend="fused", device="cpu",
                                 **kw)
    jreqs = [JRequest(prompt=p, max_new=12) for p in _prompts()]
    treqs = [TRequest(prompt=p, max_new=12) for p in _prompts()]
    jeng.generate(jreqs)
    teng.generate(treqs)
    for a, b in zip(treqs, jreqs):
        assert a.state.value == b.state.value == "finished"
        np.testing.assert_array_equal(a.out, b.out)
    js, ts = jeng.stats(), teng.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["prefix_hit_tokens"] > 0
    assert teng._alloc.check()["in_use"] == 0
    assert teng.kv_bytes_resident() == jeng.kv_bytes_resident()


def test_engine_never_fit_and_counters(artifact):
    eng = TEngine.from_artifact(artifact, backend="fused", device="cpu",
                                batch_size=2, max_len=128, kv_cache="mxfp8",
                                scheduler="continuous", kv_layout="paged")
    big = TRequest(prompt=np.zeros(120, np.int32), max_new=20)
    ok = TRequest(prompt=np.arange(10, dtype=np.int32), max_new=3)
    eng.generate([big, ok])
    assert big.state.value == "failed" and "never fit" in big.error
    assert ok.state.value == "finished" and len(ok.out) == 3
    st = eng.stats()
    assert st["rejected_never_fit"] == 1
    assert st["terminal"] == {"finished": 1, "cancelled": 0, "timed_out": 0,
                              "failed": 1, "preempted": 0, "shed": 0}
    eng._alloc.check()


def test_engine_defaults_match_jax_engine():
    """``Engine(params, cfg, qm)`` serves the same way in both packages:
    every keyword both signatures share has the same default."""
    for jf, tf in ((JEngine.__init__, TEngine.__init__),
                   (JEngine.from_artifact, TEngine.from_artifact)):
        jp = inspect.signature(jf).parameters
        tp = inspect.signature(tf).parameters
        shared = [k for k in tp if k in jp and k not in ("self", "device")]
        assert {"scheduler", "kv_layout"} <= set(shared)
        assert {k: tp[k].default for k in shared} == \
            {k: jp[k].default for k in shared}


def test_serve_entry_point_on_the_cpu(artifact, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--artifact", str(artifact), "--device", "cpu",
                       "--requests", "3", "--prompt-len", "20",
                       "--max-new", "4"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["tokens"] == 12 and res["device"] == "cpu"
    assert res["backend"] == "fused" and res["kv_cache"] == "mxfp8"
    assert res["admitted"] == 3 and res["terminal"]["finished"] == 3


def test_serve_entry_point_lifecycle_trace_and_metrics(artifact, capsys,
                                                       tmp_path):
    """The lifecycle, trace and metrics flags reach the engine: the run
    finishes under a far deadline and a roomy queue cap, the trace it
    exports validates, and the Prometheus text carries the lifecycle
    counters and the JAX package's kernel-dispatch metrics: one
    ``mx_gemm_packed`` dispatch (``traced="false"``: the port traces
    nothing) per fused ``qlinear`` decision."""
    from repro_torch.launch import serve
    from repro_torch.obs import validate_trace
    trace = tmp_path / "serve_trace.json"
    assert serve.main(["--artifact", str(artifact), "--device", "cpu",
                       "--scheduler", "continuous", "--kv-layout", "paged",
                       "--requests", "3", "--prompt-len", "20",
                       "--max-new", "4", "--deadline-ms", "1e7",
                       "--ttft-deadline-ms", "1e7", "--max-retries", "1",
                       "--no-preemption", "--max-queue-depth", "8",
                       "--admit-token-budget", "4096", "--trace",
                       str(trace), "--metrics"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    res = json.loads(out[-1])
    assert res["terminal"]["finished"] == 3 and res["preemptions"] == 0
    names = {e["name"] for e in validate_trace(str(trace))}
    assert {"engine_step", "admit", "decode_burst", "request"} <= names
    text = "\n".join(out)
    assert "serving_requests_shed_total 0" in text
    metric = {}
    for line in out:
        if line.startswith(("kernel_dispatch_calls_total{",
                            "quant_dispatch_total{")):
            name, value = line.rsplit(" ", 1)
            metric[name] = float(value)
    gemms = metric['kernel_dispatch_calls_total{op="mx_gemm_packed",'
                   'traced="false"}']
    fused = sum(v for k, v in metric.items()
                if k.startswith('quant_dispatch_total{op="qlinear",'
                                'path="fused",'))
    assert gemms == fused > 0
    assert 'quant_dispatch_total{op="qlinear",path="fused",role="qkv"}' \
        in metric


def test_port_imports_no_jax_and_defaults_to_the_card():
    """Every repro_torch module imports without loading jax or any repro.*
    module, and the entry points asked for no device (the engine, both
    cache constructors, a fresh packed KV cache, the demo engine, the
    HTTP server and its command line) raise without a card."""
    code = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "repro.")) or k == "repro")
assert not bad, bad
import torch
from repro_torch import configs
from repro_torch.core.quantize import QuantMode
from repro_torch.kernels.packing import PackedKV
from repro_torch.models import api
from repro_torch.serving.engine import Engine
from repro_torch.serving import server
from repro_torch.launch import serve
cfg = configs.get_reduced("qwen2-0.5b")
if not torch.cuda.is_available():
    for name, call in (
            ("Engine", lambda: Engine({}, cfg, QuantMode.off())),
            ("init_cache", lambda: api.init_cache(cfg, 1, 64)),
            ("init_cache_paged", lambda: api.init_cache_paged(cfg, 2, 64)),
            ("PackedKV.zeros", lambda: PackedKV.zeros((1, 64, 64))),
            ("demo_engine", lambda: server.demo_engine()),
            ("Server", lambda: server.Server()),
            ("server.main", lambda: server.main(["--port", "0"])),
            ("launch.serve --http", lambda: serve.main(
                ["--artifact", "absent", "--http", "127.0.0.1:0"]))):
        try:
            call()
        except RuntimeError as e:
            assert "device" in str(e), (name, e)
        else:
            raise AssertionError(f"{name} ran on the CPU without being asked")
print("ok")
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ("PagedKV.zeros", "params_from_numpy"))
def test_pool_and_weight_constructors_default_to_the_card(monkeypatch,
                                                          entry):
    """A fresh paged pool and a parameter tree handed over from numpy land
    on the card unless the caller names a device: with no card they raise
    instead of running on the CPU."""
    import torch

    from repro_torch import convert
    from repro_torch.kernels.packing import PagedKV
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"PagedKV.zeros": lambda: PagedKV.zeros((2, 16, 64), "mxfp8"),
            "params_from_numpy": lambda: convert.params_from_numpy(
                {"embed": np.zeros((4, 8), np.float32)})}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
