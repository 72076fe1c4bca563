"""The port's serving engine on the contiguous KV layout against the JAX
engine, under the wave and the continuous scheduler: the same requests
through ``repro_torch`` (CPU) and ``repro`` give the same greedy tokens,
schedule counters and resident KV bytes."""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.artifacts import export_artifact as j_export
from repro.artifacts import load_artifact as j_load
from repro.configs.base import ArchConfig as JArch
from repro.core import ptq as jptq
from repro.core.quantize import QuantMode as JQM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import convert
from repro_torch.artifacts import load_artifact as t_load
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "experiments" / "bench_model" / "step_00000250" / "arrays.npz"
BENCH = dict(name="bench-llama", family="dense", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=4, head_dim=16, d_ff=352, vocab_size=512,
             attn_chunk=64)
COUNTERS = ("admitted", "decode_steps", "slot_steps", "prefill_chunk_steps",
            "prefill_lane_steps", "prefill_batched_steps",
            "prefix_hit_tokens", "useful_decode_tokens")


def _checkpoint():
    """The trained bench model as a nested dict of numpy leaves."""
    with np.load(CKPT) as z:
        flat = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
    tree = {"blocks": {}}
    for key, v in flat.items():
        if key.startswith("blocks/"):
            tree["blocks"][key[len("blocks/"):]] = v
        else:
            tree[key] = v
    return tree


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.fixture(scope="module")
def bench_params():
    tree = _checkpoint()
    return _jax_tree(tree), convert.params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def artifact(bench_params, tmp_path_factory):
    """The bench model, RTN mxfp4 by the JAX package with the T3 rotation
    on, exported by the JAX package."""
    cfg = JArch(**BENCH)
    res = jptq.apply_method("rtn", bench_params[0], cfg, calib=[])
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    out = tmp_path_factory.mktemp("engine") / "bench-mxfp4"
    j_export(res, cfg, out)
    return out


def _ragged_traffic():
    """Five requests over four lanes: ragged prompt lengths (one longer
    than a chunk), so most lanes carry left pads under both schedulers,
    and budgets that end at different steps."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 512, t).astype(np.int32), m)
            for t, m in zip((20, 70, 5, 130, 33), (12, 9, 12, 40, 1))]


def _flat_traffic():
    """Five requests of one chunk each (64 tokens) over four lanes: no
    lane carries a pad under either scheduler, bucketed or not."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 512, 64).astype(np.int32), m)
            for m in (12, 9, 12, 40, 1)]


def _serve(eng, Request, traffic=_ragged_traffic):
    reqs = [Request(prompt=p, max_new=m) for p, m in traffic()]
    eng.generate(reqs)
    return reqs


def _same_schedule(teng, treqs, jeng, jreqs):
    for a, b in zip(treqs, jreqs):
        assert a.state.value == b.state.value == "finished"
        assert len(a.out) == len(b.out)
    js, ts = jeng.stats(), teng.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert teng.kv_bytes_resident() == jeng.kv_bytes_resident()


CONTIGUOUS_CASES = [
    dict(scheduler=s, bucket_prompts=b, kv_cache=kv)
    for s, b in (("wave", True), ("wave", False), ("continuous", True))
    for kv in ("none", "mxfp8")]


def _case_id(c):
    return "-".join(str(c[k]) for k in ("scheduler", "bucket_prompts",
                                        "kv_cache"))


@pytest.mark.parametrize("backend", ("ref", "fused"))
@pytest.mark.parametrize("case", CONTIGUOUS_CASES, ids=_case_id)
def test_contiguous_engine_matches_jax_engine(bench_params, case, backend):
    """Contiguous layout, wave and continuous scheduler, the trained f32
    checkpoint, the same backend on both sides, left-padded ragged
    traffic: greedy tokens, schedule counters and resident KV bytes equal
    the JAX engine's."""
    jparams, tparams = bench_params
    kw = dict(batch_size=4, max_len=192, kv_layout="contiguous",
              backend=backend, **case)
    jeng = JEngine(jparams, JArch(**BENCH), JQM.off(), **kw)
    teng = TEngine(tparams, TArch(**BENCH), TQM.off(), device="cpu", **kw)
    jreqs, treqs = _serve(jeng, JRequest), _serve(teng, TRequest)
    _same_schedule(teng, treqs, jeng, jreqs)
    for a, b in zip(treqs, jreqs):
        np.testing.assert_array_equal(a.out, b.out)


UNPADDED_CASES = [
    (dict(scheduler=s, bucket_prompts=b, kv_cache=kv), traffic)
    for s, b, traffic in (("wave", True, _flat_traffic),
                          ("wave", False, _flat_traffic),
                          ("continuous", False, _ragged_traffic))
    for kv in ("none", "mxfp8")]


@pytest.mark.parametrize("backend", ("ref", "fused"))
@pytest.mark.parametrize("case,traffic", UNPADDED_CASES,
                         ids=lambda c: _case_id(c) if isinstance(c, dict)
                         else c.__name__.strip("_"))
def test_contiguous_artifact_engine_matches_jax_engine(artifact, case,
                                                       traffic, backend):
    """The mxfp4 artifact (weights and activations MX-quantized) on the
    contiguous layout, traffic that puts no pad in any lane (one-chunk
    prompts for the wave, unbucketed placement for the continuous
    scheduler), the same backend on both sides: greedy tokens, schedule
    counters and resident KV bytes equal the JAX engine's, with a dense
    and with an mxfp8 cache."""
    kw = dict(batch_size=4, max_len=192, kv_layout="contiguous",
              backend=backend, **case)
    jeng = JEngine(*j_load(artifact), **kw)
    teng = TEngine(*t_load(artifact, device="cpu"), device="cpu", **kw)
    jreqs = _serve(jeng, JRequest, traffic)
    treqs = _serve(teng, TRequest, traffic)
    _same_schedule(teng, treqs, jeng, jreqs)
    for a, b in zip(treqs, jreqs):
        np.testing.assert_array_equal(a.out, b.out)


@pytest.mark.parametrize("case", CONTIGUOUS_CASES, ids=_case_id)
def test_contiguous_artifact_engine_matches_jax_schedule(artifact, case):
    """The mxfp4 artifact on the contiguous layout with left-padded
    ragged traffic: the schedule counters and resident KV bytes equal the
    JAX engine's, and the port's fused path (the kernels' plain versions)
    gives its reference path's tokens. Tokens are not compared across the
    packages on this traffic: a pad's attention output sits within an ulp
    of an MX snap midpoint, and the last bit of each package's f32 sum
    decides the code (ROADMAP Queue 3,
    ``test_torch_model.py::test_artifact_parts_from_jax_only_at_ulp_ties``);
    the test above holds the tokens without pads, and with the f32
    checkpoint the tokens are equal on this traffic too."""
    kw = dict(batch_size=4, max_len=192, kv_layout="contiguous", **case)
    jeng = JEngine(*j_load(artifact), backend="ref", **kw)
    jreqs = _serve(jeng, JRequest)
    outs = {}
    for backend in ("ref", "fused"):
        teng = TEngine(*t_load(artifact, device="cpu"), backend=backend,
                       device="cpu", **kw)
        outs[backend] = _serve(teng, TRequest)
        _same_schedule(teng, outs[backend], jeng, jreqs)
    for a, b in zip(outs["fused"], outs["ref"]):
        np.testing.assert_array_equal(a.out, b.out)
