"""The port's serving engine on the contiguous KV layout against the JAX
engine, on the mxfp4 artifact of the bench checkpoint (weights and
activations MX-quantized, T3 on), exported by the JAX package: greedy
tokens where no lane carries a pad, and on left-padded traffic the
schedule counters, the resident KV bytes and the port's fused tokens
against its reference tokens."""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_engine_helpers import (BENCH, CONTIGUOUS_CASES, case_id,
                                   checkpoint, flat_traffic, jax_tree,
                                   ragged_traffic, same_schedule, serve)

from repro.artifacts import export_artifact as j_export
from repro.artifacts import load_artifact as j_load
from repro.configs.base import ArchConfig as JArch
from repro.core import ptq as jptq
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.artifacts import load_artifact as t_load
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The bench model, RTN mxfp4 by the JAX package with the T3 rotation
    on, exported by the JAX package."""
    cfg = JArch(**BENCH)
    res = jptq.apply_method("rtn", jax_tree(checkpoint()), cfg, calib=[])
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    out = tmp_path_factory.mktemp("engine") / "bench-mxfp4"
    j_export(res, cfg, out)
    return out


UNPADDED_CASES = [
    (dict(scheduler=s, bucket_prompts=b, kv_cache=kv), traffic)
    for s, b, traffic in (("wave", True, flat_traffic),
                          ("wave", False, flat_traffic),
                          ("continuous", False, ragged_traffic))
    for kv in ("none", "mxfp8")]


@pytest.mark.parametrize("backend", ("ref", "fused"))
@pytest.mark.parametrize("case,traffic", UNPADDED_CASES,
                         ids=lambda c: case_id(c) if isinstance(c, dict)
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
    jreqs = serve(jeng, JRequest, traffic)
    treqs = serve(teng, TRequest, traffic)
    same_schedule(teng, treqs, jeng, jreqs)
    for a, b in zip(treqs, jreqs):
        np.testing.assert_array_equal(a.out, b.out)


@pytest.mark.parametrize("case", CONTIGUOUS_CASES, ids=case_id)
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
    jreqs = serve(jeng, JRequest)
    outs = {}
    for backend in ("ref", "fused"):
        teng = TEngine(*t_load(artifact, device="cpu"), backend=backend,
                       device="cpu", **kw)
        outs[backend] = serve(teng, TRequest)
        same_schedule(teng, outs[backend], jeng, jreqs)
    for a, b in zip(outs["fused"], outs["ref"]):
        np.testing.assert_array_equal(a.out, b.out)
