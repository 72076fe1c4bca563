"""The port's serving engine on the contiguous KV layout against the JAX
engine, under the wave and the continuous scheduler, on the trained f32
bench checkpoint: the same requests through ``repro_torch`` (CPU) and
``repro`` give the same greedy tokens, schedule counters and resident KV
bytes. The mxfp4 artifact's cases are in
test_torch_engine_contiguous_artifact.py (a file of their own, so that
parallel runs place the two halves on two workers)."""
import numpy as np
import pytest
import torch
from _torch_engine_helpers import (BENCH, CONTIGUOUS_CASES, case_id,
                                   checkpoint, jax_tree, same_schedule,
                                   serve)

from repro.configs.base import ArchConfig as JArch
from repro.core.quantize import QuantMode as JQM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import convert
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bench_params():
    tree = checkpoint()
    return jax_tree(tree), convert.params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("backend", ("ref", "fused"))
@pytest.mark.parametrize("case", CONTIGUOUS_CASES, ids=case_id)
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
    jreqs, treqs = serve(jeng, JRequest), serve(teng, TRequest)
    same_schedule(teng, treqs, jeng, jreqs)
    for a, b in zip(treqs, jreqs):
        np.testing.assert_array_equal(a.out, b.out)
