"""A LATMiX artifact through both packages, on the CPU.

The JAX package's ``latmix-lu`` artifact of the trained bench checkpoint
(3 steps, T3, mxfp4: every linear but ``wd`` carries a bias, the head is
untied and has ``bhead``, T2 is folded per head into ``wv`` and ``wo``)
served by the port's engine on all three paths under both backends
(tests/test_torch_ptq_cli.py holds the port's own artifact in the JAX
package, and the CLI).

Bars (ROADMAP Queue 3, "MX ties"): greedy tokens, schedule counters and
resident KV bytes equal the JAX engine's on traffic that puts no pad in a
lane; on left-padded traffic the counters and bytes equal the JAX
engine's and the port's fused tokens its reference tokens; logits within
1e-2 of max |logit|."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_engine_helpers import (BENCH, checkpoint, flat_traffic,
                                   jax_tree, ragged_traffic, same_schedule,
                                   serve)

from repro.artifacts import export_artifact as j_export
from repro.artifacts import load_artifact as j_load
from repro.configs.base import ArchConfig as JArch
from repro.core import ptq as jptq
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.artifacts import load_artifact as t_load
from repro_torch.models import api as tapi
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

PATHS = (("wave", "contiguous"), ("continuous", "contiguous"),
         ("continuous", "paged"))


def _calib():
    src = jsyn.make_source(JArch(**BENCH), 4, 64, 0)
    return [src.batch(i) for i in range(2)]


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    cfg = JArch(**BENCH)
    calib = [{k: jnp.asarray(v) for k, v in b.items()} for b in _calib()]
    res = jptq.apply_method("latmix-lu", jax_tree(checkpoint()), cfg, calib,
                            steps=3)
    out = tmp_path_factory.mktemp("ptq") / "bench-latmix-lu"
    j_export(res, cfg, out)
    return out


def _kw(sched, layout, backend):
    kw = dict(batch_size=4, max_len=192, scheduler=sched, kv_layout=layout,
              kv_cache="mxfp8", backend=backend)
    if layout == "contiguous":
        kw["bucket_prompts"] = sched == "wave"
    return kw


def test_latmix_artifact_carries_the_folds(jax_artifact):
    params, _, qm = t_load(jax_artifact, device="cpu")
    assert qm.t3_block == 32 and qm.act_cfg.fmt == "mxfp4"
    assert {"bq", "bk", "bv", "bo", "bg", "bu"} <= set(params["blocks"])
    assert "bd" not in params["blocks"]
    assert {"head", "bhead", "embed"} <= set(params)
    assert params["bhead"].abs().max() > 0


@pytest.mark.parametrize("sched,layout", PATHS)
def test_latmix_artifact_engine_matches_jax_engine(jax_artifact, sched,
                                                   layout):
    """Unpadded traffic: the port's tokens under both backends, its
    counters and KV bytes equal the JAX engine's (reference backend: the
    JAX fused path runs its Pallas kernels in interpret mode here)."""
    jeng = JEngine(*j_load(jax_artifact), **_kw(sched, layout, "ref"))
    jreqs = serve(jeng, JRequest, flat_traffic)
    for backend in ("ref", "fused"):
        teng = TEngine(*t_load(jax_artifact, device="cpu"), device="cpu",
                       **_kw(sched, layout, backend))
        treqs = serve(teng, TRequest, flat_traffic)
        same_schedule(teng, treqs, jeng, jreqs)
        for a, b in zip(treqs, jreqs):
            np.testing.assert_array_equal(a.out, b.out)


@pytest.mark.parametrize("sched,layout", (PATHS[0], PATHS[2]))
def test_latmix_artifact_padded_schedule_matches_jax(jax_artifact, sched,
                                                     layout):
    """Left-padded ragged traffic on the default path and the paged one:
    counters and KV bytes equal the JAX engine's, and the port's fused
    tokens equal its reference tokens."""
    jeng = JEngine(*j_load(jax_artifact), **_kw(sched, layout, "ref"))
    jreqs = serve(jeng, JRequest, ragged_traffic)
    outs = {}
    for backend in ("ref", "fused"):
        teng = TEngine(*t_load(jax_artifact, device="cpu"), device="cpu",
                       **_kw(sched, layout, backend))
        outs[backend] = serve(teng, TRequest, ragged_traffic)
        same_schedule(teng, outs[backend], jeng, jreqs)
    for a, b in zip(outs["fused"], outs["ref"]):
        np.testing.assert_array_equal(a.out, b.out)


def _logits(tparams, tcfg, tqm, jparams, jcfg, jqm, toks):
    t = tapi.forward(tparams, tcfg, torch.from_numpy(toks), tqm).numpy()
    j = np.asarray(japi.forward(jparams, jcfg, jnp.asarray(toks), jqm))
    return t, j


@pytest.mark.parametrize("backend", ("ref", "fused"))
def test_latmix_artifact_logits_match_jax(jax_artifact, backend):
    tp, tc, tq = t_load(jax_artifact, device="cpu", backend=backend)
    jp, jc, jq = j_load(jax_artifact, backend=backend)
    toks = _calib()[1]["inputs"][:2]
    t, j = _logits(tp, tc, tq, jp, jc, jq, toks)
    np.testing.assert_allclose(t, j, atol=1e-2 * np.abs(j).max())
