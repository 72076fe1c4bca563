"""``Engine.reset_stats()`` and the ``window`` block of ``stats()`` in the
port, against the JAX engine.

Both engines serve the same numpy-seeded traffic on the JAX tests' small
f32 model (``PRNGKey(0)``), in two waves with a ``reset_stats()`` between
them, on the wave scheduler, the continuous scheduler over the contiguous
cache, and the continuous scheduler over the paged pool under
speculative decoding (k = 2; the second wave shares a page-long prefix
with the first, so prefix hits fall inside the window).
Stated tolerance: equal. The port's ``window`` equals the JAX engine's key
by key; it equals the second wave's deltas of the flat counters, which
stay cumulative; the latency histograms are not reset; and
``throughput()``'s per-run ``window`` equals the JAX engine's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArch
from repro.core.quantize import QuantMode as JQM
from repro.models import api as japi
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.policy import SpecConfig as JSpec
from repro_torch import convert
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.policy import SpecConfig as TSpec

torch.set_num_threads(1)

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, attn_chunk=16)
CASES = {"wave": dict(scheduler="wave"),
         "continuous": dict(scheduler="continuous"),
         "paged_spec": dict(scheduler="continuous", kv_layout="paged",
                            page_size=32, n_pages=8)}


@pytest.fixture(scope="module")
def params():
    jp = japi.init(jax.random.PRNGKey(0), JArch(**TINY))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _waves(Request):
    """Two waves of four requests; the second's prompts share a 32-token
    prefix with one another and with the first wave's third request."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, TINY["vocab_size"], 32).astype(np.int32)
    first = [rng.integers(0, TINY["vocab_size"], n).astype(np.int32)
             for n in (9, 21, 5, 17)]
    first[2] = np.concatenate([prefix, first[2]])
    second = [np.concatenate([prefix, rng.integers(0, TINY["vocab_size"], n)
                              .astype(np.int32)]) for n in (4, 11, 7, 2)]
    return ([Request(prompt=p, max_new=m) for p, m in zip(first,
                                                          (6, 3, 8, 5))],
            [Request(prompt=p, max_new=m) for p, m in zip(second,
                                                          (7, 2, 5, 9))])


def _run(Engine, Request, Spec, p, cfg, qm, case, **kw):
    args = dict(CASES[case])
    if case == "paged_spec":
        args["spec"] = Spec(k=2)
    eng = Engine(p, cfg, qm, batch_size=2, max_len=64, **args, **kw)
    first, second = _waves(Request)
    eng.generate(first)
    mid = eng.stats()
    eng.reset_stats()
    just_reset = eng.stats()
    eng.generate(second)
    end = eng.stats()
    run = eng.throughput(n_requests=3, prompt_len=12, max_new=4)
    return mid, just_reset, end, run, [list(r.out) for r in first + second]


@pytest.mark.parametrize("case", list(CASES))
def test_window_equals_the_jax_engine(params, case):
    jp, tp = params
    jmid, jreset, jend, jrun, jtoks = _run(JEngine, JRequest, JSpec, jp,
                                           JArch(**TINY), JQM.off(), case)
    tmid, treset, tend, trun, ttoks = _run(TEngine, TRequest, TSpec, tp,
                                           TArch(**TINY), TQM.off(), case,
                                           device="cpu")
    assert ttoks == jtoks
    keys = TEngine._WINDOW_KEYS
    assert keys == JEngine._WINDOW_KEYS
    # key by key against the JAX engine, at every reading
    for t, j in ((tmid, jmid), (treset, jreset), (tend, jend),
                 (trun, jrun)):
        assert t["window"] == j["window"]
    # before any reset the window is the whole run; just after, zero
    assert tmid["window"] == {**{k: tmid[k] for k in keys},
                              "decode_utilization":
                                  tmid["decode_utilization"],
                              "spec_acceptance": tmid["spec_acceptance"]}
    assert all(treset["window"][k] == 0 for k in keys)
    # the window is the second wave's deltas; the flat keys stay cumulative
    w = tend["window"]
    assert {k: w[k] for k in keys} == {k: tend[k] - tmid[k] for k in keys}
    assert w["decode_steps"] > 0 and tend["decode_steps"] > w["decode_steps"]
    assert w["decode_utilization"] == (w["useful_decode_tokens"]
                                       / w["slot_steps"])
    if case == "paged_spec":
        assert w["spec_proposed_tokens"] > 0 and w["prefix_hit_tokens"] > 0
        assert w["spec_acceptance"] == (w["spec_accepted_tokens"]
                                        / w["spec_proposed_tokens"])
    # histograms and gauges are not reset
    assert treset["ttft_p50"] == tmid["ttft_p50"] is not None
    assert treset["blocks_in_use"] == tmid["blocks_in_use"]
    # throughput(): the run's own counters, in the flat keys and window
    assert {k: trun["window"][k] for k in keys} == {k: trun[k] for k in keys}
    assert trun["window"]["decode_utilization"] == trun["decode_utilization"]
