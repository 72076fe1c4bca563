"""Tables 1, 2 and 8 of the paper's experiments in the port
(``repro_torch.paper``) against the JAX package's (``benchmarks/``), on the
CPU, on the trained bench model (the functions below each ``run()``; the
JAX ``emit`` writes into ``experiments/benchmarks/``). One file, so both
packages' bench models are set up once for all rows. Bars, and why:

- Table 1's ``fp``, ``rtn`` and ``gptq`` rows in both formats: perplexity
  within 1e-3 relative, the zero-shot proxy's accuracy equal;
- a learned row each of Tables 1 (``latmix-lu``, mxfp4), 2 (LATMiX-LU at
  block granularity) and 8 (the CE loss), at 2 steps: perplexity within
  2e-2 relative (``tests/test_torch_latmix.py``'s bar for losses after
  the first Adam update, where two runs part like runs on inputs an ulp
  apart).
"""
import jax.numpy as jnp
import pytest
import torch
from _torch_paper_helpers import data, models  # noqa: F401

from repro.core import gptq as jgptq
from repro.core import latmix as jlx
from repro.core import mx as jmx
from repro.core import ptq as jptq
from repro.core.quantize import QuantMode as JQM
from repro.models import api as japi
from repro_torch.models import api as tapi
from repro_torch.paper import (table1_methods, table2_granularity,
                               table8_ablations)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def teachers(models, data):
    """The FP model's logits on the evaluation batches, both packages."""
    jp, tp, cfg, tcfg = models
    return (table1_methods.teacher_logits(tp, tcfg, data["ev_batches"]),
            [japi.forward(jp, cfg, jnp.asarray(b["inputs"]))
             for b in data["ev_batches"]])


@pytest.mark.parametrize("method,fmt", [("fp", "mxfp4"), ("rtn", "mxfp4"),
                                        ("gptq", "mxfp4"), ("rtn", "mxint4"),
                                        ("gptq", "mxint4")])
def test_table1_rows_equal_jax(models, data, teachers, method, fmt):
    jp, tp, cfg, tcfg = models
    ppl, acc, _ = table1_methods.method_row(
        method, tp, tcfg, data["calib"], data["ev"], data["ev_batches"],
        teachers[0], fmt)
    res = jptq.apply_method(method, jp, cfg, data["jcalib"], fmt=fmt)
    want = jptq.eval_ppl(res, cfg, data["jev"])
    assert abs(ppl - want) <= 1e-3 * want
    assert acc == jptq.zero_shot_proxy(res, cfg, data["ev_batches"],
                                       teacher_logits=teachers[1])


def _jax_rtn_ppl(jp, cfg, tset, t3, ev):
    mxcfg = jmx.MXConfig(fmt="mxfp4", block_size=32)
    qp = jgptq.quantize_weights_rtn(japi.fold(jp, cfg, tset), cfg, mxcfg)
    return japi.perplexity(qp, cfg, ev, JQM(enabled=True, act_cfg=mxcfg,
                                            t3_block=t3))


@pytest.mark.parametrize("table", ["table2", "table8"])
def test_learned_row_equals_jax(models, data, table):
    jp, tp, cfg, tcfg = models
    steps = 2
    if table == "table2":
        got = table2_granularity.variant_ppl(
            tp, tcfg, data["calib"], data["ev"], "lu", True, "block", steps)
        lx = jlx.LatmixConfig(kind="lu", learn_bias=True, steps=steps,
                              granularity="block")
    else:
        got = table8_ablations.ablation_ppl(tapi.fold_norms(tp, tcfg), tcfg,
                                            data["ev"], steps, loss="ce")
        lx = jlx.LatmixConfig(kind="lu", steps=steps, loss="ce")
    jpn = japi.fold_norms(jp, cfg)
    _, tset, _ = jlx.learn_transforms(jpn, cfg, lx, data["jcalib"])
    want = _jax_rtn_ppl(jpn, cfg, tset, lx.t3_block, data["jev"])
    assert abs(got - want) <= 2e-2 * want


def test_table1_learned_row_equals_jax(models, data):
    jp, tp, cfg, tcfg = models
    ppl, _, _ = table1_methods.method_row(
        "latmix-lu", tp, tcfg, data["calib"], data["ev"],
        data["ev_batches"], None, "mxfp4", 2)
    res = jptq.apply_method("latmix-lu", jp, cfg, data["jcalib"],
                            fmt="mxfp4", steps=2)
    want = jptq.eval_ppl(res, cfg, data["jev"])
    assert abs(ppl - want) <= 2e-2 * want
