"""The port's examples and CI smokes (``repro_torch.examples``,
``repro_torch.scripts``) on the CPU, against the JAX package's
(``examples/``, ``scripts/``).

- The four chaos scenarios run in both packages on the same f32 weights
  (the JAX smoke's ``PRNGKey(0)`` init, carried across as numpy; the JAX
  supervisor's worker starts after the submits, as the port's does). Every
  request each scenario makes ends in the JAX smoke's terminal state with
  its tokens (stated tolerance: equal; greedy on f32 weights), every
  engine's lifecycle counters equal, and the lifecycle trace carries the
  same instants.
- ``server_smoke`` boots the port's server as a subprocess and exits 0.
- ``artifact_report`` prints the JAX report's lines for an artifact the
  JAX package exports here.
- Each example runs at a tiny size: quickstart, train_lm, latmix_ptq
  (export included; the artifact then served by the serve example on
  both layouts) and serve on the demo model.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch
from _torch_paper_helpers import ROOT, jax_jitted

from scripts import artifact_report as jreport
from scripts import chaos_smoke as jchaos
from repro.core import ptq as jptq
from repro.models import api as japi
from repro_torch import convert
from repro_torch.examples import (latmix_ptq, quickstart, serve,
                                  train_lm)
from repro_torch.scripts import artifact_report, chaos_smoke
from repro_torch.scripts import server_smoke

torch.set_num_threads(1)

COUNTERS = ("submitted", "terminal", "preemptions", "nan_guard_trips",
            "rejected_never_fit", "admitted")


@pytest.fixture(autouse=True, scope="module")
def _jitted():
    """The JAX package's PTQ, packing and forward functions under
    ``jax.jit`` (``_torch_paper_helpers.jax_jitted``)."""
    with jax_jitted():
        yield


def _observe(mod, monkeypatch):
    """Record every request and engine a smoke module makes."""
    reqs, engines = [], []
    make_req, Engine = mod._req, mod.Engine

    def req(*a, **k):
        reqs.append(make_req(*a, **k))
        return reqs[-1]

    class Recorded(Engine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)
    monkeypatch.setattr(mod, "_req", req)
    monkeypatch.setattr(mod, "Engine", Recorded)
    return reqs, engines


class _StartsWhenPolled(jchaos.EngineSupervisor):
    """The JAX smoke's supervisor with its worker started at the first
    ``idle()`` poll, after every submit (the port's smoke submits before
    ``start()``): a worker running from ``start()`` may admit the victim
    before the third submit, which then does not shed."""

    def start(self):
        self._deferred = True

    def idle(self):
        if getattr(self, "_deferred", False):
            self._deferred = False
            super().start()
        return super().idle()


def _outcome(reqs, engines):
    # the JAX engine's ``compile:*`` instants have no counterpart (the port
    # compiles nothing)
    instants = sorted({e["name"] for eng in engines if eng.tracer is not None
                       for e in eng.tracer.events() if e.get("ph") == "i"
                       and not e["name"].startswith("compile:")})
    return ([(r.state.value, [int(t) for t in r.out]) for r in reqs],
            [{k: eng.stats()[k] for k in COUNTERS} for eng in engines],
            instants)


@pytest.mark.parametrize("name", ["scenario_lifecycle",
                                  "scenario_nan_isolation",
                                  "scenario_corruption",
                                  "scenario_server_supervisor"])
def test_chaos_scenario_equals_jax(name, monkeypatch, capsys):
    jp = japi.init(jax.random.PRNGKey(0), jchaos.CFG)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with monkeypatch.context() as m:
        jreqs, jengs = _observe(jchaos, m)
        m.setattr(jchaos, "EngineSupervisor", _StartsWhenPolled)
        getattr(jchaos, name)(jp)
        want = _outcome(jreqs, jengs)
    jout = capsys.readouterr().out
    treqs, tengs = _observe(chaos_smoke, monkeypatch)
    getattr(chaos_smoke, name)(tp, "cpu")
    got = _outcome(treqs, tengs)
    assert got == want
    if name == "scenario_corruption":    # no request: the error it names
        assert capsys.readouterr().out == jout
    if name == "scenario_lifecycle":
        assert {"cancel", "preempt", "timeout"} <= set(got[2])


def test_chaos_smoke_main_exits_zero():
    assert chaos_smoke.main(["--device", "cpu"]) == 0


def test_server_smoke_exits_zero():
    assert server_smoke.main(["--device", "cpu"]) == 0


def test_artifact_report_equals_jax(tmp_path):
    from repro.artifacts import export_artifact
    cfg = jchaos.CFG
    jp = japi.init(jax.random.PRNGKey(0), cfg)
    calib = [{"inputs": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32))}]
    for method in ("rtn", "gptq"):
        export_artifact(jptq.apply_method(method, jp, cfg, calib,
                                          fmt="mxfp4"), cfg,
                        tmp_path / method)
    outs = []
    for main in (jreport.main, artifact_report.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(tmp_path)]) == 0
        outs.append(buf.getvalue().splitlines())
    assert len(outs[1]) == 3
    assert outs[1] == outs[0]


def test_examples_run_at_a_tiny_size(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)          # latmix_ptq finds experiments/bench_model
    assert quickstart.main(["--device", "cpu", "--steps", "2"]) == 0
    assert train_lm.main(["--device", "cpu", "--steps", "2",
                          "--ckpt-dir", str(tmp_path / "ck")]) == 0
    assert (tmp_path / "ck").is_dir()
    assert latmix_ptq.main(["--device", "cpu", "--methods",
                            "rtn,latmix-lu", "--steps", "2", "--export",
                            str(tmp_path / "art")]) == 0
    out = capsys.readouterr().out
    assert "MXFP4 latmix-lu" in out and "latmix-lu" in out
    assert "final held-out ppl" in out and "Fig. 3 metrics" in out
    for argv in (["--batch", "2", "--new", "4"],
                 ["--scheduler", "continuous", "--kv-layout", "paged",
                  "--batch", "2", "--new", "4", "--spec-k", "2"],
                 ["--artifact", str(tmp_path / "art" / "latmix-lu"),
                  "--kv-cache", "mxfp8", "--kv-layout", "paged",
                  "--batch", "2", "--new", "4", "--metrics"]):
        assert serve.main(["--device", "cpu", *argv]) == 0
        out = capsys.readouterr().out
        assert "throughput:" in out, argv
    assert "prefix_hit_tokens" in out and "serving_" in out
