"""The port's span tracer (``repro_torch.obs.tracing``) and the engine's
spans and instants, against the JAX package:

- the tracer tests of ``tests/test_obs.py`` against the port's ``Tracer``
  and ``validate_trace``;
- an exported trace of the port's engine is accepted by the port's
  ``validate_trace`` and by ``repro.obs.validate_trace``;
- on the same traffic the port engine's trace has the JAX engine's span
  and instant names, per track and in the same order, apart from the JAX
  engine's ``compile:*`` instants (the port compiles nothing) — on the
  wave, continuous and paged paths, with faults, preemption, cancel,
  shedding, timeouts, copy-on-write and speculative verify steps.
"""
import json
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArch
from repro.core.quantize import QuantMode as JQM
from repro.models import api as japi
from repro.obs import Tracer as JTracer
from repro.obs import validate_trace as j_validate
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.faults import FaultInjector as JFI
from repro.serving.policy import SchedulingPolicy as JPolicy
from repro.serving.policy import ShedError as JShed
from repro.serving.policy import SpecConfig as JSpec
from repro_torch import convert
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.obs import Tracer, validate_trace
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.faults import FaultInjector as TFI
from repro_torch.serving.policy import SchedulingPolicy, ShedError, SpecConfig

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

TINY = dict(name="obs-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128, attn_chunk=16)


# ---------------------------------------------------------------------
# the tracer (tests/test_obs.py's tracer tests, on the port's Tracer)
# ---------------------------------------------------------------------

def test_span_roundtrip_and_validation(tmp_path):
    tr = Tracer()
    with tr.span("outer", track="req-0", kind="request"):
        with tr.span("inner", track="req-0"):
            pass
        tr.instant("first_token", track="req-0")
    with tr.span("thread_local_span"):
        pass
    path = tmp_path / "trace.json"
    tr.export(path)
    doc = json.loads(path.read_text())
    assert doc["traceEvents"]
    evs = validate_trace(str(path))
    names = {e["name"] for e in evs}
    assert {"outer", "inner", "first_token", "thread_local_span"} <= names
    outer = next(e for e in evs if e["name"] == "outer")
    inner = next(e for e in evs if e["name"] == "inner")
    assert outer["ph"] == "X" and outer["dur"] >= inner["dur"]
    assert outer["args"] == {"kind": "request"}
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {m["args"]["name"] for m in meta} >= {"req-0"}


def test_required_fields_enforced():
    with pytest.raises(ValueError, match="missing"):
        validate_trace([{"ph": "X", "name": "a"}])
    with pytest.raises(ValueError, match="dur"):
        validate_trace([{"ph": "X", "name": "a", "ts": 0.0,
                         "pid": 0, "tid": 0}])
    with pytest.raises(ValueError, match="bad ts"):
        validate_trace([{"ph": "i", "name": "a", "ts": -1.0,
                         "pid": 0, "tid": 0}])
    with pytest.raises(ValueError, match="ph"):
        validate_trace([{"name": "a"}])


def test_stack_discipline():
    def ev(name, ts, dur, tid=0):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur,
                "pid": 0, "tid": tid}
    validate_trace([ev("a", 0, 10), ev("b", 2, 3), ev("c", 5, 5)])
    with pytest.raises(ValueError, match="overlaps"):
        validate_trace([ev("a", 0, 10), ev("b", 5, 10)])
    validate_trace([ev("a", 0, 10), ev("b", 5, 10, tid=1)])


def test_retroactive_complete_spans():
    tr = Tracer()
    t0 = time.perf_counter()
    with tr.span("child", track="req-1"):
        pass
    tr.complete("parent", t0, time.perf_counter(), track="req-1")
    validate_trace(tr.events())


def test_next_index_per_key():
    tr = Tracer()
    assert [tr.next_index("req") for _ in range(3)] == [0, 1, 2]
    assert tr.next_index("other") == 0


# ---------------------------------------------------------------------
# the engine's trace against the JAX engine's
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def pkgs():
    jp = japi.init(jax.random.PRNGKey(0), JArch(**TINY))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return (types.SimpleNamespace(
                Engine=JEngine, Request=JRequest, Policy=JPolicy, FI=JFI,
                Spec=JSpec, Shed=JShed, Tracer=JTracer, params=jp,
                cfg=JArch(**TINY), qm=JQM.off(), kw={}),
            types.SimpleNamespace(
                Engine=TEngine, Request=TRequest, Policy=SchedulingPolicy,
                FI=TFI, Spec=SpecConfig, Shed=ShedError, Tracer=Tracer,
                params=tp, cfg=TArch(**TINY), qm=TQM.off(),
                kw={"device": "cpu"}))


def _requests(P, lens, news, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [P.Request(prompt=rng.integers(0, TINY["vocab_size"], s)
                      .astype(np.int32), max_new=n, **kw)
            for s, n in zip(lens, news)]


def _served(P, **kw):
    """tests/test_obs.py's traffic: continuous scheduler, 4 requests."""
    tracer = P.Tracer()
    eng = P.Engine(P.params, P.cfg, P.qm, batch_size=2, max_len=64,
                   scheduler="continuous", tracer=tracer, **P.kw, **kw)
    rng = np.random.default_rng(0)
    reqs = [P.Request(prompt=rng.integers(0, TINY["vocab_size"], 4 + 3 * i)
                      .astype(np.int32), max_new=3 + i) for i in range(4)]
    eng.generate(reqs)
    return tracer, eng, reqs


def _wave_with_nan(P):
    tracer = P.Tracer()
    fi = P.FI().inject("nan_logits", at=2, lane=1)
    eng = P.Engine(P.params, P.cfg, P.qm, batch_size=2, max_len=64,
                   tracer=tracer, faults=fi, **P.kw)
    eng.generate(_requests(P, [12, 17, 9], [8, 6, 5], seed=6))
    return tracer, eng, None


def _paged_lifecycle(P):
    """A paged pool of four pages: a prefix resume inside a cached page
    (copy-on-write), batched admission, a priority preemption and its
    resume, a forced cache flush, a forced exhaustion, a NaN lane, a
    cancel, a shed and a zero-deadline request."""
    tracer = P.Tracer()
    fi = (P.FI(seed=0).inject("evict_cache", at=3)
          .inject("alloc_exhausted", at=4)
          .inject("nan_logits", at=6, lane=0))
    eng = P.Engine(P.params, P.cfg, P.qm, batch_size=2, max_len=128,
                   scheduler="continuous", kv_layout="paged", page_size=32,
                   n_pages=5, tracer=tracer, faults=fi,
                   policy=P.Policy(backoff_base_s=0.0, max_queue_depth=3),
                   **P.kw)
    base = _requests(P, [70], [1], seed=21)[0]
    eng.generate([base])                 # registers two prompt pages
    eng.generate([P.Request(prompt=np.asarray(base.prompt[:64]),
                            max_new=3)])
    lo = _requests(P, [20, 24], [10, 9], seed=22, deadline_ms=1e7)
    for r in lo:
        eng.submit(r)
    eng.step()
    eng.submit(_requests(P, [30], [6], seed=23, priority=2)[0])
    eng.submit(_requests(P, [8], [3], seed=24, ttft_deadline_ms=0.0)[0])
    gone = _requests(P, [6], [4], seed=26)[0]
    eng.submit(gone)
    with pytest.raises(P.Shed):
        eng.submit(_requests(P, [5], [2], seed=25)[0])
    eng.step()
    eng.cancel(gone.request_id)
    eng.drain()
    return tracer, eng, None


def _spec_paged(P):
    tracer = P.Tracer()
    fi = P.FI().inject("nan_logits", at=2, lane=0)
    eng = P.Engine(P.params, P.cfg, P.qm, batch_size=2, max_len=64,
                   scheduler="continuous", kv_layout="paged", page_size=32,
                   spec=P.Spec(k=3), tracer=tracer, faults=fi, **P.kw)
    eng.generate(_requests(P, [12, 17, 9], [8, 8, 6], seed=6))
    return tracer, eng, None


def _by_track(tracer):
    """{track name: [(ph, name), ...]} in recording order, without the
    JAX engine's compile:* instants."""
    names = {tid: name for name, tid in tracer._tracks.items()}
    out = {}
    for e in tracer.events():
        if e["name"].startswith("compile:"):
            continue
        out.setdefault(names[e["tid"]], []).append((e["ph"], e["name"]))
    return out


@pytest.mark.parametrize("scenario", [_served, _wave_with_nan,
                                      _paged_lifecycle, _spec_paged],
                         ids=["continuous", "wave-nan", "paged-lifecycle",
                              "spec-paged"])
def test_trace_names_per_track_match_jax(pkgs, scenario, tmp_path):
    jt, _, _ = scenario(pkgs[0])
    tt, teng, _ = scenario(pkgs[1])
    assert _by_track(tt) == _by_track(jt)
    path = tmp_path / "port_trace.json"
    tt.export(path)
    assert len(validate_trace(str(path))) == len(tt.events())
    assert len(j_validate(str(path))) == len(tt.events())
    names = {n for evs in _by_track(tt).values() for _, n in evs}
    assert "engine_step" in names or "wave" in names


def test_trace_has_lifecycle_and_step_spans(pkgs):
    """tests/test_obs.py's engine integration on the port: one request
    span and one first_token per request, each on its own track; the
    step spans; no compile markers."""
    tracer, eng, done = _served(pkgs[1])
    evs = validate_trace(tracer.events())
    by_name = {}
    for e in evs:
        by_name.setdefault(e["name"], []).append(e)
    assert len(by_name["request"]) == len(done)
    assert len({e["tid"] for e in by_name["request"]}) == len(done)
    assert len(by_name["first_token"]) == len(done)
    assert by_name["engine_step"] and by_name["decode_step"]
    assert by_name["prefill_chunk"] and by_name["host_sync"]
    assert not any(n.startswith("compile:") for n in by_name)
    st = eng.stats()
    assert st["admitted"] == len(done) == 4
    assert eng.metrics.get("serving_ttft_seconds").count == len(done)
    text = eng.metrics.render_prometheus()
    assert "serving_requests_admitted_total 4" in text
    assert "serving_preemptions_total 0" in text
    assert "serving_requests_shed_total 0" in text


def test_no_tracer_records_nothing(pkgs):
    """Tracing off is the default and adds no events anywhere."""
    P = pkgs[1]
    eng = P.Engine(P.params, P.cfg, P.qm, batch_size=2, max_len=64,
                   scheduler="continuous", **P.kw)
    reqs = _requests(P, [9, 13], [4, 5], seed=1)
    eng.generate(reqs)
    assert eng.tracer is None and all(r.trace_track is None for r in reqs)
