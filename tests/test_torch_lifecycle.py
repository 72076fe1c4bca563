"""The port's request lifecycle against the JAX engine: the engine tests of
``tests/test_faults.py`` (cancel, deadlines, the NaN guard, preemption with
bit-identical resume, the retry budget, equal priority, never-fit, the
chaos scenario) and ``tests/test_sampling.py``'s sampled preemption-resume,
on the JAX package's small f32 model in both packages.

Each scenario is written once and run through both engines on the same
numpy-seeded traffic, each with its own ``FaultInjector`` of the same seed
and plan. Where the outcome is deterministic (cancel at step n, priority
preemption, a seeded fault schedule) the port must give the JAX engine's
tokens, terminal states and counters exactly (stated tolerance: equal).
Deadlines depend on the wall clock, so those scenarios are held by their
invariants only, in both packages.

The two engines resume a preempted request differently: the JAX engine
re-prefills prompt + emitted tokens, the port prefills the prompt and
replays the emitted tokens through the steps that first wrote their KV:
decode steps, or under spec verify steps of the same shape (bit-identical
to the uninterrupted run on the card too). Where a scenario resumes a
request, the port's prefill chunk count is held to at most the JAX
engine's and its replay steps to the tokens its requests had emitted when
evicted (under spec, to its recorded verify steps plus one).
"""
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArch
from repro.core.quantize import QuantMode as JQM
from repro.models import api as japi
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.faults import FaultInjector as JFI
from repro.serving.policy import SchedulingPolicy as JPolicy
from repro.serving.policy import SpecConfig as JSpec
from repro.serving.sampling import SamplingParams as JSP
from repro_torch import convert
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.faults import FaultInjector as TFI
from repro_torch.serving.policy import (SchedulingPolicy, SpecConfig,
                                        TERMINAL_STATES)
from repro_torch.serving.sampling import SamplingParams as TSP

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, attn_chunk=16)
COUNTERS = ("submitted", "terminal", "admitted", "preemptions",
            "nan_guard_trips", "rejected_never_fit", "decode_steps",
            "prefill_chunk_steps")
PAGED = dict(kv_layout="paged", page_size=32)


@pytest.fixture(scope="module")
def pkgs():
    """Both packages with the JAX tests' weights (PRNGKey(0))."""
    jp = japi.init(jax.random.PRNGKey(0), JArch(**TINY))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    jax_ = types.SimpleNamespace(
        name="jax", Engine=JEngine, Request=JRequest, Policy=JPolicy,
        FI=JFI, Spec=JSpec, SP=JSP, params=jp, cfg=JArch(**TINY),
        qm=JQM.off(), kw={})
    port = types.SimpleNamespace(
        name="port", Engine=TEngine, Request=TRequest,
        Policy=SchedulingPolicy, FI=TFI, Spec=SpecConfig, SP=TSP,
        params=tp, cfg=TArch(**TINY), qm=TQM.off(), kw={"device": "cpu"})
    return jax_, port


def _engine(P, **kw):
    return P.Engine(P.params, P.cfg, P.qm, **P.kw, **kw)


def _requests(P, lens, news, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [P.Request(prompt=rng.integers(0, TINY["vocab_size"], s)
                      .astype(np.int32), max_new=n, **kw)
            for s, n in zip(lens, news)]


def _state(r):
    return r.state.value


def _same(pkgs, scenario):
    """Run ``scenario(P) -> (requests, engine)`` through both packages and
    hold the port to the JAX engine: tokens, terminal states, retries and
    preemptions per request, and the lifecycle counters, all equal — but
    for a resume's prefill chunks (module docstring): the port runs at
    most the JAX engine's, and one replay step for each token a requeued
    request had emitted when it was evicted — under spec, one for each
    verify step that wrote its KV plus the one that picks its next
    token."""
    jr, je = scenario(pkgs[0])
    evicted = []                    # tokens emitted by each requeued one
    preempt = TEngine._preempt

    def spy(self, lane, done, reason):
        req = self._slots[lane].req
        n = len(req._steps) + 1 if self.spec is not None else len(req._gen)
        preempt(self, lane, done, reason)
        if not req.state.terminal:
            evicted.append(n)
    with mock.patch.object(TEngine, "_preempt", spy):
        tr, te = scenario(pkgs[1])
    assert [_state(r) for r in tr] == [_state(r) for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.out, b.out)
        assert (a.retries, a.preemptions) == (b.retries, b.preemptions)
    js, ts = je.stats(), te.stats()
    keys = [k for k in COUNTERS if not evicted or k != "prefill_chunk_steps"]
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["prefill_chunk_steps"] <= js["prefill_chunk_steps"]
    assert ts["resume_replay_steps"] == sum(evicted)
    return tr, te


# ---------------------------------------------------------------------------
# Cancellation (deterministic: cancel after step n)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_cancel_queued_and_running(pkgs, layout):
    def scenario(P):
        eng = _engine(P, batch_size=1, max_len=64, scheduler="continuous",
                      **(PAGED if layout == "paged" else {}))
        running, queued = _requests(P, [12, 12], [16, 8], seed=1)
        # a far-future deadline caps the decode burst, so one step leaves
        # the request mid-flight
        running.deadline_ms = 1e7
        eng.submit(running)
        eng.submit(queued)
        eng.step()                      # admits `running`; `queued` waits
        assert _state(running) == "running"
        assert eng.cancel(queued.request_id)
        assert _state(queued) == "cancelled"
        assert queued.error == "cancelled by client"
        assert len(queued.out) == 0
        assert eng.cancel(running.request_id)
        assert _state(running) == "cancelled"
        assert 0 < len(running.out) < running.max_new
        assert not eng.busy             # lane freed mid-flight
        assert not eng.cancel(running.request_id)     # idempotent
        assert not eng.cancel("no-such-id")
        st = eng.stats()
        assert st["terminal"]["cancelled"] == 2 and st["submitted"] == 2
        if layout == "paged":
            assert eng._alloc.in_use == 0
            eng._alloc.check()
        return [running, queued], eng
    _same(pkgs, scenario)


def test_cancel_running_paged_derefs_pages(pkgs):
    def scenario(P):
        eng = _engine(P, batch_size=2, max_len=64, scheduler="continuous",
                      **PAGED)
        req = _requests(P, [20], [16], seed=2, deadline_ms=1e7)[0]
        eng.submit(req)
        eng.step()
        assert eng._alloc.in_use > 0
        assert eng.cancel(req.request_id)
        assert eng._alloc.in_use == 0   # pages released mid-flight
        eng._alloc.check()
        return [req], eng
    tr, te = _same(pkgs, scenario)
    assert te.metrics.get("serving_blocks_in_use").value == 0


# ---------------------------------------------------------------------------
# Deadlines (wall clock: invariants only, in both packages)
# ---------------------------------------------------------------------------

def test_queued_deadline_expires_without_prefill(pkgs):
    for P in pkgs:
        eng = _engine(P, batch_size=1, max_len=64, scheduler="continuous")
        ok_req, doomed = _requests(P, [12, 12], [4, 4], seed=3)
        doomed.ttft_deadline_ms = 0.0   # expired the moment it queues
        eng.submit(ok_req)
        eng.submit(doomed)
        done = eng.drain()
        assert set(done) == {ok_req, doomed}
        assert _state(doomed) == "timed_out", P.name
        assert "TTFT deadline" in doomed.error and "queued" in doomed.error
        assert len(doomed.out) == 0
        assert _state(ok_req) == "finished"
        st = eng.stats()
        assert st["terminal"]["timed_out"] == 1
        assert st["terminal"]["finished"] == 1
        assert st["prefill_chunk_steps"] == 1     # the doomed one: none
        # no first token, no TTFT sample
        assert eng.metrics.get("serving_ttft_seconds").count == 1


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_running_deadline_times_out_mid_decode(pkgs, layout):
    for P in pkgs:
        fi = P.FI().inject("slow_step", every=1, delay_s=0.03)
        eng = _engine(P, batch_size=1, max_len=128, scheduler="continuous",
                      faults=fi, policy=P.Policy(deadline_burst_cap=2),
                      **(PAGED if layout == "paged" else {}))
        # admitted under a far-future deadline (bursts of 2), then given
        # one that has already passed
        req = _requests(P, [12], [96], seed=4, deadline_ms=1e7)[0]
        eng.submit(req)
        eng.step()
        assert _state(req) == "running" and len(req._gen) == 3, P.name
        req.deadline_ms = 0.1
        done = eng.drain()
        assert done == [req]
        assert _state(req) == "timed_out"
        assert "end-to-end deadline" in req.error
        assert 0 < len(req.out) < req.max_new     # partial output
        assert fi.fired("slow_step") >= 1
        if layout == "paged":
            assert eng._alloc.check()["in_use"] == 0


def test_policy_default_deadline_applies_at_submit(pkgs):
    for P in pkgs:
        eng = _engine(P, batch_size=1, max_len=64, scheduler="continuous",
                      policy=P.Policy(deadline_ms=0.0))
        explicit, defaulted = _requests(P, [8, 8], [4, 4], seed=5)
        explicit.deadline_ms = 10_000.0     # its own survives the policy
        eng.submit(explicit)
        eng.submit(defaulted)
        eng.drain()
        assert _state(explicit) == "finished", P.name
        assert _state(defaulted) == "timed_out"
        assert defaulted.deadline_ms == 0.0


# ---------------------------------------------------------------------------
# The NaN guard isolates the poisoned lane (seeded fault schedule)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["continuous", "paged", "wave"])
def test_nan_guard_isolates_lane(pkgs, path):
    lens, news = [12, 17], [8, 8]
    kw = dict(batch_size=2, max_len=64)
    if path != "wave":
        kw["scheduler"] = "continuous"
    if path == "paged":
        kw.update(PAGED)
    lane = 0 if path == "wave" else 1
    ref = _engine(pkgs[1], **kw).generate(
        _requests(pkgs[1], lens, news, seed=6))

    def scenario(P):
        fi = P.FI().inject("nan_logits", at=2, lane=lane)
        eng = _engine(P, faults=fi, **kw)
        reqs = _requests(P, lens, news, seed=6)
        eng.generate(reqs)
        return reqs, eng
    reqs, eng = _same(pkgs, scenario)
    victim, neighbor = reqs[lane], reqs[1 - lane]
    assert _state(victim) == "failed"
    assert "non-finite logits" in victim.error
    assert len(victim.out) < victim.max_new
    if path == "wave":
        assert len(victim.out) == 3     # prefill token + 2 clean steps
    # its emitted tokens are the fault-free prefix; the neighbour is the
    # fault-free run
    np.testing.assert_array_equal(victim.out, ref[lane].out[:len(victim.out)])
    assert _state(neighbor) == "finished"
    np.testing.assert_array_equal(neighbor.out, ref[1 - lane].out)
    assert eng.stats()["nan_guard_trips"] == 1


def test_nan_guard_isolates_lane_in_a_verify_step(pkgs):
    """The fault fires in the speculative verify step: only the poisoned
    lane fails, on both packages alike."""
    def scenario(P):
        fi = P.FI().inject("nan_logits", at=1, lane=0)
        eng = _engine(P, batch_size=2, max_len=64, scheduler="continuous",
                      spec=P.Spec(k=3), faults=fi, **PAGED)
        reqs = _requests(P, [12, 17], [8, 8], seed=6)
        eng.generate(reqs)
        return reqs, eng
    reqs, eng = _same(pkgs, scenario)
    assert [_state(r) for r in reqs] == ["failed", "finished"]
    assert eng._alloc.check()["in_use"] == 0


# ---------------------------------------------------------------------------
# Preemption and bit-identical resume
# ---------------------------------------------------------------------------

def _lo_hi(P, sampled=False):
    if sampled:
        rng = np.random.default_rng(41)
        lo = P.Request(prompt=rng.integers(0, TINY["vocab_size"], 40)
                       .astype(np.int32), max_new=10, priority=0,
                       deadline_ms=1e7,
                       sampling=P.SP(temperature=0.9, top_k=12, seed=3))
        hi = P.Request(prompt=rng.integers(0, TINY["vocab_size"], 38)
                       .astype(np.int32), max_new=8, priority=5,
                       sampling=P.SP(temperature=0.7, top_k=6, seed=4))
        return lo, hi
    # lo's far-future deadline caps its bursts, so it is mid-flight when
    # hi arrives
    lo = _requests(P, [40], [10], seed=7, priority=0, deadline_ms=1e7)[0]
    hi = _requests(P, [38], [8], seed=8, priority=5)[0]
    return lo, hi


POOL = dict(batch_size=2, max_len=64, scheduler="continuous", n_pages=3,
            **PAGED)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_preemption_resumes_bit_identically(pkgs, sampled):
    """The pool fits one request: a higher-priority arrival preempts the
    running one (pages released, requeued with backoff); both finish, and
    the preempted request gives its uninterrupted tokens — greedy, and
    sampled with the draw at its emitted count (``tests/test_sampling.py``'s
    sampled analogue)."""
    port = pkgs[1]
    solo = _engine(port, **POOL)
    lo_ref, hi_ref = _lo_hi(port, sampled)
    solo.generate([lo_ref])
    solo.generate([hi_ref])

    def scenario(P):
        eng = _engine(P, policy=P.Policy(backoff_base_s=0.001), **POOL)
        lo, hi = _lo_hi(P, sampled)
        eng.submit(lo)
        eng.step()                      # lo admitted, takes both pages
        assert _state(lo) == "running"
        eng.submit(hi)
        eng.drain()
        return [lo, hi], eng
    (lo, hi), eng = _same(pkgs, scenario)
    assert _state(hi) == _state(lo) == "finished"
    assert lo.preemptions >= 1 and eng.stats()["preemptions"] >= 1
    np.testing.assert_array_equal(lo.out, lo_ref.out)
    np.testing.assert_array_equal(hi.out, hi_ref.out)
    assert eng._alloc.in_use == 0
    eng._alloc.check()


def test_preemption_retry_budget_exhausts_to_terminal(pkgs):
    def scenario(P):
        eng = _engine(P, policy=P.Policy(max_retries=0), **POOL)
        lo, hi = _lo_hi(P)
        eng.submit(lo)
        eng.step()
        eng.submit(hi)
        eng.drain()
        return [lo, hi], eng
    (lo, hi), eng = _same(pkgs, scenario)
    assert _state(hi) == "finished"
    assert _state(lo) == "preempted"    # out of retry budget
    assert "retry budget" in lo.error
    assert len(lo.out) >= 1             # partial tokens delivered
    assert eng.stats()["terminal"]["preempted"] == 1
    assert eng._alloc.in_use == 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_priority_preemption_when_every_lane_is_busy(pkgs, layout):
    """Every lane busy and a strictly higher-priority request waiting:
    exactly one lane is preempted, and its request resumes with its
    uninterrupted tokens."""
    kw = dict(batch_size=2, max_len=64, scheduler="continuous",
              **(PAGED if layout == "paged" else {}))

    def scenario(P):
        eng = _engine(P, policy=P.Policy(backoff_base_s=0.0), **kw)
        los = _requests(P, [14, 20], [12, 12], seed=13, deadline_ms=1e7)
        hi = _requests(P, [9], [6], seed=14, priority=1)[0]
        for r in los:
            eng.submit(r)
        eng.step()
        eng.submit(hi)
        eng.drain()
        return los + [hi], eng
    reqs, eng = _same(pkgs, scenario)
    assert eng.stats()["preemptions"] == 1
    assert all(_state(r) == "finished" for r in reqs)
    ref = _engine(pkgs[1], **kw).generate(
        _requests(pkgs[1], [14, 20], [12, 12], seed=13))
    for a, b in zip(reqs[:2], ref):
        np.testing.assert_array_equal(a.out, b.out)


def test_equal_priority_never_preempts(pkgs):
    """Strictly-lower-priority victims only: same-priority contention
    falls back to backpressure."""
    def scenario(P):
        eng = _engine(P, **POOL)
        reqs = _requests(P, [40, 38], [8, 8], seed=9)
        eng.generate(reqs)
        return reqs, eng
    reqs, eng = _same(pkgs, scenario)
    assert [_state(r) for r in reqs] == ["finished"] * 2
    assert eng.stats()["preemptions"] == 0


def test_wave_never_fit_is_terminal_failed(pkgs):
    def scenario(P):
        eng = _engine(P, batch_size=2, max_len=32)
        big = P.Request(prompt=np.zeros(30, np.int32), max_new=40)
        ok_req = _requests(P, [8], [4], seed=12)[0]
        eng.submit(big)
        eng.submit(ok_req)
        done = eng.drain()
        assert set(done) == {big, ok_req}
        assert "never fit" in big.error
        return [big, ok_req], eng
    reqs, _ = _same(pkgs, scenario)
    assert [_state(r) for r in reqs] == ["failed", "finished"]


# ---------------------------------------------------------------------------
# Full chaos scenario: seeded faults -> quiescence, nothing leaks
# ---------------------------------------------------------------------------

def _chaos(P, spec, backoff):
    """``tests/test_faults.py``'s chaos scenario: forced exhaustion, a
    forced cache flush, a NaN lane and slow steps over mixed-priority
    traffic with a cancel, a zero-deadline and a never-fit request."""
    fi = (P.FI(seed=0)
          .inject("alloc_exhausted", at=1, times=2)
          .inject("evict_cache", at=2)
          .inject("nan_logits", at=5, lane=0)
          .inject("slow_step", every=4, delay_s=0.001))
    eng = _engine(P, batch_size=2, max_len=64, scheduler="continuous",
                  n_pages=5, policy=P.Policy(backoff_base_s=backoff),
                  faults=fi, spec=None if spec is None else P.Spec(k=spec),
                  **PAGED)
    reqs = _requests(P, [20, 40, 12, 33, 8], [6, 10, 4, 8, 5], seed=10,
                     deadline_ms=1e7)   # far-future: caps bursts only
    for pri, r in zip([0, 0, 3, 1, 0], reqs):
        r.priority = pri
    if spec is not None:                # mixed greedy + sampled lanes
        for i, r in enumerate(reqs[::2]):
            r.sampling = P.SP(temperature=0.8, top_k=12, seed=i)
    reqs.append(P.Request(prompt=np.zeros(60, np.int32), max_new=40))
    doomed = _requests(P, [10], [4], seed=11, deadline_ms=0.0)[0]
    reqs.append(doomed)
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not any(_state(r) == "running" for r in reqs):
        eng.step()
        steps += 1
        assert steps < 50, "nothing ever ran"
    victim = next(r for r in reqs if _state(r) == "running")
    assert eng.cancel(victim.request_id)
    steps = 0
    while eng.busy:
        eng.step()
        steps += 1
        assert steps < 500, "chaos scenario failed to reach quiescence"
        eng._alloc.check()              # invariants hold mid-flight too
    assert all(r.state.terminal for r in reqs)
    st = eng.stats()
    assert st["submitted"] == len(reqs)
    assert sum(st["terminal"].values()) == st["submitted"]
    assert st["terminal"]["cancelled"] == 1
    assert st["terminal"]["timed_out"] == 1
    assert st["terminal"]["failed"] >= 1        # never-fit (+ maybe NaN)
    assert st["blocks_in_use"] == 0             # zero leaked pages
    assert eng._alloc.check()["in_use"] == 0
    assert fi.fired("alloc_exhausted") == 2
    assert fi.fired("evict_cache") == 1
    assert [e["point"] for e in fi.summary()["log"]].count(
        "alloc_exhausted") == 2
    return reqs, eng


@pytest.mark.parametrize("spec", [None, 3], ids=["plain", "spec"])
def test_chaos_scenario_reaches_quiescence(pkgs, spec):
    """The JAX test's scenario and policy (1 ms backoff: when a requeued
    request is eligible again depends on the clock), held by its
    invariants on the port."""
    reqs, _ = _chaos(pkgs[1], spec, backoff=0.001)
    assert all(r.state in TERMINAL_STATES for r in reqs)


@pytest.mark.parametrize("spec", [None, 3], ids=["plain", "spec"])
def test_chaos_scenario_matches_jax(pkgs, spec):
    """The same scenario with no backoff hold, which leaves nothing to
    the clock: the port gives the JAX engine's tokens, states and
    counters."""
    _same(pkgs, lambda P: _chaos(P, spec, backoff=0.0))


def test_allocator_flush_cache_evicts_only_cached_pages():
    from repro.serving.engine import BlockAllocator as JAlloc
    from repro_torch.serving.engine import BlockAllocator as TAlloc
    out = []
    for A in (JAlloc, TAlloc):
        a = A(8, 32, reserved=1)
        pages = a.alloc(4)
        for j, p in enumerate(pages[:3]):
            a.register(bytes([j]), p)
        for p in pages[1:]:
            a.decref(p)                 # 2 cached, 1 free, 1 referenced
        n = a.flush_cache()
        out.append((n, a.check(), a.lookup(bytes([1]))))
    assert out[0] == out[1] == (2, {"free": 6, "cached": 0, "in_use": 1,
                                    "evicted": 2}, None)


# ---------------------------------------------------------------------------
# Resume under speculative decoding: the replay repeats the verify shapes
# ---------------------------------------------------------------------------

SPEC_K = 3


def _packed_fused(port):
    """The tiny model, RTN mxfp4 and packed, under the fused backend: every
    linear but the head goes through ``ops.mx_gemm_packed`` (its plain
    version here), whose M the replay test reads."""
    from repro_torch.artifacts.store import pack_params
    from repro_torch.core import ptq

    res = ptq.apply_method("rtn", port.params, port.cfg)
    return pack_params(res), res.qm.with_backend("fused")


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_spec_resume_replays_the_verify_shapes(pkgs, layout):
    """A spec request (k = 3) preempted by a higher-priority arrival and
    resumed: its tokens equal its uninterrupted run's, and the replay
    rebuilds its lane through verify steps of the run's shape — every
    packed GEMM of the replay at M = B·(k + 1), the run's verify M, never
    a decode step's M = B — one verify forward for each recorded step plus
    the step that picks the next token, as
    ``serving_resume_replay_steps_total`` counts them. The recorded
    boundaries cover the emitted tokens but the last."""
    from repro_torch.kernels import ops
    from repro_torch.models import api as tapi

    port = pkgs[1]
    params, qm = _packed_fused(port)
    kw = (dict(**POOL) if layout == "paged" else
          dict(batch_size=1, max_len=64, scheduler="continuous"))
    B = kw["batch_size"]
    spec = SpecConfig(k=SPEC_K)
    # a prompt on which the tiny model's 8th and 9th verify steps keep 4
    # rows each
    pattern = np.random.default_rng(1).integers(0, 128, 8).astype(np.int32)

    def reqs():
        lo = TRequest(prompt=np.tile(pattern, 5), max_new=20, priority=0)
        hi = _requests(port, [38], [8], seed=8, priority=5)[0]
        return lo, hi

    ms, forwards, inside = [], [], []
    gemm = ops.mx_gemm_packed

    def spy_gemm(x, *a, **k):
        if inside:                      # the GEMMs of decode and verify
            ms.append(x.reshape(-1, x.shape[-1]).shape[0])
        return gemm(x, *a, **k)

    def spy_step(name):
        fn = getattr(tapi, name)

        def run(*a, **k):
            forwards.append((name, tuple(a[3].shape)))
            inside.append(1)
            try:
                return fn(*a, **k)
            finally:
                inside.pop()
        return mock.patch.object(tapi, name, run)

    with mock.patch.object(ops, "mx_gemm_packed", spy_gemm), \
            spy_step("verify"), spy_step("verify_paged"), \
            spy_step("decode"), spy_step("decode_paged"):
        solo = TEngine(params, port.cfg, qm, spec=spec, device="cpu", **kw)
        lo_ref, hi_ref = reqs()
        solo.generate([lo_ref])
        solo.generate([hi_ref])
        run_ms = set(ms)

        eng = TEngine(params, port.cfg, qm, spec=spec, device="cpu",
                      policy=SchedulingPolicy(backoff_base_s=0.001), **kw)
        lo, hi = reqs()
        seen = {}
        replay = TEngine._replay

        def spy_replay(self, slot, req, pos0):
            seen["steps"] = list(req._steps)
            seen["gen"] = list(req._gen)
            ms.clear()
            forwards.clear()
            row = replay(self, slot, req, pos0)
            seen["ms"], seen["forwards"] = list(ms), list(forwards)
            return row

        with mock.patch.object(TEngine, "_replay", spy_replay):
            eng.submit(lo)
            for _ in range(9):          # admission, then 9 verify steps
                eng.step()
            assert _state(lo) == "running"
            eng.submit(hi)
            eng.drain()
    assert _state(lo) == _state(hi) == "finished" and lo.preemptions == 1
    np.testing.assert_array_equal(lo.out, lo_ref.out)
    np.testing.assert_array_equal(hi.out, hi_ref.out)
    C = SPEC_K + 1
    assert run_ms == {B * C}, run_ms    # the run's GEMMs: verify steps only
    steps = seen["steps"]
    assert len(steps) == 9 and all(c == C for c, _ in steps), steps
    assert sum(n for _, n in steps) == len(seen["gen"]) - 1
    assert max(n for _, n in steps) > 1     # a step kept accepted drafts
    assert set(seen["ms"]) == {B * C}, seen["ms"]
    name = "verify_paged" if layout == "paged" else "verify"
    assert seen["forwards"] == [(name, (B, C))] * (len(steps) + 1)
    assert eng.stats()["resume_replay_steps"] == len(steps) + 1
