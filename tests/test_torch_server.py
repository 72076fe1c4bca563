"""The port's HTTP/SSE front end (``repro_torch.serving.server``) on the CPU:
the fifteen tests of ``tests/test_server.py`` against the port's server
over ``demo_engine(device="cpu")``, and one cross-package test — the SSE
stream's tokens equal the JAX engine's ``generate`` on the same parameters.

Every test runs a real asyncio server on an ephemeral 127.0.0.1 port and
speaks HTTP over real sockets. Every wait is bounded: each coroutine a test
awaits runs under ``asyncio.wait_for``, each test body under a whole-test
limit, and the server is torn down (watchdog cancelled, supervisor joined
with a timeout, listener closed) in ``finally`` even when the body fails.

The drain-timeout test holds the port to the documented contract
(``docs/server.md``, drain): at ``drain_timeout_s`` the stragglers are
cancelled and the report is clean.
"""
import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArch
from repro.core.quantize import QuantMode as JQM
from repro.models import api as japi
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import convert
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.policy import (RequestQueue, RequestState,
                                        SchedulingPolicy, ShedError)
from repro_torch.serving.server import (Server, ServerConfig, _TokenStream,
                                        demo_engine)

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

IO_S = 60.0          # one HTTP exchange
BODY_S = 120.0       # one test body, server start to shutdown


# ---------------------------------------------------------------------------
# HTTP helpers (raw sockets — the client the tests trust is the protocol)
# ---------------------------------------------------------------------------

async def _http(port, method, path, body=None):
    """One request/response; returns (code, headers, payload_bytes)."""
    async def exchange():
        r, w = await asyncio.open_connection("127.0.0.1", port)
        try:
            data = b"" if body is None else json.dumps(body).encode()
            w.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                     f"Content-Length: {len(data)}\r\n\r\n").encode() + data)
            await w.drain()
            return await r.read()
        finally:
            w.close()
    raw = await asyncio.wait_for(exchange(), IO_S)
    head, _, payload = raw.partition(b"\r\n\r\n")
    headers = {}
    for line in head.split(b"\r\n")[1:]:
        if b": " in line:
            k, v = line.decode().split(": ", 1)
            headers[k.lower()] = v
    return int(head.split()[1]), headers, payload


async def _generate(port, prompt, max_new, stream=False, **fields):
    body = {"prompt": list(map(int, prompt)), "max_new": max_new,
            "stream": stream, **fields}
    code, headers, payload = await _http(port, "POST", "/v1/generate", body)
    if stream:
        return code, headers, payload
    return code, headers, (json.loads(payload) if payload else {})


def _sse_parse(payload: bytes):
    """[(event, data_dict), ...] from a raw SSE body."""
    out, event = [], None
    for line in payload.decode().split("\n"):
        if line.startswith("event:"):
            event = line[6:].strip()
        elif line.startswith("data:"):
            out.append((event, json.loads(line[5:])))
    return out


def _tokens(payload: bytes):
    return [t for ev, d in _sse_parse(payload) if ev == "token"
            for t in d["tokens"]]


async def _until_idle(srv, tries=500):
    for _ in range(tries):
        if srv.sup.idle():
            return
        await asyncio.sleep(0.01)


def _demo(**kw):
    return demo_engine(device="cpu", **kw)


def _run(body, policy_kw=None, server_kw=None, faults=None, engine=None,
         **engine_kw):
    """Start a server (over ``engine``, else a CPU demo engine), run
    ``body(srv)`` under the whole-test limit, and tear the server down in
    ``finally``; returns what the body returns."""
    async def main():
        eng = engine if engine is not None else _demo(
            faults=faults, **{**(policy_kw or {}), **engine_kw})
        srv = Server(eng, ServerConfig(port=0, **(server_kw or {})),
                     faults=faults)
        await asyncio.wait_for(srv.start(), IO_S)
        try:
            return await asyncio.wait_for(body(srv), BODY_S)
        finally:
            if srv._watchdog_task is not None:
                srv._watchdog_task.cancel()
            srv.sup.stop(timeout_s=10.0)
            srv._server.close()
            assert not srv.sup._thread.is_alive(), "worker did not stop"
    return asyncio.run(main())


# ---------------------------------------------------------------------------
# Admission control / shedding
# ---------------------------------------------------------------------------

def test_shed_keeps_terminal_invariant_and_retry_after():
    async def body(srv):
        p = srv.port
        outs = await asyncio.gather(*[
            _generate(p, [1, 2, 3], 16) for _ in range(6)])
        codes = sorted(c for c, _, _ in outs)
        assert 429 in codes and 200 in codes
        for code, headers, payload in outs:
            if code == 429:
                assert int(headers["retry-after"]) >= 1
                assert float(headers["x-retry-after-s"]) > 0
                assert payload["error"] == "shed"
                assert "queue full" in payload["reason"]
        rep = await srv.shutdown()
        assert rep["clean"], rep
        assert rep["terminal"]["shed"] == sum(
            1 for c, _, _ in outs if c == 429)
        assert rep["terminal_sum"] == rep["submitted"] == 6
        return rep
    rep = _run(body, max_queue_depth=1, batch_size=1)
    assert rep["all_terminal"] and rep["allocator_clean"]


def test_shed_retry_after_grows_with_consecutive_sheds():
    """Sustained overload pushes clients out along the backoff schedule;
    a successful admission resets the streak."""
    eng = _demo(max_queue_depth=0)          # queue always "full"
    pol = eng.policy
    waits = []
    for _ in range(3):
        with pytest.raises(ShedError) as ei:
            eng.submit(Request(prompt=np.arange(4, dtype=np.int32),
                               max_new=4))
        waits.append(ei.value.retry_after_s)
    assert waits == [pol.backoff_s(1), pol.backoff_s(2), pol.backoff_s(3)]
    assert eng._shed_streak == 3
    st = eng.stats()
    assert st["terminal"]["shed"] == 3 and st["submitted"] == 3
    assert eng.metrics.get("serving_requests_shed_total").value == 3


def test_token_budget_and_per_priority_caps_shed():
    eng_b = _demo(admit_token_budget=24)
    # first fits (4+16=20 <= 24), second would blow the budget
    eng_b.submit(Request(prompt=np.arange(4, dtype=np.int32), max_new=16))
    with pytest.raises(ShedError) as ei:
        eng_b.submit(Request(prompt=np.arange(4, dtype=np.int32),
                             max_new=16))
    assert "token budget" in ei.value.reason
    eng_b.drain()

    pol = SchedulingPolicy(max_queue_depth_per_priority=1)
    q = RequestQueue()
    hi = Request(prompt=np.arange(4, dtype=np.int32), max_new=4, priority=1)
    hi.state = RequestState.QUEUED
    q.push(hi)
    lo = Request(prompt=np.arange(4, dtype=np.int32), max_new=4, priority=0)
    assert pol.shed_reason(q, lo) is None          # other priority lane
    hi2 = Request(prompt=np.arange(4, dtype=np.int32), max_new=4,
                  priority=1)
    assert "priority 1 lane full" in pol.shed_reason(q, hi2)


def test_draining_server_rejects_new_work_with_503():
    async def body(srv):
        p = srv.port
        srv.draining = True                        # drain flag only
        code, headers, payload = await _generate(p, [1, 2], 4)
        assert code == 503 and "retry-after" in headers
        code, _, _ = await _http(p, "GET", "/readyz")
        assert code == 503
        code, _, _ = await _http(p, "GET", "/healthz")
        assert code == 200                         # liveness != readiness
        srv.draining = False
        rep = await srv.shutdown()
        assert rep["clean"]
    _run(body)


# ---------------------------------------------------------------------------
# Streaming: parity, disconnect propagation, bounded buffer
# ---------------------------------------------------------------------------

def test_http_stream_matches_direct_engine_generate():
    """Tokens over SSE are bit-identical to a direct library run with
    the same prompt (greedy) — the front end adds no token semantics."""
    async def body(srv):
        code, _, payload = await _generate(srv.port, [7, 8, 9, 10], 12,
                                           stream=True)
        assert code == 200
        events = _sse_parse(payload)
        done = [d for ev, d in events if ev == "done"]
        assert done and done[0]["state"] == "finished"
        assert _tokens(payload) == done[0]["tokens"]
        rep = await srv.shutdown()
        assert rep["clean"]
        return _tokens(payload)
    toks = _run(body)
    [req] = _demo().generate([Request(
        prompt=np.array([7, 8, 9, 10], np.int32), max_new=12)])
    assert toks == [int(t) for t in req.out]


def test_disconnect_cancels_within_one_step_and_bystander_identical():
    """Drop an SSE connection mid-stream: its request ends CANCELLED
    with pages freed, while a concurrent request on another lane
    finishes bit-identically to an undisturbed run."""
    bystander_prompt = np.array([11, 12, 13], np.int32)
    eng0 = _demo(deadline_ms=1e9)                  # burst-capped decode
    [undisturbed] = eng0.generate([Request(prompt=bystander_prompt.copy(),
                                           max_new=24)])

    async def body(srv):
        p = srv.port
        # victim: open the SSE stream by hand so we can drop it
        r, w = await asyncio.wait_for(
            asyncio.open_connection("127.0.0.1", p), IO_S)
        data = json.dumps({"prompt": [1, 2, 3], "max_new": 64}).encode()
        w.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n").encode() + data)
        await w.drain()
        buf = b""
        while b"event: token" not in buf:
            chunk = await asyncio.wait_for(r.read(512), IO_S)
            assert chunk, "stream closed before its first token"
            buf += chunk
        bystander = asyncio.ensure_future(_generate(
            p, bystander_prompt, 24, stream=True))
        w.close()                                  # mid-stream disconnect
        code, _, payload = await asyncio.wait_for(bystander, IO_S)
        assert code == 200
        await _until_idle(srv)
        rep = await srv.shutdown()
        return rep, payload

    rep, payload = _run(body, deadline_ms=1e9, batch_size=2)
    assert rep["clean"], rep
    assert rep["terminal"]["cancelled"] == 1
    assert rep["terminal"]["finished"] == 1
    assert _tokens(payload) == [int(t) for t in undisturbed.out]


def test_disconnect_fault_point_is_deterministic():
    """The server-level ``disconnect`` fault force-drops the stream
    after N events — same cancel path, no real client needed."""
    fi = FaultInjector(seed=0)
    fi.inject("disconnect", at=2)                  # drop after 2 events

    async def body(srv):
        code, _, payload = await _generate(srv.port, [5, 5, 5], 64,
                                           stream=True)
        assert code == 200
        await _until_idle(srv)
        rep = await srv.shutdown()
        assert fi.fired("disconnect") == 1
        return rep, payload
    rep, payload = _run(body, deadline_ms=1e9, faults=fi)
    assert rep["terminal"]["cancelled"] == 1 and rep["clean"], rep
    assert len(_sse_parse(payload)) >= 1           # stream died mid-way


def test_slow_consumer_buffer_bounded_and_coalesces():
    """With the writer slowed, pending flushes cap at stream_buffer and
    overflow merges into multi-token events — every token still arrives
    exactly once, in order."""
    fi = FaultInjector(seed=0)
    fi.inject("slow_consumer", every=1, delay_s=0.05)

    async def body(srv):
        code, _, payload = await _generate(srv.port, [3, 1, 4], 48,
                                           stream=True)
        assert code == 200
        rep = await srv.shutdown()
        return rep, payload
    rep, payload = _run(body, deadline_ms=1e9, faults=fi,
                        server_kw={"stream_buffer": 4})
    assert rep["clean"], rep
    events = _sse_parse(payload)
    toks = _tokens(payload)
    done = [d for ev, d in events if ev == "done"][0]
    assert toks == done["tokens"] and len(toks) == 48
    assert done["coalesced_flushes"] > 0           # buffer did overflow
    token_events = [d for ev, d in events if ev == "token"]
    assert any(len(d["tokens"]) > 1 for d in token_events)
    assert len(token_events) < 48


def test_token_stream_buffer_never_exceeds_limit():
    async def body():
        loop = asyncio.get_running_loop()
        ts = _TokenStream(loop, limit=4)
        for t in range(100):
            ts._feed(t)
            assert len(ts._pending) <= 4
        got = []
        ts._finish(Request(prompt=np.zeros(1, np.int32)))  # any terminal
        while (u := await asyncio.wait_for(ts.next(), IO_S)) is not None:
            got.append(u)
        assert [t for u in got for t in u] == list(range(100))
        assert ts.coalesced > 0
    asyncio.run(asyncio.wait_for(body(), BODY_S))


# ---------------------------------------------------------------------------
# Graceful drain
# ---------------------------------------------------------------------------

def test_drain_under_load_reaches_quiescence_zero_leaks():
    """Shutdown with streams in flight: every request terminal,
    sum(terminal) == submitted, allocator check clean."""
    async def body(srv):
        inflight = [asyncio.ensure_future(
            _generate(srv.port, [i + 1, i + 2, i + 3], 32, stream=True))
            for i in range(5)]
        await asyncio.sleep(0.3)                   # let some admit
        rep = await srv.shutdown()
        results = await asyncio.wait_for(
            asyncio.gather(*inflight, return_exceptions=True), IO_S)
        ok = [r for r in results if not isinstance(r, Exception)]
        return rep, ok
    rep, ok = _run(body, deadline_ms=1e9, batch_size=2,
                   server_kw={"drain_timeout_s": 60.0})
    assert rep["clean"], rep
    assert rep["all_terminal"] and rep["terminal_sum"] == rep["submitted"]
    assert rep["allocator_clean"]
    finished = [r for r in ok if r[0] == 200 and
                any(ev == "done" and d.get("state") == "finished"
                    for ev, d in _sse_parse(r[2]))]
    assert finished, "drain should let in-flight streams finish"


def test_drain_timeout_cancels_stragglers():
    """At drain_timeout_s the requests still in flight are cancelled and
    the report is clean (docs/server.md, drain). The drain clock starts
    when the listener closes, not when the open stream ends."""
    fi = FaultInjector(seed=0)
    fi.inject("slow_step", every=1, delay_s=0.05)  # ~50ms per step

    async def body(srv):
        task = asyncio.ensure_future(
            _generate(srv.port, [1, 2, 3], 100, stream=True))
        await asyncio.sleep(0.5)                   # long request admitted
        rep = await srv.shutdown()
        code, _, payload = await asyncio.wait_for(task, IO_S)
        return rep, code, payload
    rep, code, payload = _run(body, deadline_ms=1e9, faults=fi,
                              server_kw={"drain_timeout_s": 0.1})
    assert rep["cancelled_stragglers"]
    assert rep["clean"], rep
    assert rep["terminal"]["cancelled"] >= 1
    done = [d for ev, d in _sse_parse(payload) if ev == "done"]
    assert code == 200 and done[0]["state"] == "cancelled"
    assert len(done[0]["tokens"]) < 100


# ---------------------------------------------------------------------------
# Engine supervisor: failed / stuck steps
# ---------------------------------------------------------------------------

def test_supervisor_failed_step_fails_one_resumes_rest_bit_identical():
    """An injected step failure fails exactly the blamed request;
    bystanders requeue (no retry-budget charge) and finish with the
    same tokens as an undisturbed run."""
    prompts = [np.array([2, 7, 1, 8], np.int32),
               np.array([3, 1, 4, 1], np.int32)]
    eng0 = _demo(deadline_ms=1e9, batch_size=2)
    base = eng0.generate([Request(prompt=p.copy(), max_new=16)
                          for p in prompts])
    fi = FaultInjector(seed=0)
    fi.inject("failed_step", at=2, lane=0, error="injected")

    async def body(srv):
        outs = await asyncio.gather(*[
            _generate(srv.port, pr, 16) for pr in prompts])
        rep = await srv.shutdown()
        assert fi.fired("failed_step") == 1
        return rep, outs
    rep, outs = _run(body, deadline_ms=1e9, batch_size=2, faults=fi)
    assert rep["supervisor_restarts"] == 1
    assert rep["terminal"]["failed"] == 1
    assert rep["terminal"]["finished"] == 1
    assert rep["clean"], rep
    by_state = {o[2]["state"]: o for o in outs}
    assert set(by_state) == {"failed", "finished"}
    code, _, failed = by_state["failed"]
    assert code == 500 and "supervisor" in failed["error"]
    code, _, fin = by_state["finished"]
    twins = [[int(t) for t in b.out] for b in base]
    assert fin["tokens"] in twins                  # bit-identical resume
    assert rep["terminal"]["preempted"] == 0       # no retry-budget charge


def test_supervisor_watchdog_unsticks_stuck_step():
    """A stuck step (cooperative hang) is detected by the watchdog,
    aborted, and the loop restarts; queued work still completes."""
    fi = FaultInjector(seed=0)
    fi.inject("stuck_step", at=1, hang_s=30.0)

    async def body(srv):
        outs = await asyncio.gather(
            _generate(srv.port, [1, 2, 3], 8),
            _generate(srv.port, [4, 5, 6], 8))
        rep = await srv.shutdown()
        assert fi.fired("stuck_step") == 1
        return rep, outs
    rep, outs = _run(body, deadline_ms=1e9, batch_size=1, faults=fi,
                     server_kw={"watchdog_timeout_s": 0.2,
                                "watchdog_poll_s": 0.05})
    assert rep["supervisor_restarts"] == 1
    failed = [o for _, _, o in outs if o["state"] == "failed"]
    assert failed and "watchdog" in failed[0]["error"]
    assert sorted(o["state"] for _, _, o in outs) == ["failed", "finished"]
    assert rep["clean"], rep


def test_supervisor_restart_metrics_and_queue_survival():
    """Queued (not yet admitted) requests survive a restart untouched."""
    fi = FaultInjector(seed=0)
    fi.inject("failed_step", at=0, error="boom")

    async def body(srv):
        outs = await asyncio.gather(*[
            _generate(srv.port, [i + 1] * 3, 8) for i in range(3)])
        rep = await srv.shutdown()
        return rep, outs
    rep, outs = _run(body, deadline_ms=1e9, batch_size=1, faults=fi)
    # at=0 fires before anything is admitted: nothing to blame, the loop
    # just restarts and every request completes
    assert rep["supervisor_restarts"] == 1
    assert rep["terminal"]["finished"] == 3
    assert rep["clean"], rep
    assert all(o["state"] == "finished" for _, _, o in outs)


# ---------------------------------------------------------------------------
# Endpoints
# ---------------------------------------------------------------------------

def test_health_metrics_statz_endpoints():
    async def body(srv):
        p = srv.port
        code, _, body_ = await _http(p, "GET", "/healthz")
        assert code == 200 and body_ == b"ok\n"
        code, _, body_ = await _http(p, "GET", "/readyz")
        assert code == 200 and json.loads(body_)["ready"]
        await _generate(p, [1, 2], 4)
        code, _, metrics = await _http(p, "GET", "/metrics")
        assert code == 200
        for needle in (b"serving_requests_shed_total",
                       b"serving_preemptions_total",
                       b"serving_supervisor_restarts_total",
                       b"http_requests_total",
                       b"serving_requests_submitted_total"):
            assert needle in metrics, needle
        code, _, statz = await _http(p, "GET", "/statz")
        st = json.loads(statz)
        assert code == 200 and st["submitted"] == 1
        code, _, _ = await _http(p, "GET", "/nope")
        assert code == 404
        code, _, _ = await _http(p, "POST", "/v1/generate",
                                 {"prompt": "not-ints"})
        assert code == 400
        rep = await srv.shutdown()
        assert rep["clean"]
    _run(body)


# ---------------------------------------------------------------------------
# Across packages: the port's stream against the JAX engine
# ---------------------------------------------------------------------------

TINY = dict(name="demo", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, attn_chunk=16)


def test_sse_stream_equals_jax_engine_generate():
    """The demo config's JAX weights (PRNGKey(0)) in both packages: the
    port's server streams, over SSE, the tokens the JAX engine's
    ``generate`` gives on the same paged engine settings (f32, no
    quantization; tokens exactly equal)."""
    jp = japi.init(jax.random.PRNGKey(0), JArch(**TINY))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    kw = dict(batch_size=2, max_len=128, scheduler="continuous",
              kv_layout="paged", page_size=32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (5, 37, 20)]
    news = (12, 9, 16)
    jreqs = [JRequest(prompt=p, max_new=n) for p, n in zip(prompts, news)]
    JEngine(jp, JArch(**TINY), JQM.off(), **kw).generate(jreqs)
    teng = TEngine(tp, TArch(**TINY), TQM.off(), device="cpu", **kw)

    async def body(srv):
        outs = await asyncio.gather(*[
            _generate(srv.port, p, n, stream=True)
            for p, n in zip(prompts, news)])
        rep = await srv.shutdown()
        return rep, outs
    rep, outs = _run(body, engine=teng)
    assert rep["clean"] and rep["terminal"]["finished"] == 3, rep
    for (code, _, payload), jr in zip(outs, jreqs):
        assert code == 200
        assert _tokens(payload) == [int(t) for t in jr.out]


# ---------------------------------------------------------------------------
# The command line: the demo server process, the unchanged example client
# ---------------------------------------------------------------------------

def test_server_process_drives_the_example_client_and_drains_on_sigterm():
    """``python -m repro_torch.serving.server --device cpu --port 0``
    serves ``examples/client.py`` unchanged; SIGTERM drains it and the
    process exits 0 with a clean drain report."""
    import os
    import pathlib
    import signal
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "OMP_NUM_THREADS": "1"}
    srv = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serving.server", "--device",
         "cpu", "--port", "0"], stdout=subprocess.PIPE, text=True, env=env)
    try:
        line = srv.stdout.readline()        # "serving on http://host:port"
        assert line.startswith("serving on http://"), line
        port = line.strip().rsplit(":", 1)[1]
        cli = subprocess.run(
            [sys.executable, str(root / "examples" / "client.py"), "--port",
             port, "--prompt", "1,2,3", "--max-new", "8", "--timeout-s",
             "60"], capture_output=True, text=True, env=env, timeout=120)
        assert cli.returncode == 0, cli.stderr
        assert "done: state=finished n_tokens=8" in cli.stdout
        srv.send_signal(signal.SIGTERM)
        out, _ = srv.communicate(timeout=60)
        assert srv.returncode == 0, out
        report = json.loads(out.split("drain report: ", 1)[1])
        assert report["clean"] and report["terminal"]["finished"] == 1
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait(timeout=30)


def test_statz_answers_while_the_engine_is_busy():
    """The supervisor hands the engine lock to a waiting caller between
    two steps: ``/statz`` answers while a long request is still decoding,
    instead of after it ends."""
    fi = FaultInjector(seed=0)
    fi.inject("slow_step", every=1, delay_s=0.05)  # ~50ms per step

    async def body(srv):
        task = asyncio.ensure_future(
            _generate(srv.port, [1, 2, 3], 100, stream=True))
        await asyncio.sleep(0.3)                   # the request decodes
        code, _, statz = await _http(srv.port, "GET", "/statz")
        st = json.loads(statz)
        await asyncio.wait_for(task, IO_S)
        rep = await srv.shutdown()
        return code, st, rep
    code, st, rep = _run(body, deadline_ms=1e9, faults=fi)
    assert code == 200 and st["submitted"] == 1
    assert st["terminal"]["finished"] == 0         # answered mid-request
    assert rep["clean"] and rep["terminal"]["finished"] == 1, rep
