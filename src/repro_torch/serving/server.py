"""Overload-safe asyncio HTTP/SSE front end over the port's serving engine
(``repro.serving.server`` ported: the same protocol, so a client of the JAX
package's server drives this one unchanged).

The Engine (``repro_torch.serving.engine``) is a library loop: blocking
``submit``/``step``/``drain`` calls on one thread. Production serving is
an async *process* — this module is the boundary layer that makes the
difference (``docs/server.md`` has the full protocol):

* :class:`EngineSupervisor` — owns the engine on a dedicated worker
  thread (every engine call goes through one lock; the asyncio loop
  never blocks on a decode step). The worker drains a thread-safe
  control queue (cancellations) *before every step* — a client
  disconnect cancels its request within one engine step — and runs the
  step under the ``failed_step`` / ``stuck_step`` server fault points.
  When a step raises, the supervisor **fails the poisoned lane**
  (terminal FAILED — re-running it would poison the restarted loop the
  same way), **requeues every bystander lane** without charging retry
  budget (they resume by replay with their uninterrupted tokens), and
  keeps stepping. The server-side watchdog task flags a stalled step
  and fires :meth:`EngineSupervisor.abort_current_step` — the injected
  ``stuck_step`` hang honors it cooperatively; a wedged kernel cannot be
  interrupted from Python, so the watchdog acts between steps and its
  job there is *detection* (readiness flips, the operator restarts the
  process). Every CUDA launch happens on the worker thread, on the
  default stream; the thread is a daemon and :meth:`stop` joins it with
  a timeout.

* :class:`Server` — stdlib-asyncio HTTP/1.1 server (no third-party web
  framework; one connection per request, ``Connection: close``):

  - ``POST /v1/generate`` — submit a request; ``"stream": true`` (the
    default) responds as Server-Sent Events (``event: token`` per
    flush, a final ``event: done`` carrying the terminal state),
    otherwise one JSON body at completion.
  - **Admission control**: ``Engine.submit`` sheds over-limit requests
    (``SchedulingPolicy`` caps, terminal SHED state); the server maps
    :class:`ShedError` to ``429`` with ``Retry-After`` (integer
    seconds, RFC-shaped) and ``X-Retry-After-S`` (exact float) derived
    from the policy backoff schedule. Shedding is loud by design —
    never a silent requeue.
  - **Graceful drain**: SIGTERM/SIGINT flips ``/readyz`` to 503,
    closes the listener, rejects new generates with 503 +
    ``Retry-After``, lets in-flight requests run to a terminal state
    (cancelling stragglers at ``drain_timeout_s``), then stops the
    worker and emits a drain report asserting ``sum(terminal) ==
    submitted`` and a clean ``BlockAllocator.check()`` — zero leaked
    pages is an exit-code property, not a hope. The drain clock starts
    when the listener closes: the wait for open connections to end
    (``asyncio.Server.wait_closed``, which on Python 3.12.1 and later
    waits for every connection) comes after the drain, bounded, so an
    open stream cannot hold the drain until it finishes on its own.
  - **Disconnect propagation**: a dropped SSE connection (EOF on the
    socket or a failed write) enqueues ``Engine.cancel`` — the lane
    frees and its pages deref mid-stream; bystander lanes are
    untouched.
  - **Bounded streaming**: each SSE stream buffers at most
    ``stream_buffer`` pending flushes; a slower consumer degrades to
    *coalesced flushes* (one event carrying many tokens — data is
    never dropped, memory never grows past the cap) counted by
    ``serving_stream_coalesced_flushes_total``.
  - ``GET /healthz`` (process liveness), ``GET /readyz`` (load-balancer
    readiness; 503 while draining), ``GET /metrics`` (Prometheus text
    from the engine's registry), ``GET /statz`` (``Engine.stats()`` as
    JSON).

``python -m repro_torch.serving.server [--device cpu]`` starts a demo
server on a tiny random-init model (the chaos-harness config) on the card,
or on the CPU when asked. All request/response payloads speak token ids;
tokenization is out of scope for the reproduction.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import dataclasses
import json
import math
import signal
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.policy import (RequestState, SchedulingPolicy,
                                        ShedError, TERMINAL_STATES)
from repro_torch.serving.sampling import SamplingParams

__all__ = ["EngineSupervisor", "Server", "ServerConfig", "StuckStepError",
           "demo_engine", "serve"]


class StuckStepError(RuntimeError):
    """An engine step exceeded the watchdog budget (injected via the
    ``stuck_step`` fault point; see module docstring for why a genuine
    device hang is detect-only)."""


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Front-end knobs (``Server(config=...)``); engine-side admission
    caps live on ``SchedulingPolicy``, not here."""

    host: str = "127.0.0.1"
    port: int = 8100                  # 0 = ephemeral (tests / CI smoke)
    stream_buffer: int = 32           # pending SSE flushes before coalescing
    drain_timeout_s: float = 30.0     # SIGTERM -> cancel stragglers
    watchdog_timeout_s: float = 10.0  # step wall-clock budget
    watchdog_poll_s: float = 0.25
    worker_poll_s: float = 0.02       # idle worker wakeup granularity
    max_body_bytes: int = 1 << 20
    retry_after_drain_s: float = 1.0  # Retry-After on 503 while draining


# ---------------------------------------------------------------------------
# Engine supervisor: worker thread + failure recovery
# ---------------------------------------------------------------------------

class EngineSupervisor:
    """Runs the engine loop on a worker thread and survives step failures.

    Thread contract: every engine touch — submit, cancel, step, stats —
    happens under ``self._lock``. The asyncio side calls :meth:`submit`
    through an executor (it can block on a running step) and
    :meth:`cancel` through the control queue (applied before the next
    step). Completion callbacks registered at submit fire on the worker
    thread *after* the lock is released — marshal back to the loop with
    ``call_soon_threadsafe`` (the server's token streams do).

    The lock is handed over between steps: a caller registers before it
    waits (:meth:`_caller_lock`), and the worker, done with a step, lets
    every registered caller in before it takes the lock again. Without
    that, the worker — which takes the lock again the moment it lets go —
    kept a submit, ``/statz`` or ``/metrics`` waiting until the engine
    went idle.
    """

    def __init__(self, engine: Engine,
                 faults: Optional[FaultInjector] = None,
                 worker_poll_s: float = 0.02):
        self.engine = engine
        self.faults = faults
        self.worker_poll_s = worker_poll_s
        self._lock = threading.RLock()
        self._callers = 0                    # waiting for the lock
        self._callers_lock = threading.Lock()
        self._control: "collections.deque" = collections.deque()
        self._live: Dict[str, Tuple[Request, Optional[Callable]]] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._abort = threading.Event()      # watchdog -> stuck-step hang
        self._heartbeat = time.monotonic()
        self._in_step = False
        self._blame_lane: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self.restarts = 0
        self._c_restarts = engine.metrics.counter(
            "serving_supervisor_restarts_total",
            help="engine loop restarts after a stuck/failed step: the "
                 "poisoned lane's request is terminal-FAILED, bystander "
                 "lanes requeue and resume with their uninterrupted "
                 "tokens (docs/server.md)")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._worker,
                                        name="engine-supervisor",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout_s)

    # -- asyncio-facing API ------------------------------------------------

    def submit(self, req: Request,
               on_done: Optional[Callable] = None) -> Request:
        """Submit under the engine lock (call via an executor from the
        event loop — a decode step may hold the lock for milliseconds).
        Raises :class:`ShedError` untouched; registers ``on_done``
        atomically with the submit so a fast completion cannot race past
        the registration."""
        with self._caller_lock():
            self.engine.submit(req)          # may raise ShedError
            self._live[req.request_id] = (req, on_done)
        self._wake.set()
        return req

    def cancel(self, request_id: str) -> None:
        """Thread-safe cancellation; applied before the next engine step
        (the within-one-step guarantee the disconnect tests pin)."""
        self._control.append(request_id)
        self._wake.set()

    def idle(self) -> bool:
        """No request queued or running and no cancel pending. Never
        blocks the event loop: a worker that holds the lock is inside a
        step (or an admission), so it is not idle. A blocking acquire here
        would wait out every step — the worker takes the lock again as it
        releases it — and hold the drain timer until the work ends on its
        own."""
        if not self._lock.acquire(blocking=False):
            return False
        try:
            return not self.engine.busy and not self._control
        finally:
            self._lock.release()

    def live_ids(self) -> List[str]:
        """Ids of the submitted requests not yet terminal, from a snapshot
        taken without the lock (one dict copy; a request that ends just
        after it makes its cancel a no-op)."""
        return [rid for rid, (r, _) in self._live.copy().items()
                if r.state not in TERMINAL_STATES]

    def stats(self) -> dict:
        with self._caller_lock():
            return self.engine.stats()

    def render_metrics(self) -> str:
        with self._caller_lock():
            return self.engine.metrics.render_prometheus()

    @contextlib.contextmanager
    def _caller_lock(self):
        """The engine lock for a caller off the worker thread, registered
        while it waits so the worker lets it in before the next step."""
        with self._callers_lock:
            self._callers += 1
        acquired = False
        try:
            self._lock.acquire()
            acquired = True
            with self._callers_lock:
                self._callers -= 1
            yield
        finally:
            if acquired:
                self._lock.release()
            else:
                with self._callers_lock:
                    self._callers -= 1

    def _let_callers_in(self) -> None:
        """Worker, between steps: wait while callers are queued for the
        lock (each holds it for a submit or a stats read)."""
        while self._callers and not self._stop.is_set():
            time.sleep(0.0002)

    # -- watchdog interface ------------------------------------------------

    def stalled(self, timeout_s: float) -> bool:
        return (self._in_step
                and time.monotonic() - self._heartbeat > timeout_s)

    def abort_current_step(self) -> None:
        self._abort.set()

    # -- worker ------------------------------------------------------------

    def _worker(self) -> None:
        while not self._stop.is_set():
            self._drain_control()
            with self._lock:
                busy = self.engine.busy
            if not busy:
                self._wake.wait(self.worker_poll_s)
                self._wake.clear()
                continue
            try:
                self._heartbeat = time.monotonic()
                self._in_step = True
                self._fire_step_faults()
                with self._lock:
                    done = self.engine.step()
            except Exception as exc:            # noqa: BLE001 — supervisor
                self._in_step = False
                self._recover(exc)
                continue
            self._in_step = False
            for req in done:
                self._notify_done(req)
            self._let_callers_in()

    def _drain_control(self) -> None:
        while self._control:
            rid = self._control.popleft()
            with self._lock:
                ok = self.engine.cancel(rid)
                entry = self._live.get(rid)
            if ok and entry is not None:
                self._notify_done(entry[0])

    def _fire_step_faults(self) -> None:
        fi = self.faults
        if fi is None:
            return
        hit = fi.fire("failed_step")
        if hit is not None:
            self._blame_lane = hit.get("lane")
            raise RuntimeError(hit.get("error", "injected step failure"))
        hit = fi.fire("stuck_step")
        if hit is not None:
            self._blame_lane = hit.get("lane")
            hang_s = float(hit.get("hang_s", 30.0))
            # cooperative hang: wakes the moment the watchdog aborts, so
            # the test pins detection latency, not the full hang
            aborted = self._abort.wait(hang_s)
            raise StuckStepError(
                "step aborted by watchdog" if aborted
                else f"step stuck {hang_s:g}s (watchdog never fired)")

    def _recover(self, exc: Exception) -> None:
        """Fail the poisoned lane, requeue bystanders, keep stepping."""
        done: List[Request] = []
        with self._lock:
            lanes = [i for i, s in enumerate(self.engine._slots)
                     if s is not None]
            blame = self._blame_lane
            self._blame_lane = None
            if blame not in lanes:
                # no attribution (real failures can't name a lane):
                # deterministically blame the lowest occupied lane
                blame = lanes[0] if lanes else None
            if blame is not None:
                failed = self.engine.fail_lane(
                    blame, f"step failed under supervisor: {exc}")
                if failed is not None:
                    done.append(failed)
                for i in lanes:
                    if i != blame:
                        self.engine.requeue_lane(
                            i, "supervisor restart after failed step")
        self.restarts += 1
        self._c_restarts.inc()
        self._abort.clear()
        for req in done:
            self._notify_done(req)

    def _notify_done(self, req: Request) -> None:
        entry = self._live.pop(req.request_id, None)
        if entry is not None and entry[1] is not None:
            try:
                entry[1](req)
            except Exception:                   # noqa: BLE001 — callback
                pass                            # never kills the worker


# ---------------------------------------------------------------------------
# Bounded SSE token stream
# ---------------------------------------------------------------------------

class _TokenStream:
    """Per-connection token buffer between the worker thread and one SSE
    writer. Holds at most ``limit`` pending flush units; overflow merges
    every pending unit into one *coalesced* flush (tokens are never
    dropped — a slow consumer gets fewer, fatter events instead of
    unbounded server memory). All mutation happens on the event loop via
    ``call_soon_threadsafe``."""

    def __init__(self, loop: asyncio.AbstractEventLoop, limit: int):
        self._loop = loop
        self.limit = max(int(limit), 1)
        self._pending: "collections.deque[List[int]]" = collections.deque()
        self._event = asyncio.Event()
        self._done: Optional[Request] = None
        self.coalesced = 0

    # worker-thread side -----------------------------------------------------

    def feed_threadsafe(self, tok: int) -> None:
        self._loop.call_soon_threadsafe(self._feed, int(tok))

    def done_threadsafe(self, req: Request) -> None:
        self._loop.call_soon_threadsafe(self._finish, req)

    # event-loop side --------------------------------------------------------

    def _feed(self, tok: int) -> None:
        if len(self._pending) >= self.limit:
            merged: List[int] = []
            while self._pending:
                merged.extend(self._pending.popleft())
            merged.append(tok)
            self._pending.append(merged)
            self.coalesced += 1
        else:
            self._pending.append([tok])
        self._event.set()

    def _finish(self, req: Request) -> None:
        self._done = req
        self._event.set()

    async def next(self) -> Optional[List[int]]:
        """Next flush unit (>=1 tokens), or None once the request is
        terminal and the buffer is drained."""
        while True:
            if self._pending:
                return self._pending.popleft()
            if self._done is not None:
                return None
            self._event.clear()
            await self._event.wait()

    @property
    def result(self) -> Optional[Request]:
        return self._done


# ---------------------------------------------------------------------------
# HTTP server
# ---------------------------------------------------------------------------

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 499: "Client Closed Request",
            500: "Internal Server Error", 503: "Service Unavailable",
            504: "Gateway Timeout"}

_STATE_HTTP = {RequestState.FINISHED: 200, RequestState.TIMED_OUT: 504,
               RequestState.CANCELLED: 499}


class Server:
    """See module docstring. ``Server(engine).serve_forever()`` is the
    whole lifecycle: bind, serve, drain on SIGTERM/SIGINT, report. With
    no engine it serves :func:`demo_engine` on ``device`` (None: the
    card)."""

    def __init__(self, engine: Optional[Engine] = None,
                 config: ServerConfig = ServerConfig(),
                 faults: Optional[FaultInjector] = None, device=None):
        if engine is None:
            engine = demo_engine(faults=faults, device=device)
        self.engine = engine
        self.config = config
        self.faults = faults
        self.sup = EngineSupervisor(engine, faults=faults,
                                    worker_poll_s=config.worker_poll_s)
        self.draining = False
        self.port: Optional[int] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._watchdog_task: Optional[asyncio.Task] = None
        self._active_streams = 0
        reg = engine.metrics
        self._reg = reg
        self._g_streams = reg.gauge(
            "http_active_streams",
            help="SSE connections currently streaming tokens")
        self._c_disconnects = reg.counter(
            "serving_client_disconnects_total",
            help="SSE connections dropped mid-stream; each cancels its "
                 "request within one engine step (docs/server.md)")
        self._c_coalesced = reg.counter(
            "serving_stream_coalesced_flushes_total",
            help="bounded-buffer overflows degraded to one multi-token "
                 "flush (slow SSE consumers; no tokens dropped)")

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self.sup.start()
        self._server = await asyncio.start_server(
            self._handle, self.config.host, self.config.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._watchdog_task = asyncio.ensure_future(self._watchdog())

    async def serve_forever(self, install_signals: bool = True) -> dict:
        """Serve until SIGTERM/SIGINT, then drain; returns the drain
        report (also what ``__main__`` turns into the exit code)."""
        await self.start()
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        if install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                loop.add_signal_handler(sig, stop.set)
        print(f"serving on http://{self.config.host}:{self.port}",
              flush=True)
        await stop.wait()
        return await self.shutdown()

    async def shutdown(self) -> dict:
        """Graceful drain (module docstring step by step)."""
        self.draining = True
        if self._server is not None:
            self._server.close()            # stop listening; streams go on
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.config.drain_timeout_s
        cancelled_stragglers = False
        while not (self.sup.idle() and self._active_streams == 0):
            if loop.time() >= deadline and not cancelled_stragglers:
                for rid in self.sup.live_ids():
                    self.sup.cancel(rid)
                cancelled_stragglers = True
                deadline = loop.time() + 5.0    # grace for the cancels
            elif loop.time() >= deadline:
                break                            # report the leak below
            await asyncio.sleep(0.02)
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
        self.sup.stop()
        if self._server is not None:
            # connections end once their handlers write the terminal
            # event; a peer that holds an idle socket is not waited for
            await asyncio.wait({asyncio.ensure_future(
                self._server.wait_closed())}, timeout=5.0)
        return self.drain_report(
            cancelled_stragglers=cancelled_stragglers)

    def drain_report(self, cancelled_stragglers: bool = False) -> dict:
        """Quiescence audit: every submitted request terminal, allocator
        invariants clean. ``clean`` is the exit-code bit."""
        st = self.engine.stats()
        terminal_sum = sum(st["terminal"].values())
        allocator_clean = True
        allocator = None
        if getattr(self.engine, "kv_layout", None) == "paged":
            try:
                allocator = self.engine._alloc.check()
            except AssertionError as exc:
                allocator_clean = False
                allocator = {"error": str(exc)}
            else:
                allocator_clean = allocator["in_use"] == 0
        all_terminal = terminal_sum == st["submitted"]
        return {
            "submitted": st["submitted"],
            "terminal": st["terminal"],
            "terminal_sum": terminal_sum,
            "all_terminal": all_terminal,
            "allocator": allocator,
            "allocator_clean": allocator_clean,
            "supervisor_restarts": self.sup.restarts,
            "cancelled_stragglers": cancelled_stragglers,
            "clean": all_terminal and allocator_clean,
        }

    async def _watchdog(self) -> None:
        while True:
            await asyncio.sleep(self.config.watchdog_poll_s)
            if self.sup.stalled(self.config.watchdog_timeout_s):
                self.sup.abort_current_step()

    # -- HTTP plumbing -----------------------------------------------------

    def _count(self, route: str, code: int) -> None:
        self._reg.counter(
            "http_requests_total", {"route": route, "code": str(code)},
            help="HTTP requests by route and status code").inc()

    @staticmethod
    def _response(code: int, body: bytes,
                  content_type: str = "application/json",
                  extra: Optional[dict] = None) -> bytes:
        head = [f"HTTP/1.1 {code} {_REASONS.get(code, 'Unknown')}",
                f"Content-Type: {content_type}",
                f"Content-Length: {len(body)}",
                "Connection: close"]
        for k, v in (extra or {}).items():
            head.append(f"{k}: {v}")
        return ("\r\n".join(head) + "\r\n\r\n").encode() + body

    def _json(self, code: int, obj: dict,
              extra: Optional[dict] = None) -> bytes:
        return self._response(code, (json.dumps(obj) + "\n").encode(),
                              extra=extra)

    async def _read_request(self, reader: asyncio.StreamReader):
        """(method, path, headers, body) or an error-response bytes."""
        line = await reader.readline()
        if not line:
            return None
        try:
            method, target, _version = line.decode("latin1").split(None, 2)
        except ValueError:
            return self._json(400, {"error": "malformed request line"})
        headers: Dict[str, str] = {}
        total = len(line)
        while True:
            h = await reader.readline()
            total += len(h)
            if total > 64 * 1024:
                return self._json(400, {"error": "headers too large"})
            if h in (b"\r\n", b"\n", b""):
                break
            if b":" in h:
                k, v = h.decode("latin1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
        body = b""
        n = int(headers.get("content-length", "0") or "0")
        if n > self.config.max_body_bytes:
            return self._json(413, {
                "error": f"body {n} bytes > max {self.config.max_body_bytes}"})
        if n:
            body = await reader.readexactly(n)
        return method.upper(), target.split("?", 1)[0], headers, body

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            parsed = await self._read_request(reader)
            if parsed is None:
                return
            if isinstance(parsed, bytes):       # parse-level error response
                writer.write(parsed)
                await writer.drain()
                return
            method, path, headers, body = parsed
            await self._route(method, path, body, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _route(self, method: str, path: str, body: bytes,
                     reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        if path == "/healthz" and method == "GET":
            self._count(path, 200)
            writer.write(self._response(200, b"ok\n", "text/plain"))
        elif path == "/readyz" and method == "GET":
            if self.draining:
                self._count(path, 503)
                writer.write(self._json(
                    503, {"ready": False, "reason": "draining"},
                    extra={"Retry-After": _retry_after_header(
                        self.config.retry_after_drain_s)}))
            else:
                self._count(path, 200)
                writer.write(self._json(200, {"ready": True}))
        elif path == "/metrics" and method == "GET":
            loop = asyncio.get_running_loop()
            text = await loop.run_in_executor(None, self.sup.render_metrics)
            self._count(path, 200)
            writer.write(self._response(
                200, text.encode(), "text/plain; version=0.0.4"))
        elif path == "/statz" and method == "GET":
            loop = asyncio.get_running_loop()
            st = await loop.run_in_executor(None, self.sup.stats)
            self._count(path, 200)
            writer.write(self._json(200, st))
        elif path == "/v1/generate":
            if method != "POST":
                self._count(path, 405)
                writer.write(self._json(405, {"error": "POST only"}))
            else:
                await self._generate(body, reader, writer)
                return                           # handled its own write
        else:
            self._count(path, 404)
            writer.write(self._json(404, {"error": f"no route {path}"}))
        await writer.drain()

    # -- /v1/generate ------------------------------------------------------

    def _parse_generate(self, body: bytes):
        """Request object + stream flag, or an error-response bytes."""
        try:
            data = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError) as exc:
            return self._json(400, {"error": f"bad JSON body: {exc}"})
        prompt = data.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            return self._json(400, {
                "error": "prompt must be a non-empty list of token ids"})
        sampling = None
        if any(k in data for k in ("temperature", "top_k", "top_p", "seed")):
            try:
                sampling = SamplingParams(
                    temperature=float(data.get("temperature", 0.0)),
                    top_k=int(data.get("top_k", 0)),
                    top_p=float(data.get("top_p", 1.0)),
                    seed=int(data.get("seed", 0)))
            except (TypeError, ValueError) as exc:
                return self._json(400, {"error": f"bad sampling: {exc}"})
        try:
            req = Request(
                prompt=np.asarray(prompt, np.int32),
                max_new=int(data.get("max_new", 16)),
                priority=int(data.get("priority", 0)),
                deadline_ms=(float(data["deadline_ms"])
                             if data.get("deadline_ms") is not None else None),
                ttft_deadline_ms=(float(data["ttft_deadline_ms"])
                                  if data.get("ttft_deadline_ms") is not None
                                  else None),
                sampling=sampling)
        except (TypeError, ValueError) as exc:
            return self._json(400, {"error": f"bad request: {exc}"})
        return req, bool(data.get("stream", True))

    async def _generate(self, body: bytes, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter) -> None:
        route = "/v1/generate"
        if self.draining:
            self._count(route, 503)
            writer.write(self._json(
                503, {"error": "draining: not accepting new work",
                      "retry_after_s": self.config.retry_after_drain_s},
                extra={"Retry-After": _retry_after_header(
                    self.config.retry_after_drain_s)}))
            await writer.drain()
            return
        parsed = self._parse_generate(body)
        if isinstance(parsed, bytes):
            self._count(route, 400)
            writer.write(parsed)
            await writer.drain()
            return
        req, stream = parsed
        loop = asyncio.get_running_loop()
        if stream:
            tstream = _TokenStream(loop, self.config.stream_buffer)
            req.on_token = tstream.feed_threadsafe
            on_done = tstream.done_threadsafe
        else:
            fut: "asyncio.Future[Request]" = loop.create_future()

            def on_done(r, _fut=fut, _loop=loop):
                _loop.call_soon_threadsafe(
                    lambda: None if _fut.done() else _fut.set_result(r))
        try:
            await loop.run_in_executor(None, self.sup.submit, req, on_done)
        except ShedError as exc:
            self._count(route, 429)
            writer.write(self._json(
                429, {"error": "shed", "reason": exc.reason,
                      "retry_after_s": exc.retry_after_s,
                      "request_id": exc.request.request_id},
                extra={"Retry-After": _retry_after_header(exc.retry_after_s),
                       "X-Retry-After-S": f"{exc.retry_after_s:g}"}))
            await writer.drain()
            return
        if stream:
            await self._stream_response(req, tstream, reader, writer)
        else:
            done = await fut
            code = _STATE_HTTP.get(done.state, 500)
            self._count(route, code)
            writer.write(self._json(code, _result_json(done)))
            await writer.drain()

    async def _stream_response(self, req: Request, tstream: _TokenStream,
                               reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter) -> None:
        self._count("/v1/generate", 200)
        self._active_streams += 1
        self._g_streams.set(self._active_streams)
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n")
        disc = asyncio.ensure_future(_watch_disconnect(reader))
        fi = self.faults
        events = 0
        emitted = 0
        disconnected = False
        try:
            await writer.drain()
            while True:
                nxt = asyncio.ensure_future(tstream.next())
                done_set, _ = await asyncio.wait(
                    {nxt, disc}, return_when=asyncio.FIRST_COMPLETED)
                if disc in done_set:
                    nxt.cancel()
                    disconnected = True
                    break
                toks = nxt.result()
                if toks is None:
                    break
                if fi is not None:
                    hit = fi.fire("slow_consumer")
                    if hit is not None:
                        await asyncio.sleep(float(hit.get("delay_s", 0.05)))
                    # fire() counts per flush: inject("disconnect", at=N)
                    # drops the connection before the (N+1)-th event
                    if fi.fire("disconnect") is not None:
                        writer.transport.abort()
                        disconnected = True
                        break
                payload = json.dumps({"tokens": toks, "i": emitted,
                                      "coalesced": len(toks) > 1})
                writer.write(f"event: token\ndata: {payload}\n\n".encode())
                await writer.drain()
                events += 1
                emitted += len(toks)
            if not disconnected:
                done = tstream.result
                payload = json.dumps(_result_json(
                    done, coalesced_flushes=tstream.coalesced))
                writer.write(f"event: done\ndata: {payload}\n\n".encode())
                await writer.drain()
        except (ConnectionError, OSError):
            disconnected = True
        finally:
            disc.cancel()
            if disconnected:
                self._c_disconnects.inc()
                self.sup.cancel(req.request_id)
            if tstream.coalesced:
                self._c_coalesced.inc(tstream.coalesced)
            self._active_streams -= 1
            self._g_streams.set(self._active_streams)


async def _watch_disconnect(reader: asyncio.StreamReader) -> None:
    """Resolves when the peer closes its end (EOF). Extra request bytes
    on an SSE connection are drained and ignored (Connection: close —
    there is no pipelining to honor)."""
    while True:
        chunk = await reader.read(4096)
        if not chunk:
            return


def _retry_after_header(seconds: float) -> int:
    """RFC 9110 Retry-After is integer seconds; round sub-second backoff
    up so a compliant client never retries early. The exact float rides
    in ``X-Retry-After-S``."""
    return max(int(math.ceil(seconds)), 1)


def _result_json(req: Optional[Request], **extra) -> dict:
    if req is None:                              # disconnect before done
        return {"state": None, **extra}
    return {"request_id": req.request_id,
            "state": req.state.value,
            "error": req.error,
            "n_tokens": 0 if req.out is None else int(len(req.out)),
            "tokens": [] if req.out is None else
                      [int(t) for t in req.out],
            **extra}


# ---------------------------------------------------------------------------
# Entry point: demo server on a tiny random-init model
# ---------------------------------------------------------------------------

def demo_engine(max_queue_depth: Optional[int] = None,
                admit_token_budget: Optional[int] = None,
                deadline_ms: Optional[float] = None,
                batch_size: int = 4, max_len: int = 128,
                faults: Optional[FaultInjector] = None,
                device=None) -> Engine:
    """Tiny random-init paged engine (the chaos-harness config: 2 layers,
    d_model 64, weights from a seeded ``torch.Generator``, f32, no
    quantization) on ``device`` — None means the card — backing the demo
    server; no artifact required."""
    import torch

    from repro_torch import devices
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.quantize import QuantMode
    from repro_torch.models import api
    dev = devices.resolve(device)
    cfg = ArchConfig(name="demo", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                     attn_chunk=16)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init(gen, cfg, device=dev)
    policy = SchedulingPolicy(max_queue_depth=max_queue_depth,
                              admit_token_budget=admit_token_budget,
                              deadline_ms=deadline_ms)
    return Engine(params, cfg, QuantMode.off(), batch_size=batch_size,
                  max_len=max_len, scheduler="continuous",
                  kv_layout="paged", page_size=32, policy=policy,
                  faults=faults, device=dev)


def serve(engine: Engine, config: ServerConfig = ServerConfig(),
          faults: Optional[FaultInjector] = None) -> dict:
    """Blocking convenience: run the server until SIGTERM/SIGINT and
    return the drain report (what ``launch/serve.py --http`` calls)."""
    return asyncio.run(Server(engine, config=config,
                              faults=faults).serve_forever())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="demo HTTP/SSE server on a tiny random-init model "
                    "(docs/server.md; real checkpoints go through "
                    "repro_torch.launch.serve --http)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100,
                    help="0 picks an ephemeral port (printed at startup)")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="admission cap: shed (429) past this queue depth")
    ap.add_argument("--admit-token-budget", type=int, default=None,
                    help="admission cap: shed when queued prompt+max_new "
                         "tokens would exceed this")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default end-to-end deadline for requests")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs: the CUDA card, or the "
                         "CPU with the kernels' plain PyTorch versions")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--drain-timeout-s", type=float, default=30.0)
    args = ap.parse_args(argv)
    eng = demo_engine(max_queue_depth=args.max_queue_depth,
                      admit_token_budget=args.admit_token_budget,
                      deadline_ms=args.deadline_ms,
                      batch_size=args.batch_size, max_len=args.max_len,
                      device=args.device)
    report = serve(eng, ServerConfig(host=args.host, port=args.port,
                                     drain_timeout_s=args.drain_timeout_s))
    print("drain report: " + json.dumps(report), flush=True)
    return 0 if report["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
