"""Request-lifecycle policy layer for the serving engine (a copy of
``repro.serving.policy``, kept so the port imports nothing of ``repro``).

The engine (``repro_torch.serving.engine``) executes requests; this module
decides *which* request runs and *when one must stop*:

* :class:`RequestState` — the lifecycle state machine. Every submitted
  request ends in exactly one terminal state (``docs/robustness.md`` has
  the full diagram):

  .. code-block:: text

      submit ─▶ QUEUED ──admit──▶ RUNNING ──▶ FINISHED  (EOS / budget)
        │         │  ▲               │ ├────▶ CANCELLED (Engine.cancel)
        │         │  └──requeue──────┤ ├────▶ TIMED_OUT (deadline)
        │         │  (retry+backoff) │ └────▶ FAILED    (NaN / never fits)
        │         ├──▶ CANCELLED     └─────▶ PREEMPTED  (retries spent)
        │         └──▶ TIMED_OUT
        └──▶ SHED   (admission control: queue/token caps — docs/server.md)

* :class:`SchedulingPolicy` — the knobs: default TTFT / end-to-end
  deadlines, the preemption switch, the retry budget and backoff for
  preempted requests, how often a decode burst is interrupted to check
  running deadlines, and the **admission-control caps**
  (``max_queue_depth`` / ``max_queue_depth_per_priority`` /
  ``admit_token_budget``) that turn overload into descriptive
  :class:`ShedError` rejections instead of unbounded queue growth.

* :class:`RequestQueue` — the admission queue: strict priority order
  (higher ``Request.priority`` first), FIFO within a priority level,
  re-admissions (preempted requests) ahead of their peers, and
  *backoff holds* — a requeued request is invisible to :meth:`pop`
  until its ``not_before`` stamp passes, so a preemption storm cannot
  thrash the same pages every step. Cancelled / expired entries are
  dropped lazily (the engine flips ``Request.state``; the queue skips
  anything no longer ``QUEUED``). ``max_depth`` bounds how many live
  entries :meth:`push` accepts (``push_front`` — the preemption
  requeue — is exempt: work already admitted once must be able to
  return).

* :class:`ShedError` — raised by ``Engine.submit`` when admission
  control rejects a request. Carries the (now terminal-``SHED``)
  request, the human-readable reason, and ``retry_after_s`` derived
  from the backoff schedule — the HTTP front end maps it to a 429
  with a ``Retry-After`` header (``docs/server.md``).

* :func:`pick_victim` — the preemption choice: among running requests
  below the admission's priority, evict the one with the least progress
  (fewest emitted tokens — cheapest to re-prefill, especially with the
  paged prefix cache), ties broken by lane for determinism.

Everything here is host-side, deterministic, and engine-agnostic — the
chaos tests drive it directly.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import math
from typing import Iterable, List, Optional, Tuple

__all__ = ["RequestState", "TERMINAL_STATES", "SchedulingPolicy",
           "RequestQueue", "ShedError", "pick_victim"]


class RequestState(enum.Enum):
    """Lifecycle states. ``value`` doubles as the metrics label."""

    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"        # budget exhausted / EOS — the good end
    CANCELLED = "cancelled"      # client called Engine.cancel()
    TIMED_OUT = "timed_out"      # TTFT or end-to-end deadline exceeded
    FAILED = "failed"            # non-finite logits / can never fit
    PREEMPTED = "preempted"      # evicted and out of retry budget
    SHED = "shed"                # rejected at submit by admission control

    @property
    def terminal(self) -> bool:
        return self in TERMINAL_STATES


TERMINAL_STATES = frozenset({
    RequestState.FINISHED, RequestState.CANCELLED, RequestState.TIMED_OUT,
    RequestState.FAILED, RequestState.PREEMPTED, RequestState.SHED})


class ShedError(RuntimeError):
    """``Engine.submit`` rejected the request (admission control).

    The request is already terminal (``SHED``, counted in
    ``stats()["terminal"]`` so ``sum(terminal) == submitted`` holds);
    the caller must not retry before ``retry_after_s`` — the HTTP front
    end surfaces it as ``Retry-After`` on a 429 response."""

    def __init__(self, request, reason: str, retry_after_s: float):
        super().__init__(reason)
        self.request = request
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class SchedulingPolicy:
    """Engine-wide lifecycle policy (``Engine(policy=...)``).

    ``deadline_ms`` / ``ttft_deadline_ms`` are *defaults* applied at
    :meth:`Engine.submit` to requests that do not carry their own; None
    means no deadline. The TTFT deadline runs from submit until the
    first token is sampled (it can only expire while queued / during
    prefill admission); the end-to-end deadline runs submit → done and
    is also checked between decode bursts.

    ``preemption`` gates both preemption triggers (pool exhaustion and
    priority inversion). A preempted request is requeued with
    exponential backoff (``backoff_base_s * 2**(retries-1)``) at most
    ``max_retries`` times; the next eviction lands it in the terminal
    ``PREEMPTED`` state. Retries are *cheap*, not free: re-prefill reuses
    cached prefix pages under the paged layout.

    ``deadline_burst_cap`` bounds how many decode steps the continuous
    scheduler dispatches back-to-back while any running request carries
    a deadline — deadlines are only observable between bursts, so the
    cap is the enforcement granularity (in steps). Deadline-free traffic
    keeps the unbounded burst (one host sync per lane completion).

    ``max_queue_depth`` / ``max_queue_depth_per_priority`` /
    ``admit_token_budget`` are the **admission-control caps** checked by
    ``Engine.submit`` *before* a request enters the queue; an over-limit
    request is shed (terminal ``SHED`` state + :class:`ShedError`) with
    a ``Retry-After`` from the same backoff schedule that paces
    preemption re-admissions. All three default to None — never shed —
    so library users are unaffected unless they opt in. The token budget
    counts ``len(prompt) + max_new`` over queued requests: the worst
    case KV/compute debt admission would take on. Preemption requeues
    (``RequestQueue.push_front``) bypass submit and are exempt — work
    admitted once must always be able to return.

    ``max_prefill_lanes_per_step`` caps how many queued requests the
    continuous scheduler's *paged* admission prefills together in one
    batched chunk loop per engine step (docs/serving.md). Each chunked-
    prefill dispatch then carries up to that many lanes — per-lane
    block tables and start offsets stacked on the batch axis under one
    jit signature — instead of one lane per dispatch. ``1`` restores
    strictly serial admission (the pre-batching behavior, bit-
    identical); the contiguous layout always admits serially (its
    admission runs in a single-lane scratch cache). Batched and serial
    admission emit token-identical outputs — the knob trades host
    dispatch count against per-step latency, never results."""

    deadline_ms: Optional[float] = None
    ttft_deadline_ms: Optional[float] = None
    preemption: bool = True
    max_retries: int = 3
    backoff_base_s: float = 0.02
    deadline_burst_cap: int = 4
    max_queue_depth: Optional[int] = None
    max_queue_depth_per_priority: Optional[int] = None
    admit_token_budget: Optional[int] = None
    max_prefill_lanes_per_step: int = 4

    def backoff_s(self, retries: int) -> float:
        """Hold time before a request's ``retries``-th re-admission."""
        return self.backoff_base_s * (2.0 ** max(retries - 1, 0))

    def shed_reason(self, queue: "RequestQueue", req) -> Optional[str]:
        """Why ``req`` must be shed given the queue's current load, or
        None to admit. Checked at submit time only — never re-applied to
        requeued (already-admitted) work."""
        depth = len(queue)
        if self.max_queue_depth is not None and depth >= self.max_queue_depth:
            return (f"queue full: depth {depth} >= "
                    f"max_queue_depth {self.max_queue_depth}")
        if self.max_queue_depth_per_priority is not None:
            pdepth = queue.depth(priority=req.priority)
            if pdepth >= self.max_queue_depth_per_priority:
                return (f"priority {req.priority} lane full: depth {pdepth}"
                        f" >= max_queue_depth_per_priority "
                        f"{self.max_queue_depth_per_priority}")
        if self.admit_token_budget is not None:
            load = queue.token_load()
            cost = len(req.prompt) + req.max_new
            if load + cost > self.admit_token_budget:
                return (f"token budget exhausted: queued load {load} + "
                        f"request cost {cost} > admit_token_budget "
                        f"{self.admit_token_budget}")
        return None


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs (``Engine(spec=...)``; docs/sampling.md).

    Passing a SpecConfig turns self-drafting speculative decoding on for
    every request served by the engine (continuous scheduler only):
    each engine step, an n-gram prompt-lookup draft proposes up to ``k``
    tokens per lane and one batched verify forward scores them all.

    ``k`` is the draft length — each verify step scores ``k + 1``
    positions (current token + drafts) and emits 1..k+1 tokens.
    ``ngram_max`` / ``ngram_min`` bound the context-suffix n-gram the
    prompt-lookup drafter matches (longest match wins; the most recent
    earlier occurrence supplies the continuation). Outputs are unchanged
    by any of these knobs — greedy spec decoding is token-bit-identical
    to non-spec greedy, and sampled spec preserves the sampling
    distribution; they trade only draft cost against acceptance rate."""

    k: int = 4
    ngram_max: int = 3
    ngram_min: int = 1

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"ngram_min={self.ngram_min}, ngram_max={self.ngram_max}")


class RequestQueue:
    """Priority admission queue with lazy removal and backoff holds.

    Orders by (priority desc, arrival seq asc). ``push_front`` re-admits
    ahead of same-priority peers (requeued work resumes before new work
    — no head-of-line *re*-blocking after a backpressure requeue).
    Entries whose request left the QUEUED state (cancelled, expired) are
    skipped and dropped on pop. ``pop(now)`` never returns a request
    whose ``not_before`` is in the future — those stay queued and
    :meth:`next_eligible_delay` says how long until one frees up."""

    def __init__(self, max_depth: Optional[int] = None):
        self._heap: List[Tuple[float, int, object]] = []
        self._seq = itertools.count()
        self._front_seq = itertools.count(-1, -1)
        self.max_depth = max_depth

    def full(self) -> bool:
        """True when a plain :meth:`push` would exceed ``max_depth``."""
        return self.max_depth is not None and len(self) >= self.max_depth

    def push(self, req, front: bool = False) -> None:
        if not front and self.full():
            raise OverflowError(
                f"RequestQueue full: depth {len(self)} >= "
                f"max_depth {self.max_depth}")
        seq = next(self._front_seq if front else self._seq)
        heapq.heappush(self._heap, (-float(req.priority), seq, req))

    def push_front(self, req) -> None:
        self.push(req, front=True)

    def _live(self, req) -> bool:
        return req.state == RequestState.QUEUED

    def pop(self, now: float):
        """Highest-priority eligible request, or None (empty queue or
        every live entry is in a backoff hold)."""
        held = []
        out = None
        while self._heap:
            item = heapq.heappop(self._heap)
            req = item[2]
            if not self._live(req):
                continue                      # lazy drop
            if getattr(req, "not_before", 0.0) > now:
                held.append(item)
                continue
            out = req
            break
        for item in held:
            heapq.heappush(self._heap, item)
        return out

    def peek(self, now: float):
        """Like :meth:`pop` but leaves the request queued."""
        req = self.pop(now)
        if req is not None:
            self.push_front(req)
        return req

    def next_eligible_delay(self, now: float) -> Optional[float]:
        """Seconds until the nearest backoff hold expires (0.0 if an
        entry is already eligible), or None when the queue is empty."""
        best = None
        for _, _, req in self._heap:
            if not self._live(req):
                continue
            d = max(getattr(req, "not_before", 0.0) - now, 0.0)
            best = d if best is None else min(best, d)
        return best

    def depth(self, priority: Optional[float] = None) -> int:
        """Live entry count, optionally restricted to one priority."""
        return sum(1 for _, _, r in self._heap if self._live(r)
                   and (priority is None or r.priority == priority))

    def token_load(self) -> int:
        """Worst-case token debt of queued work: sum of
        ``len(prompt) + max_new`` over live entries. O(n), fine at
        admission-queue scale."""
        return sum(len(r.prompt) + r.max_new
                   for _, _, r in self._heap if self._live(r))

    def __len__(self) -> int:
        return sum(1 for _, _, r in self._heap if self._live(r))

    def __iter__(self):
        """Live queued requests (arbitrary order — expiry scans)."""
        return (r for _, _, r in self._heap if self._live(r))


def pick_victim(candidates: Iterable[Tuple[int, object]],
                max_priority: float = math.inf) -> Optional[int]:
    """Choose the lane to preempt from ``(lane, request)`` pairs.

    Only requests with ``priority < max_priority`` are evictable (strict
    — equal-priority work is never preempted, which is what makes the
    policy livelock-free: a preemptor can never itself be preempted by
    the request it displaced). Among evictable lanes, pick the lowest
    priority; break ties by least progress (fewest emitted tokens =
    least re-prefill work thrown away), then lowest lane id. Returns the
    lane, or None when nothing is evictable."""
    best = None
    best_key = None
    for lane, req in candidates:
        if req.priority >= max_priority:
            continue
        key = (req.priority, len(getattr(req, "_gen", ()) or ()), lane)
        if best_key is None or key < best_key:
            best, best_key = lane, key
    return best
