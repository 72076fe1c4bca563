"""Serving engine of the port — ``repro.serving.engine`` with its two
schedulers, two KV layouts, seeded sampling and speculative decoding.

``scheduler='wave'`` (the default) is static batching: up to B queued
requests are left-padded to one bucketed length, prefilled together by one
full-sequence forward into a fresh contiguous cache, and decoded in
lockstep at one shared position. ``scheduler='continuous'`` keeps B decode
lanes busy: free lanes admit queued requests by chunked prefill, then one
decode burst runs over every lane at its own position. Its KV cache is
either contiguous (``kv_layout='contiguous'``, the default: a (B, max_len)
cache plus a one-lane scratch cache that admission prefills into and then
copies into the lane) or paged (one pool of pages addressed through
per-request block tables; page 0 is the scrap page that idle lanes park
on; admission chain-hashes each prompt's full pages and reuses cached
prefix pages by reference, copies a shared page before a rewrite lands in
it, and prefills up to ``policy.max_prefill_lanes_per_step`` requests
together). Decode runs in bursts of back-to-back steps with one host
sync per burst, with a per-lane finite-logit guard. The recurrent
families (``hybrid``: Griffin's ring-buffer attention and RG-LRU state;
``ssm``: Mamba2's state) are served by the wave scheduler on the
contiguous cache only: their state neither pages, admits in chunks nor
rewinds, and ``ssm`` has no KV cache to quantize.

Tokens are greedy (argmax) unless a request carries ``Request.sampling``
(``serving.sampling``): temperature / top-k / top-p with a replayable seed,
token i drawn from ``fold_in(fold_in(PRNGKey(seed), i), channel)`` with
the JAX package's threefry draws, on the device, so the port samples the
JAX engine's tokens. Temperature 0 runs the greedy path. ``spec=SpecConfig``
(continuous scheduler) turns on self-drafting speculative decoding: each
engine step drafts up to k tokens per lane by prompt lookup, scores them
in one verify forward (``api.verify`` / ``verify_paged``, C = k + 1 rows a
lane) and emits the accepted run plus one token; a rejected draft rolls
back by rewinding the lane's position (paged: inside the pages admission
reserved for prompt + max_new). Schedule counters and tokens follow the
JAX engine step for step.

Lifecycle, as in the JAX engine: every request ends in exactly one
terminal ``RequestState`` — FINISHED, CANCELLED (:meth:`Engine.cancel`),
TIMED_OUT (TTFT and end-to-end deadlines, checked while queued and between
decode bursts), FAILED (the per-lane finite guard, a request that can
never fit the pool, or :meth:`Engine.fail_lane`), PREEMPTED (evicted with
its retry budget spent) or SHED (refused by admission control at
:meth:`Engine.submit`, which raises ``ShedError`` with a Retry-After that
grows with consecutive sheds). Admission is priority-ordered; a strictly
higher-priority arrival, or page pressure, preempts the lowest-priority
lane (pages released, request requeued with backoff). Re-admission
prefills the prompt as the first admission did, then replays the emitted
tokens through decode steps over the B-lane batch (the steps the
uninterrupted run took), and a sampled request draws at its emitted
count, so a resumed request gives its uninterrupted tokens bit for bit,
on the card too. The JAX engine re-prefills prompt + emitted tokens
instead: on the card the prefill kernels sum in other orders than the
decode kernels, and a token at an MX rounding midpoint or a near-tie
draw can then part. Under speculative decoding the emitted tokens' KV
came from verify steps, which the replay does not repeat, so there the
card's resume is not bit-identical.
A seeded ``FaultInjector`` (``Engine(faults=...)``, ``serving.faults``)
fires the points ``slow_step``, ``alloc_exhausted``, ``evict_cache`` and
``nan_logits`` (wave, decode burst, verify step; the NaN lands in the
lane's logits before the finite guard).

``Engine(tracer=...)`` records the JAX engine's spans (``wave``,
``prefill``, ``decode_loop``, ``host_sync``, ``admit``, ``prefill_chunk``,
``merge``, ``copy_page``, ``engine_step``, ``decode_burst``,
``decode_step``, ``verify_step``), the per-request ``queued`` /
``prefill`` / ``decode`` / ``request`` intervals and the ``first_token``,
``shed``, ``cancel``, ``fail_lane``, ``requeue``, ``timeout``, ``preempt``,
``nan_guard`` and ``fault:evict_cache`` instants. The JAX engine's
``compile:*`` instants have no counterpart: the port compiles nothing.
Spans time host work: kernels launch asynchronously, so a span closes when
the host has queued its work, and the device wait lands in ``host_sync``
(the one device-to-host copy of a burst). Without a tracer nothing is
recorded.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import devices
from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantize import KVCacheQuant, QuantMode
from repro_torch.models import api
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.policy import (RequestQueue, RequestState,
                                        SchedulingPolicy, ShedError,
                                        SpecConfig, TERMINAL_STATES,
                                        pick_victim)
from repro_torch.serving.sampling import (SamplingParams, propose_ngram,
                                          sample_tokens, spec_accept)

SCHEDULERS = ("wave", "continuous")
KV_LAYOUTS = ("contiguous", "paged")


def default_page_size(attn_chunk: int) -> int:
    """The paged layout's page when none is given: the smallest multiple
    of the attention chunk that holds 64 tokens."""
    return attn_chunk * max(1, -(-64 // attn_chunk))


class BlockAllocator:
    """Ref-counted allocator over the paged KV pool's page ids.

    Page ids live in [reserved, n_pages) (ids below ``reserved`` are scrap
    pages that idle lanes park their block tables on). A page is **free**
    (on the free list), **referenced** (``ref > 0``) or **cached** (``ref
    == 0`` but registered under a prefix hash, parked in an LRU and
    evicted only when the free list runs dry). :meth:`alloc` returns
    ``None`` when even eviction cannot cover a request (backpressure)."""

    def __init__(self, n_pages: int, page_size: int, reserved: int = 0):
        if n_pages - reserved < 1:
            raise ValueError(f"pool needs at least one allocatable page "
                             f"(n_pages={n_pages}, reserved={reserved})")
        self.n_pages, self.page_size = n_pages, page_size
        self.reserved = reserved
        self._free = collections.deque(range(reserved, n_pages))
        self._ref = {p: 0 for p in range(reserved, n_pages)}
        self._page_of: dict = {}                # prefix hash -> page id
        self._hash_of: dict = {}                # page id -> prefix hash
        self._lru: collections.OrderedDict = collections.OrderedDict()
        self.evicted = 0                        # cumulative LRU evictions

    @property
    def capacity(self) -> int:
        """Total allocatable pages."""
        return self.n_pages - self.reserved

    @property
    def available(self) -> int:
        """Pages obtainable right now (free + evictable cached)."""
        return len(self._free) + len(self._lru)

    @property
    def in_use(self) -> int:
        """Pages referenced by at least one block table."""
        return self.capacity - self.available

    @property
    def cached(self) -> int:
        """Pages parked for prefix reuse (ref == 0, registered)."""
        return len(self._lru)

    @property
    def free(self) -> int:
        """Pages on the free list (content garbage)."""
        return len(self._free)

    @property
    def resident(self) -> int:
        """Pages holding live KV bytes (referenced or cached)."""
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at ref == 1, or None (caller applies
        backpressure). Eviction order is least-recently-cached first."""
        if n > self.available:
            return None
        out = []
        for _ in range(n):
            if self._free:
                p = self._free.popleft()
            else:
                p, _ = self._lru.popitem(last=False)
                del self._page_of[self._hash_of.pop(p)]
                self.evicted += 1
            self._ref[p] = 1
            out.append(p)
        return out

    def incref(self, p: int) -> None:
        if self._ref[p] == 0:
            self._lru.pop(p, None)              # cached -> referenced
        self._ref[p] += 1

    def decref(self, p: int) -> None:
        if self._ref[p] <= 0:
            raise ValueError(f"decref of unreferenced page {p}")
        self._ref[p] -= 1
        if self._ref[p] == 0:
            if p in self._hash_of:
                self._lru[p] = True             # cached: evictable
            else:
                self._free.append(p)

    def register(self, h, p: int) -> Optional[int]:
        """Publish page ``p`` as the cached copy of prefix hash ``h``.
        First registration wins."""
        if h in self._page_of or p in self._hash_of:
            return self._page_of.get(h)
        self._page_of[h] = p
        self._hash_of[p] = h
        return p

    def lookup(self, h) -> Optional[int]:
        """Page cached under prefix hash ``h`` (refreshing its LRU
        recency), or None."""
        p = self._page_of.get(h)
        if p is not None and self._ref[p] == 0:
            self._lru.move_to_end(p)
        return p

    def flush_cache(self) -> int:
        """Evict every cached (unreferenced, registered) page to the free
        list; returns how many. The ``evict_cache`` fault point's hook:
        referenced pages are untouched."""
        n = 0
        while self._lru:
            p, _ = self._lru.popitem(last=False)
            del self._page_of[self._hash_of.pop(p)]
            self._free.append(p)
            self.evicted += 1
            n += 1
        return n

    def check(self) -> dict:
        """Verify the allocator's invariants — free + cached + referenced
        partition [reserved, n_pages) exactly; raises AssertionError on a
        violation, else returns ``{"free", "cached", "in_use",
        "evicted"}``."""
        if any(r < 0 for r in self._ref.values()):
            raise AssertionError("negative refcount")
        fs = set(self._free)
        cs = set(self._lru)
        rs = {p for p, r in self._ref.items() if r > 0}
        if len(fs) != len(self._free):
            raise AssertionError("duplicate page on the free list")
        for a, b, what in ((fs, cs, "free/cached"), (fs, rs, "free/ref"),
                           (cs, rs, "cached/ref")):
            if a & b:
                raise AssertionError(f"page in two states: {what} "
                                     f"{sorted(a & b)}")
        allp = set(range(self.reserved, self.n_pages))
        if fs | cs | rs != allp:
            raise AssertionError(
                f"pages unaccounted for: missing {sorted(allp - fs - cs - rs)}"
                f" extra {sorted((fs | cs | rs) - allp)}")
        for p in cs:
            if p not in self._hash_of:
                raise AssertionError(f"cached page {p} has no hash")
        if len(self._page_of) != len(self._hash_of):
            raise AssertionError("hash<->page maps out of sync")
        for h, p in self._page_of.items():
            if self._hash_of.get(p) != h:
                raise AssertionError(f"hash map mismatch on page {p}")
        if self.in_use + self.free + self.cached != self.capacity:
            raise AssertionError(
                f"in_use {self.in_use} + free {self.free} + cached "
                f"{self.cached} != capacity {self.capacity}")
        return {"free": self.free, "cached": self.cached,
                "in_use": self.in_use, "evicted": self.evicted}


@dataclasses.dataclass(eq=False)       # identity eq/hash: a request is
class Request:                         # a handle, not a value
    """One generation request. prompt (S,) int32 token ids; max_new the
    decode budget; ``on_token`` an optional callback for each emitted
    token; ``out`` the emitted int32 tokens once the request completes.
    ``t_*`` are wall-clock timestamps, ``m_*`` ``time.perf_counter()``
    readings that every duration is computed from.

    ``state`` walks QUEUED -> RUNNING -> one terminal state; ``error``
    says why a request ended other than FINISHED. ``priority`` orders
    admission and gates preemption (only strictly lower-priority lanes
    are evicted for a request). ``deadline_ms`` (submit -> done) and
    ``ttft_deadline_ms`` (submit -> first token) override the policy's
    defaults. ``request_id`` keys :meth:`Engine.cancel`; ``retries``,
    ``preemptions`` and ``not_before`` are preemption bookkeeping; ``_gen``
    keeps the emitted tokens across preemptions, and ``_steps`` the shape
    of the steps that wrote their KV."""

    prompt: np.ndarray                  # (S,) int32
    max_new: int = 16
    out: Optional[np.ndarray] = None
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    m_submit: float = 0.0
    m_first: float = 0.0
    m_done: float = 0.0
    on_token: Optional[Callable[[int], None]] = None
    trace_track: Optional[str] = None   # tracer track (engine-set)
    priority: int = 0                   # higher admits (and evicts) first
    deadline_ms: Optional[float] = None          # submit -> done
    ttft_deadline_ms: Optional[float] = None     # submit -> first token
    request_id: Optional[str] = None
    state: RequestState = RequestState.QUEUED
    error: Optional[str] = None
    retries: int = 0                    # re-admissions after preemption
    preemptions: int = 0                # times evicted from a lane
    not_before: float = 0.0             # backoff hold (perf_counter)
    # None (or temperature <= 0) decodes greedily; else token i is drawn
    # with the key of (seed, i), so a run is replayable
    sampling: Optional[SamplingParams] = None
    _gen: List[int] = dataclasses.field(default_factory=list)
    # the steps that wrote this request's KV rows after its prompt, in
    # order: (0, 1) a decode step, (C, n) a C-slot verify step whose first
    # n rows were kept; :meth:`Engine._replay` repeats them on a resume
    _steps: List[tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Slot:
    """Per-lane decode state."""

    req: Request
    toks: List[int]          # emitted tokens
    pos: int                 # cache fill == next write position
    remaining: int           # decode budget left


# why the engine refuses a vlm: every scheduler feeds it token prompts
VLM_REFUSAL = (
    "family 'vlm' takes (B, S, d) stub-frontend embeddings, but every "
    "scheduler feeds token prompts: the continuous and paged paths need a "
    "token-embedding family (dense/moe), and the wave scheduler's token "
    "prompts do not unpack as embeddings (the JAX engine builds and then "
    "fails on its first request). Serve a vlm through api.prefill / "
    "api.decode")


class Engine:
    """Serving engine on ``device`` (default: the CUDA card).

    ``params`` may hold dense tensors or ``PackedWeight`` leaves (artifact
    serving, :meth:`from_artifact`); under ``backend='fused'`` the packed
    weights feed the GEMM kernel and a quantized KV cache (``kv_cache``)
    the flash-decode kernel of its layout (and, paged, the flash-prefill
    kernel). :meth:`submit` enqueues, :meth:`step` runs one scheduler
    step, :meth:`drain` steps until idle, :meth:`generate` = submit all +
    drain; :meth:`cancel`, :meth:`fail_lane` and :meth:`requeue_lane` end
    or requeue a request wherever it is."""

    # the counters reset_stats() windows (the JAX engine's; it keeps its
    # compile counters out of the window, and this engine compiles
    # nothing)
    _WINDOW_KEYS = ("admitted", "decode_steps", "slot_steps",
                    "useful_decode_tokens", "prefill_chunk_steps",
                    "prefill_batched_steps", "prefill_lane_steps",
                    "prefix_hit_tokens", "blocks_evicted",
                    "spec_proposed_tokens", "spec_accepted_tokens")

    def __init__(self, params, cfg: ArchConfig, qm: QuantMode,
                 batch_size: int = 4, max_len: int = 256,
                 backend: str | None = None,
                 bucket_prompts: bool = True,
                 scheduler: str = "wave",
                 eos_id: Optional[int] = None,
                 kv_cache: "str | KVCacheQuant | None" = None,
                 kv_layout: str = "contiguous",
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 policy: Optional[SchedulingPolicy] = None,
                 faults: Optional[FaultInjector] = None,
                 spec: Optional[SpecConfig] = None,
                 device=None):
        """Arguments and defaults as in the JAX engine. bucket_prompts
        rounds prompt lengths up to the attention chunk (wave and
        contiguous continuous admission); bucketed pads are left-pad
        tokens that are attended, as the JAX engine attends them.
        kv_layout='paged' requires scheduler='continuous'; page_size
        defaults to the smallest multiple of attn_chunk >= 64 and must be
        a multiple of 32 and of attn_chunk; n_pages defaults to one scrap
        page + batch_size * ceil(max_len / page_size). ``spec`` turns on
        self-drafting speculative decoding (continuous scheduler only).
        ``tracer`` records spans and instants (None: nothing is recorded);
        ``policy`` holds deadlines, preemption, retries, backoff and the
        admission caps; ``faults`` is a seeded ``FaultInjector`` whose
        rules fire at the engine's fault points (None adds no work).
        ``device`` is where the engine runs: None means the CUDA card, and
        the CPU runs only when asked for."""
        self.device = devices.resolve(device)
        # the JAX engine's gates, in its order
        if cfg.family == "encoder":
            raise ValueError("encoder archs are not served autoregressively")
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r} "
                             f"(expected one of {SCHEDULERS})")
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"unknown kv_layout {kv_layout!r} "
                             f"(expected one of {KV_LAYOUTS})")
        if kv_layout == "paged":
            if cfg.family not in ("dense", "moe"):
                raise ValueError(
                    f"kv_layout='paged' pages an attention KV cache "
                    f"through block tables; family {cfg.family!r} keeps "
                    f"recurrent ring-buffer state (griffin/ssm hybrids) "
                    f"that cannot be paged — serve it with "
                    f"kv_layout='contiguous'")
            if scheduler != "continuous":
                raise ValueError(
                    "kv_layout='paged' requires scheduler='continuous'; "
                    "the wave scheduler keeps the contiguous per-wave "
                    "cache")
        if scheduler == "continuous" and (
                cfg.family not in ("dense", "moe") or not cfg.embed_inputs):
            raise ValueError(
                "continuous scheduler requires a token-embedding KV-cache "
                "family (dense/moe); recurrent-state families must use "
                "scheduler='wave'")
        if spec is not None and scheduler != "continuous":
            raise ValueError(
                "speculative decoding (spec=...) requires "
                "scheduler='continuous': drafts are proposed per slot from "
                "each request's own emitted tokens")
        if cfg.family == "vlm":
            raise ValueError(VLM_REFUSAL)
        self.policy = policy if policy is not None else SchedulingPolicy()
        self.spec = spec
        self._faults = faults
        self.kv_quant = KVCacheQuant.parse(kv_cache)
        if self.kv_quant is not None and cfg.family == "ssm":
            raise ValueError("kv_cache quantization requires an attention "
                             "KV cache; ssm serves with kv_cache='none'")
        if self.kv_quant is not None and cfg.kv_dim % 32 != 0:
            raise ValueError(
                f"kv_cache quantization needs kv_dim % 32 == 0 (one E8M0 "
                f"scale per 32-block along the cache feature axis), got "
                f"kv_dim={cfg.kv_dim} for {cfg.name!r}")
        if backend is not None:
            qm = qm.with_backend(backend)
        self.params = devices.tree_to(params, self.device)
        self.cfg, self.qm = cfg, qm
        self.B = batch_size
        self.bucket_prompts = bucket_prompts
        self.scheduler = scheduler
        self.kv_layout = kv_layout
        self.eos_id = eos_id
        chunk = cfg.attn_chunk
        self.max_len = (max_len + chunk - 1) // chunk * chunk
        self.page_size = 0
        self.pages_per_slot = 0
        self._alloc: Optional[BlockAllocator] = None
        if kv_layout == "paged":
            if page_size is None:
                page_size = default_page_size(chunk)
            if page_size % 32 != 0:
                raise ValueError(f"page_size must be a multiple of the MX "
                                 f"32-block, got {page_size}")
            if page_size % chunk != 0:
                raise ValueError(
                    f"page_size must be a whole number of attention chunks "
                    f"so prefix-resume positions stay chunk-aligned; got "
                    f"page_size={page_size}, attn_chunk={chunk}")
            self.page_size = page_size
            self.pages_per_slot = -(-self.max_len // page_size)
            if n_pages is None:
                n_pages = 1 + self.B * self.pages_per_slot
            if n_pages < 1 + self.pages_per_slot:
                raise ValueError(
                    f"n_pages={n_pages} cannot hold one scrap page plus a "
                    f"full-length request ({self.pages_per_slot} pages for "
                    f"max_len={self.max_len})")
            # page 0 is the scrap page idle lanes' tables park on
            self._alloc = BlockAllocator(n_pages, page_size, reserved=1)
            self._tables = np.zeros((self.B, self.pages_per_slot), np.int32)
            self._tables_dev: Optional[torch.Tensor] = None
            self._slot_pages: List[Optional[List[int]]] = [None] * self.B

        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer
        reg = self.metrics
        self._c_admitted = reg.counter(
            "serving_requests_admitted_total",
            help="requests admitted into a scheduler lane")
        self._c_decode_steps = reg.counter(
            "serving_decode_steps_total",
            help="batched decode steps dispatched")
        self._c_slot_steps = reg.counter(
            "serving_slot_steps_total",
            help="decode steps x lanes (utilization denominator)")
        self._c_useful = reg.counter(
            "serving_useful_decode_tokens_total",
            help="decoded tokens that made it into a request's output")
        self._c_chunk_steps = reg.counter(
            "serving_prefill_chunk_steps_total",
            help="chunked-prefill invocations (drops under prefix hits)")
        self._c_prefill_batched = reg.counter(
            "serving_prefill_batched_steps_total",
            help="chunked-prefill invocations that carried >=2 lanes")
        self._c_prefill_lane_steps = reg.counter(
            "serving_prefill_lane_steps_total",
            help="chunked-prefill invocations x active lanes")
        self._h_prefill_batch = reg.histogram(
            "serving_prefill_batch_size", unit="lanes",
            help="active lanes per chunked-prefill invocation")
        self._c_prefix_hit_toks = reg.counter(
            "serving_prefix_hit_tokens_total", unit="tokens",
            help="prompt tokens served from cached prefix pages")
        self._c_prefix_hits = reg.counter(
            "serving_prefix_cache_hits_total",
            help="paged admissions that reused >=1 cached prefix page")
        self._c_prefix_misses = reg.counter(
            "serving_prefix_cache_misses_total",
            help="paged admissions with no cached prefix page")
        self._c_evicted = reg.counter(
            "serving_blocks_evicted_total",
            help="cached prefix pages reclaimed by LRU eviction")
        self._g_blocks_in_use = reg.gauge(
            "serving_blocks_in_use", unit="pages",
            help="pages referenced by live block tables")
        self._g_blocks_cached = reg.gauge(
            "serving_blocks_cached", unit="pages",
            help="unreferenced pages parked for prefix reuse")
        self._g_queue_depth = reg.gauge(
            "serving_queue_depth", unit="requests",
            help="requests waiting for a lane")
        self._h_ttft = reg.histogram(
            "serving_ttft_seconds", unit="s",
            help="time to first token (submit -> first token available)")
        self._h_tpot = reg.histogram(
            "serving_tpot_seconds", unit="s",
            help="time per output token after the first")
        self._h_latency = reg.histogram(
            "serving_request_latency_seconds", unit="s",
            help="submit -> done")
        self._h_queue_wait = reg.histogram(
            "serving_queue_wait_seconds", unit="s",
            help="submit -> admission start")
        self._c_submitted = reg.counter(
            "serving_requests_submitted_total",
            help="requests accepted by submit()")
        self._c_terminal = {
            s: reg.counter("serving_requests_terminal_total",
                           {"state": s.value},
                           help="requests reaching this terminal state")
            for s in (RequestState.FINISHED, RequestState.CANCELLED,
                      RequestState.TIMED_OUT, RequestState.FAILED,
                      RequestState.PREEMPTED, RequestState.SHED)}
        self._c_preempt = reg.counter(
            "serving_preemptions_total",
            help="running requests evicted from a lane (priority or page "
                 "pressure); each is requeued with backoff until its "
                 "retry budget runs out")
        self._c_nan = reg.counter(
            "serving_nan_guard_trips_total",
            help="requests failed by the per-lane non-finite-logit guard")
        self._c_never_fit = reg.counter(
            "serving_rejected_never_fit_total",
            help="requests rejected at admission because prompt+budget "
                 "can never fit the pool")
        self._c_shed = reg.counter(
            "serving_requests_shed_total",
            help="requests refused by admission control at submit() "
                 "(queue depth, per-priority and token-budget caps); "
                 "terminal SHED, never requeued")
        self._c_replay_steps = reg.counter(
            "serving_resume_replay_steps_total", unit="steps",
            help="decode steps that replay a resumed request's emitted "
                 "tokens into its new lane")
        self._c_spec_proposed = reg.counter(
            "serving_spec_proposed_total", unit="tokens",
            help="draft tokens proposed by the prompt-lookup drafter and "
                 "scored by a verify step")
        self._c_spec_accepted = reg.counter(
            "serving_spec_accepted_total", unit="tokens",
            help="proposed draft tokens accepted by the verify step")
        self._evicted_seen = 0
        self._window_base = {k: 0 for k in self._WINDOW_KEYS}

        self._queue = RequestQueue(max_depth=self.policy.max_queue_depth)
        self._shed_streak = 0      # consecutive sheds -> Retry-After
        self._by_id: dict = {}     # request_id -> live request
        self._next_id = 0
        self._slots: List[Optional[_Slot]] = [None] * self.B
        self._admit_cursor = 0
        self._cache = None         # continuous: the lanes' cache (lazy)
        self._slot_cache = None    # contiguous: one-lane admission scratch

    # ------------------------------------------------------------------
    # Counter views
    # ------------------------------------------------------------------

    @property
    def admitted(self) -> int:
        return int(self._c_admitted.value)

    @property
    def decode_steps(self) -> int:
        return int(self._c_decode_steps.value)

    @property
    def slot_steps(self) -> int:
        return int(self._c_slot_steps.value)

    @property
    def useful_decode_tokens(self) -> int:
        return int(self._c_useful.value)

    @property
    def prefill_chunk_steps(self) -> int:
        return int(self._c_chunk_steps.value)

    @property
    def prefix_hit_tokens(self) -> int:
        return int(self._c_prefix_hit_toks.value)

    def _span(self, name: str, **args):
        """Engine-track span, or a no-op when tracing is off."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **args)

    def _sync_alloc_metrics(self) -> None:
        if self._alloc is None:
            return
        self._g_blocks_in_use.set(self._alloc.in_use)
        self._g_blocks_cached.set(self._alloc.cached)
        if self._alloc.evicted > self._evicted_seen:
            self._c_evicted.inc(self._alloc.evicted - self._evicted_seen)
            self._evicted_seen = self._alloc.evicted

    @classmethod
    def from_artifact(cls, path, batch_size: int = 4, max_len: int = 256,
                      eager: bool = False, verify: bool = True,
                      backend: str | None = None,
                      scheduler: str = "wave",
                      eos_id: Optional[int] = None,
                      kv_cache: "str | KVCacheQuant | None" = None,
                      kv_layout: str = "contiguous",
                      page_size: Optional[int] = None,
                      n_pages: Optional[int] = None,
                      metrics: Optional[MetricsRegistry] = None,
                      tracer: Optional[Tracer] = None,
                      policy: Optional[SchedulingPolicy] = None,
                      faults: Optional[FaultInjector] = None,
                      spec: Optional[SpecConfig] = None,
                      device=None) -> "Engine":
        """Serve an exported artifact directory: load the packed bytes
        onto ``device`` (default: the CUDA card) and build the engine —
        no calibration, no re-quantization."""
        from repro_torch.artifacts import load_artifact
        dev = devices.resolve(device)
        params, cfg, qm = load_artifact(path, eager=eager, verify=verify,
                                        backend=backend, device=dev)
        return cls(params, cfg, qm, batch_size=batch_size, max_len=max_len,
                   scheduler=scheduler, eos_id=eos_id, kv_cache=kv_cache,
                   kv_layout=kv_layout, page_size=page_size,
                   n_pages=n_pages, metrics=metrics, tracer=tracer,
                   policy=policy, faults=faults, spec=spec, device=dev)

    # ------------------------------------------------------------------
    # Streaming API
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Enqueue a request; it starts on the next :meth:`step`.

        Assigns a ``request_id`` when the request has none, applies the
        policy's default deadlines to a request without its own, and
        moves it to QUEUED. Admission control (``policy.max_queue_depth``,
        ``max_queue_depth_per_priority``, ``admit_token_budget``) sheds an
        over-limit request: it ends SHED (counted in ``submitted``) and
        :class:`ShedError` is raised with a ``retry_after_s`` that follows
        the policy's backoff for each consecutive shed (reset by the next
        admission, capped at ``backoff_s(6)``)."""
        req.t_submit = time.time()
        req.m_submit = time.perf_counter()
        if req.request_id is None:
            req.request_id = f"req-{self._next_id}"
            self._next_id += 1
        if req.deadline_ms is None:
            req.deadline_ms = self.policy.deadline_ms
        if req.ttft_deadline_ms is None:
            req.ttft_deadline_ms = self.policy.ttft_deadline_ms
        self._c_submitted.inc()
        reason = self.policy.shed_reason(self._queue, req)
        if reason is not None:
            self._shed_streak += 1
            retry_after = self.policy.backoff_s(min(self._shed_streak, 6))
            self._c_shed.inc()
            if self.tracer is not None:
                self.tracer.instant("shed", track="engine", cat="request",
                                    request=req.request_id, reason=reason)
            self._finish(req, req._gen, state=RequestState.SHED,
                         error=f"shed by admission control: {reason}")
            raise ShedError(req, reason, retry_after)
        self._shed_streak = 0
        req.state = RequestState.QUEUED
        self._by_id[req.request_id] = req
        if self.tracer is not None and req.trace_track is None:
            # the tracer numbers the tracks, so engines sharing one tracer
            # keep them apart
            req.trace_track = f"req-{self.tracer.next_index('req')}"
        self._queue.push(req)
        self._g_queue_depth.set(len(self._queue))
        return req

    def cancel(self, request_id: str) -> bool:
        """Stop ``request_id`` wherever it is: a queued request is dropped
        (the queue skips it lazily), a running one frees its lane and
        pages. It ends CANCELLED with the tokens emitted so far in
        ``out``. Returns False for an unknown or already terminal id."""
        req = self._by_id.get(request_id)
        if req is None or req.state in TERMINAL_STATES:
            return False
        for i, sl in enumerate(self._slots):
            if sl is not None and sl.req is req:
                self._slots[i] = None
                self._release_lane(i)
                self._sync_alloc_metrics()
                break
        if self.tracer is not None and req.trace_track is not None:
            self.tracer.instant("cancel", track=req.trace_track,
                                cat="request")
        self._finish(req, req._gen, state=RequestState.CANCELLED,
                     error="cancelled by client")
        self._g_queue_depth.set(len(self._queue))
        return True

    def fail_lane(self, lane: int, error: str):
        """Supervisor hook: end the request on ``lane`` FAILED and free
        the lane and its pages (re-running it would poison the next step
        the same way). Returns the request, or None for an empty lane."""
        sl = self._slots[lane]
        if sl is None:
            return None
        req = sl.req
        self._slots[lane] = None
        self._release_lane(lane)
        self._sync_alloc_metrics()
        if self.tracer is not None and req.trace_track is not None:
            self.tracer.instant("fail_lane", track=req.trace_track,
                                cat="request", lane=lane, reason=error)
        self._finish(req, req._gen, state=RequestState.FAILED, error=error)
        return req

    def requeue_lane(self, lane: int, reason: str):
        """Supervisor hook: return ``lane``'s request to the queue front
        without charging its retry budget (a bystander of a failed step).
        The lane and its pages are freed; the emitted tokens stay in
        ``_gen``, so re-admission replays them (:meth:`_replay`) and
        resumes with the uninterrupted tokens. Returns the request, or
        None for an empty lane."""
        sl = self._slots[lane]
        if sl is None:
            return None
        req = sl.req
        self._slots[lane] = None
        self._release_lane(lane)
        self._sync_alloc_metrics()
        if self.tracer is not None and req.trace_track is not None:
            self.tracer.instant("requeue", track=req.trace_track,
                                cat="request", lane=lane, reason=reason)
        req.state = RequestState.QUEUED
        self._queue.push_front(req)
        self._g_queue_depth.set(len(self._queue))
        return req

    def step(self) -> List[Request]:
        """One scheduler step; returns the requests completed by it.

        Continuous: admit queued requests into free lanes (chunked
        prefill), then one decode burst over every live lane. Wave: serve
        one full wave of up to B queued requests. Both first honour the
        ``slow_step`` fault point and time out queued requests whose
        deadline has passed."""
        if self._faults is not None:
            hit = self._faults.fire("slow_step")
            if hit is not None:
                time.sleep(float(hit.get("delay_s", 0.01)))
        if self.scheduler == "continuous":
            return self._step_continuous()
        done: List[Request] = []
        self._expire_queued(done)
        reqs: List[Request] = []
        now = time.perf_counter()
        while len(reqs) < self.B:
            req = self._queue.pop(now)
            if req is None:
                break
            err = self._never_fits(req)
            if err is not None:
                self._reject_never_fit(req, err, done)
                continue
            reqs.append(req)
        self._g_queue_depth.set(len(self._queue))
        return (self._wave(reqs) if reqs else []) + done

    def _step_continuous(self) -> List[Request]:
        self._ensure_pool()
        done: List[Request] = []
        with self._span("engine_step"):
            self._step_continuous_inner(done)
        self._sync_alloc_metrics()
        self._g_queue_depth.set(len(self._queue))
        if not done and not any(s is not None for s in self._slots):
            # nothing ran and nothing ended: every queued request is in a
            # backoff hold — sleep toward the nearest release
            d = self._queue.next_eligible_delay(time.perf_counter())
            if d:
                time.sleep(min(d, 0.02))
        return done

    def _step_continuous_inner(self, done: List[Request]) -> None:
        # lifecycle pre-pass: the forced-eviction fault, queued deadlines,
        # then the priority preemption trigger
        if (self._faults is not None and self.kv_layout == "paged"
                and self._faults.fire("evict_cache") is not None):
            n = self._alloc.flush_cache()
            if self.tracer is not None:
                self.tracer.instant("fault:evict_cache", cat="fault",
                                    evicted=n)
        self._expire_queued(done)
        self._maybe_preempt_priority(done)
        # paged admission batches up to max_prefill_lanes_per_step requests
        # into one chunked-prefill loop; the contiguous layout admits one
        # request at a time through its one-lane scratch cache
        knob = (max(1, self.policy.max_prefill_lanes_per_step)
                if self.kv_layout == "paged" else 1)
        if knob > 1:
            self._admit_batched(done, knob)
        else:
            self._admit_serial(done)
        self._admit_cursor = (self._admit_cursor + 1) % self.B
        live = [i for i in range(self.B) if self._slots[i] is not None]
        if not live:
            return
        if self.spec is not None:
            # one verify step replaces the burst: drafts depend on the
            # tokens the previous step emitted
            self._spec_decode_step(live, done)
        else:
            self._decode_burst(live, done)
        self._expire_running(done)

    @property
    def busy(self) -> bool:
        """True while any request is queued or occupies a lane."""
        return bool(len(self._queue)) or any(
            s is not None for s in self._slots)

    def drain(self) -> List[Request]:
        """Step until the queue and every lane are empty."""
        done: List[Request] = []
        while self.busy:
            done.extend(self.step())
        return done

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests; returns the same list (original
        order) with ``out`` and the latency fields filled."""
        for r in requests:
            self.submit(r)
        self.drain()
        return requests

    # ------------------------------------------------------------------
    # Helpers
    # ------------------------------------------------------------------

    def _finish(self, req: Request, toks,
                state: RequestState = RequestState.FINISHED,
                error: Optional[str] = None) -> None:
        """Move ``req`` into terminal ``state`` with output ``toks``."""
        req.out = np.asarray(toks, np.int32)
        req.state = state
        if error is not None:
            req.error = error
        req.t_done = time.time()
        req.m_done = time.perf_counter()
        if not req.m_first and state is RequestState.FINISHED:
            req.m_first, req.t_first = req.m_done, req.t_done
        self._c_terminal[state].inc()
        self._c_useful.inc(max(len(req.out) - 1, 0))
        if req.m_submit and state is not RequestState.SHED:
            # a shed request never ran: a ~0 latency sample would fake
            # good percentiles exactly under overload
            self._h_latency.observe(req.m_done - req.m_submit)
            if req.m_first:
                # no first token (expired in the queue, failed prefill):
                # nothing to observe
                self._h_ttft.observe(req.m_first - req.m_submit)
        if len(req.out) > 1 and req.m_done > req.m_first > 0:
            self._h_tpot.observe((req.m_done - req.m_first)
                                 / (len(req.out) - 1))
        if self.tracer is not None and req.trace_track is not None:
            if req.m_first and req.m_done > req.m_first:
                self.tracer.complete("decode", req.m_first, req.m_done,
                                     track=req.trace_track, cat="request")
            self.tracer.complete("request", req.m_submit or req.m_done,
                                 req.m_done, track=req.trace_track,
                                 cat="request", tokens=len(req.out),
                                 prompt=len(req.prompt),
                                 state=state.value,
                                 **({"error": req.error}
                                    if req.error else {}))
        self._by_id.pop(req.request_id, None)

    def _bucket_len(self, s: int, max_new: int) -> int:
        """Round a prompt length up to the attention chunk, but only as far
        as the decode budget still fits the cache (else the raw length).
        Bucketed prompts are left-padded further; the pads are attended
        like the ragged wave's pads (static batching, no per-row masks).
        ``bucket_prompts=False`` keeps the raw length."""
        if not self.bucket_prompts:
            return s
        chunk = self.cfg.attn_chunk
        sb = (s + chunk - 1) // chunk * chunk
        while sb > s and sb + max_new > self.max_len:
            sb -= chunk
        return max(sb, s)

    def _trim_eos(self, toks: np.ndarray) -> np.ndarray:
        if self.eos_id is None:
            return toks
        hits = np.flatnonzero(toks == self.eos_id)
        return toks[:hits[0] + 1] if hits.size else toks

    def _never_fits(self, req: Request) -> Optional[str]:
        """Why this request can never be served, or None."""
        s = len(req.prompt)
        if self.kv_layout == "paged":
            if s + req.max_new > self.max_len:
                return f"prompt {s} + max_new {req.max_new} > max_len " \
                       f"{self.max_len}"
            pages = -(-(s + req.max_new) // self.page_size)
            if pages > self._alloc.capacity:
                return (f"needs {pages} pages but the pool holds only "
                        f"{self._alloc.capacity} even after evicting every "
                        f"cached page")
            return None
        sb = self._bucket_len(s, req.max_new)
        if sb + req.max_new > self.max_len:
            return (f"prompt {s} (bucketed {sb}) + max_new {req.max_new} > "
                    f"max_len {self.max_len}")
        return None

    def _reject_never_fit(self, req: Request, err: str,
                          done: List[Request]) -> None:
        self._c_never_fit.inc()
        self._finish(req, req._gen, state=RequestState.FAILED,
                     error=f"request can never fit the KV pool: {err} — "
                           f"raise max_len/n_pages or lower max_new")
        done.append(req)

    # ------------------------------------------------------------------
    # Lifecycle policy: deadlines and preemption
    # ------------------------------------------------------------------

    def _deadline_reason(self, req: Request, now: float,
                         where: str) -> Optional[str]:
        """Which deadline, if any, ``req`` has passed at ``now``."""
        if not req.m_submit:
            return None
        waited_ms = (now - req.m_submit) * 1e3
        if req.deadline_ms is not None and waited_ms >= req.deadline_ms:
            return (f"end-to-end deadline {req.deadline_ms:g}ms exceeded "
                    f"{where} ({waited_ms:.0f}ms elapsed)")
        if (req.ttft_deadline_ms is not None and not req.m_first
                and waited_ms >= req.ttft_deadline_ms):
            return (f"TTFT deadline {req.ttft_deadline_ms:g}ms exceeded "
                    f"{where} ({waited_ms:.0f}ms elapsed)")
        return None

    def _timeout(self, req: Request, reason: str,
                 done: List[Request]) -> None:
        if self.tracer is not None and req.trace_track is not None:
            self.tracer.instant("timeout", track=req.trace_track,
                                cat="request", reason=reason)
        self._finish(req, req._gen, state=RequestState.TIMED_OUT,
                     error=reason)
        done.append(req)

    def _expire_queued(self, done: List[Request]) -> None:
        """Time out queued requests past a deadline, before they cost a
        prefill (the queue drops them lazily)."""
        now = time.perf_counter()
        for req in list(self._queue):
            reason = self._deadline_reason(req, now, "while queued")
            if reason is not None:
                self._timeout(req, reason, done)

    def _expire_running(self, done: List[Request]) -> None:
        """Time out running requests past their end-to-end deadline,
        between decode bursts (``policy.deadline_burst_cap`` bounds how
        late this check can be)."""
        now = time.perf_counter()
        for i in range(self.B):
            sl = self._slots[i]
            if sl is None:
                continue
            reason = self._deadline_reason(sl.req, now, "while decoding")
            if reason is not None:
                self._slots[i] = None
                self._release_lane(i)
                self._timeout(sl.req, reason, done)

    def _preempt(self, lane: int, done: List[Request], reason: str) -> None:
        """Evict ``lane``: free it and its pages, then requeue the request
        at the queue front with backoff (its emitted tokens stay in
        ``_gen`` for :meth:`_replay`). A request past its retry budget
        ends PREEMPTED."""
        sl = self._slots[lane]
        req = sl.req
        self._slots[lane] = None
        self._release_lane(lane)
        self._c_preempt.inc()
        req.preemptions += 1
        req.retries += 1
        if self.tracer is not None and req.trace_track is not None:
            self.tracer.instant("preempt", track=req.trace_track,
                                cat="request", lane=lane, reason=reason,
                                retry=req.retries)
        if req.retries > self.policy.max_retries:
            self._finish(
                req, req._gen, state=RequestState.PREEMPTED,
                error=f"preempted {req.preemptions}x ({reason}); retry "
                      f"budget {self.policy.max_retries} exhausted")
            done.append(req)
            return
        req.state = RequestState.QUEUED
        req.not_before = (time.perf_counter()
                          + self.policy.backoff_s(req.retries))
        self._queue.push_front(req)

    def _victim_lanes(self):
        return ((i, s.req) for i, s in enumerate(self._slots)
                if s is not None)

    def _maybe_preempt_priority(self, done: List[Request]) -> None:
        """Every lane busy and a strictly higher-priority request waiting:
        evict the worst lane (at most one a step; admission takes the
        freed lane in the same step)."""
        if not self.policy.preemption:
            return
        if any(s is None for s in self._slots):
            return
        head = self._queue.peek(time.perf_counter())
        if head is None:
            return
        lane = pick_victim(self._victim_lanes(), max_priority=head.priority)
        if lane is not None:
            self._preempt(lane, done, "priority")

    def _replay(self, slot: int, req: Request, pos0: int) -> torch.Tensor:
        """Bring a resumed request's lane back to where it was evicted:
        its prompt is prefilled (its KV ends at ``pos0``); rewrite the KV
        of its emitted tokens through steps of the kind and shape that
        first wrote them (``req._steps``), then run its last token through
        the step the engine would run next, and return that step's (V,)
        logits row, which picks the next token.

        A decode record is a decode step over the B-lane batch (the
        flash-decode split depends on B). A verify record (C, n) is a
        C-slot verify step over the B lanes with the n kept tokens in the
        lane's first slots and n_valid = n: M = B·C keeps the GEMM's route
        (``ops.GEMV_MAX_M``) and the plain verify attention its shapes, and
        a row depends only on its own inputs and on the keys before it, so
        the rejected drafts of the run need not be known. The lane's KV and
        logits are then bit for bit the uninterrupted run's. The other
        lanes ride along without writing: paged on the scrap page, and
        under verify with n_valid 0; contiguous decode, a live lane
        rewrites its last token's KV at its position (its next step
        writes the same row again) and an idle lane its stale row 0. The
        fault points do not fire here."""
        paged = self.kv_layout == "paged"
        toks = req._gen
        if sum(n for _, n in req._steps) != len(toks) - 1:
            raise RuntimeError(
                f"resume of {req.request_id!r}: recorded steps cover "
                f"{sum(n for _, n in req._steps)} rows for {len(toks)} "
                f"emitted tokens")
        tables_d = None
        if paged:
            tables = np.zeros_like(self._tables)
            tables[slot] = self._tables[slot]
            tables_d = self._tensor(tables)
        nxt = (self.spec.k + 1 if self.spec is not None else 0, 1)
        logits, a = None, 0
        for C, n in [*req._steps, nxt]:
            if C == 0:
                logits = self._replay_decode(slot, toks[a], pos0 + a,
                                             tables_d)
            else:
                logits = self._replay_verify(slot, toks[a:a + n], pos0 + a,
                                             C, tables_d)[:, n - 1]
            a += n
            self._c_replay_steps.inc()
        req._steps.append(nxt)
        return logits[slot]

    def _replay_decode(self, slot: int, tok: int, pos: int, tables_d):
        cur = np.zeros(self.B, np.int32)
        pv = np.zeros(self.B, np.int32)
        if tables_d is None:
            for i, sl in enumerate(self._slots):
                if sl is not None:
                    cur[i], pv[i] = sl.toks[-1], sl.pos
        cur[slot], pv[slot] = tok, pos
        if tables_d is not None:
            logits, self._cache = api.decode_paged(
                self.params, self.cfg, self._cache, self._tensor(cur),
                self._tensor(pv), tables_d, self.qm)
        else:
            logits, self._cache = api.decode(
                self.params, self.cfg, self._cache, self._tensor(cur),
                self._tensor(pv), self.qm)
        return logits

    def _replay_verify(self, slot: int, kept: List[int], pos: int, C: int,
                       tables_d):
        toks = np.zeros((self.B, C), np.int32)
        pv = np.zeros(self.B, np.int64)
        nv = np.zeros(self.B, np.int64)
        toks[slot, :len(kept)] = kept
        pv[slot], nv[slot] = pos, len(kept)
        args = (self.params, self.cfg, self._cache, self._tensor(toks),
                torch.from_numpy(pv), torch.from_numpy(nv))
        if tables_d is not None:
            logits, self._cache = api.verify_paged(*args, tables_d, self.qm)
        else:
            logits, self._cache = api.verify(*args, self.qm)
        return logits

    def _ensure_pool(self) -> None:
        if self._cache is not None:
            return
        emb = self.params.get("embed")
        dt = emb.dtype if emb is not None else torch.float32
        if self.kv_layout == "paged":
            self._cache = api.init_cache_paged(
                self.cfg, self._alloc.n_pages, self.page_size, dt,
                kv_quant=self.kv_quant, device=self.device)
            return
        self._cache = api.init_cache(self.cfg, self.B, self.max_len, dt,
                                     kv_quant=self.kv_quant,
                                     device=self.device)
        self._slot_cache = api.init_cache(self.cfg, 1, self.max_len, dt,
                                          kv_quant=self.kv_quant,
                                          device=self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of it: the host
        array is mutated between steps)."""
        return torch.tensor(a, device=self.device)

    def _tables_committed(self) -> torch.Tensor:
        if self._tables_dev is None:
            self._tables_dev = self._tensor(self._tables)
        return self._tables_dev

    def _copy_page(self, src: int, dst: int) -> None:
        """Clone pool page ``src`` into ``dst`` over every layer (codes and
        scales of K and V): the copy-on-write of a partly reused prefix
        page."""
        for pool in (self._cache["k"], self._cache["v"]):
            pool.codes[:, dst] = pool.codes[:, src]
            if pool.scales is not None:
                pool.scales[:, dst] = pool.scales[:, src]

    # ------------------------------------------------------------------
    # Paged admission: block tables + ref-counted prefix caching
    # ------------------------------------------------------------------

    def _page_hashes(self, prompt: np.ndarray) -> List[bytes]:
        """Chained content hashes of the prompt's full pages: hash j
        commits to tokens [0, (j+1)*P)."""
        P = self.page_size
        hs: List[bytes] = []
        h = hashlib.sha256(b"mx-paged-kv")
        for j in range(len(prompt) // P):
            h = hashlib.sha256(
                h.digest()
                + np.ascontiguousarray(prompt[j * P:(j + 1) * P],
                                       np.int32).tobytes())
            hs.append(h.digest())
        return hs

    def _release_lane(self, slot: int) -> None:
        """Paged: drop lane ``slot``'s page references and park its block
        table on the scrap page. Contiguous: nothing to do (the lane's
        stale rows are overwritten by its next admission's copy)."""
        if self._alloc is None:
            return
        pages = self._slot_pages[slot]
        if pages is not None:
            for p in pages:
                self._alloc.decref(p)
            self._slot_pages[slot] = None
        self._tables[slot, :] = 0
        self._tables_dev = None

    def _admit_paged_prep(self, slot: int, req: Request,
                          in_flight: bool = False) -> Optional[dict]:
        """Host half of a paged admission: page accounting, prefix
        matching, copy-on-write and the lane's block-table row. Returns a
        plan for the prefill loop, or None on backpressure (every page
        reference taken here released). A preempted request re-admits
        with its prompt and whole budget, as it first did (its prompt's
        registered pages are prefix hits), and its emitted tokens are
        replayed into the pages that cover prompt + max_new."""
        prompt = np.asarray(req.prompt, np.int32)
        s = len(prompt)
        max_new = req.max_new
        C = self.cfg.attn_chunk
        P = self.page_size
        if s + max_new > self.max_len:
            raise ValueError(
                f"request does not fit the KV pool: prompt {s} + max_new "
                f"{max_new} > max_len {self.max_len}")
        n_req_pages = -(-(s + max_new) // P)
        hashes = self._page_hashes(prompt)
        matched: List[int] = []
        for h in hashes:
            p = self._alloc.lookup(h)
            if p is None:
                break
            matched.append(p)
        # resume at whole matched pages, capped so the chunk holding the
        # last prompt token always re-runs (its logits seed decode)
        resume = max(0, min(len(matched) * P, (s - 1) // C * C))
        m_full = resume // P
        cow_src = matched[m_full] if resume % P else None
        for p in matched[:m_full]:
            self._alloc.incref(p)
        if cow_src is not None:
            self._alloc.incref(cow_src)     # pin across alloc + copy
        forced = (self._faults is not None and
                  self._faults.fire("alloc_exhausted",
                                    need=n_req_pages - m_full) is not None)
        fresh = None if forced else self._alloc.alloc(n_req_pages - m_full)
        if fresh is None:
            for p in matched[:m_full]:
                self._alloc.decref(p)
            if cow_src is not None:
                self._alloc.decref(cow_src)
            if (not forced and not in_flight
                    and not any(sl is not None for sl in self._slots)):
                raise ValueError(
                    f"KV page pool exhausted with no requests in flight: "
                    f"request needs {n_req_pages - m_full} fresh pages but "
                    f"only {self._alloc.available} of "
                    f"{self._alloc.capacity} are obtainable — raise n_pages "
                    f"or lower max_new")
            return None
        pages = matched[:m_full] + fresh
        if cow_src is not None:
            with self._span("copy_page", src=cow_src, dst=fresh[0]):
                self._copy_page(cow_src, fresh[0])
            self._alloc.decref(cow_src)
        self._c_prefix_hit_toks.inc(resume)
        (self._c_prefix_hits if m_full else self._c_prefix_misses).inc()
        self._tables[slot, :] = 0
        self._tables[slot, :len(pages)] = pages
        self._tables_dev = None
        n_chunks = -(-(s - resume) // C)
        buf = np.zeros(n_chunks * C, np.int32)
        buf[:s - resume] = prompt[resume:]
        return {"slot": slot, "req": req, "s": s, "resume": resume,
                "n_chunks": n_chunks, "buf": buf, "pages": pages,
                "hashes": hashes}

    def _prefill_plan_serial(self, plan: dict) -> tuple:
        """One plan's chunked prefill, one lane per call."""
        slot, s, resume = plan["slot"], plan["s"], plan["resume"]
        C = self.cfg.attn_chunk
        buf = plan["buf"]
        table_row = self._tensor(self._tables[slot:slot + 1])
        logits = None
        for ci in range(plan["n_chunks"]):
            width = min(s - resume - ci * C, C)
            with self._span("prefill_chunk", chunk=ci, slot=slot,
                            paged=True, prefill_batch=1):
                logits, self._cache = api.prefill_chunk_paged(
                    self.params, self.cfg, self._cache, table_row,
                    self._tensor(buf[None, ci * C:(ci + 1) * C]),
                    resume + ci * C, width - 1, self.qm)
            self._c_chunk_steps.inc()
            self._c_prefill_lane_steps.inc()
            self._h_prefill_batch.observe(1)
        return self._admit_paged_finish(plan, logits[0])

    def _admit_paged_finish(self, plan: dict, row: torch.Tensor) -> tuple:
        """Register the prompt's full pages for prefix sharing, pin the
        lane's page list, replay a resumed request's emitted tokens, take
        the next token. Returns (next write position, token, finite)."""
        slot, s, req = plan["slot"], plan["s"], plan["req"]
        for j in range(s // self.page_size):
            self._alloc.register(plan["hashes"][j], plan["pages"][j])
        self._slot_pages[slot] = plan["pages"]
        if req._gen:
            row = self._replay(slot, req, s)
        return (s + len(req._gen), *self._first_token(req, row))

    def _first_token(self, req: Request, row: torch.Tensor) -> tuple:
        """(first token, finite) from a (V,) row of admission logits.
        Greedy requests take the host argmax; sampled ones draw on the
        device from a (1, V) batch with emission index ``len(req._gen)``
        — the draw depends only on (seed, index), so it is the token a
        decode batch would draw there."""
        host = row.cpu().numpy()
        ok = bool(np.isfinite(host).all())
        sp = req.sampling
        if sp is None or sp.greedy:
            return int(host.argmax()), ok
        vecs = self._samp_vectors([req], [len(req._gen)])
        return int(sample_tokens(row[None], *vecs)[0]), ok

    def _samp_vectors(self, reqs: List[Optional[Request]],
                      steps: List[int]) -> tuple:
        """The per-lane sampling arguments (temps, top_ks, top_ps, seeds,
        steps) on the device. ``reqs[i]`` None is an idle lane (greedy
        no-op arguments); ``steps[i]`` the lane's next emission index."""
        sps = [r.sampling if r is not None and r.sampling is not None
               else SamplingParams() for r in reqs]
        return (self._tensor(np.array([sp.temperature for sp in sps],
                                      np.float32)),
                self._tensor(np.array([sp.top_k for sp in sps], np.int64)),
                self._tensor(np.array([sp.top_p for sp in sps], np.float32)),
                self._tensor(np.array([sp.seed for sp in sps], np.int64)),
                self._tensor(np.asarray(steps, np.int64)))

    @staticmethod
    def _any_sampled(reqs) -> bool:
        return any(r is not None and r.sampling is not None
                   and not r.sampling.greedy for r in reqs)

    def _record_admission(self, req: Request, t_a0: float,
                          t_a1: float, ok: bool) -> None:
        """Admission telemetry of serial and batched admission: the
        counter, the RUNNING transition, the first token and queue wait
        (first admission only: a resumed request's is not a new first
        token), and the request track's events. ``t_a0`` is when
        admission work began, ``t_a1`` when the first token was on the
        host."""
        self._c_admitted.inc()
        req.state = RequestState.RUNNING
        first = not req.m_first
        if first and ok:
            req.m_first = t_a1
            req.t_first = time.time()
            if req.m_submit:
                self._h_queue_wait.observe(t_a0 - req.m_submit)
        if self.tracer is not None and req.trace_track is not None:
            if req.m_submit and first:
                self.tracer.complete("queued", req.m_submit, t_a0,
                                     track=req.trace_track, cat="request")
            self.tracer.complete("prefill", t_a0, t_a1,
                                 track=req.trace_track, cat="request",
                                 prompt=len(req.prompt), resumed=not first)
            if first and ok:
                self.tracer.instant("first_token", track=req.trace_track,
                                    cat="request")

    def _post_admission(self, i: int, req: Request, res: tuple,
                        done: List[Request]) -> bool:
        """NaN guard, first-token emission, same-step completion or lane
        occupancy. Returns True when lane ``i`` is now occupied."""
        sb, tok, ok = res
        if not ok:
            self._c_nan.inc()
            if self.tracer is not None and req.trace_track is not None:
                self.tracer.instant("nan_guard", track=req.trace_track,
                                    cat="request", lane=i, step=-1)
            self._release_lane(i)
            self._finish(req, req._gen, state=RequestState.FAILED,
                         error=f"non-finite logits at prefill (lane {i})")
            done.append(req)
            return False
        req._gen.append(tok)
        if req.on_token is not None:
            req.on_token(tok)
        if req.max_new - len(req._gen) == 0 or tok == self.eos_id:
            self._finish(req, req._gen)
            done.append(req)
            self._release_lane(i)
            return False
        self._slots[i] = _Slot(req, req._gen, sb,
                               req.max_new - len(req._gen))
        return True

    def _admit_serial(self, done: List[Request]) -> None:
        """Fill free lanes in admit-cursor ring order, one request at a
        time: pop, reject what can never fit, finish zero-budget requests,
        prefill the rest (contiguous: :meth:`_admit`; paged: the plan's
        serial prefill). Under page pressure a strictly lower-priority
        lane is preempted and the admission retried; when nothing can be
        evicted the request goes back to the queue front and admission
        stops for this step."""
        paged = self.kv_layout == "paged"
        blocked = False
        for off in range(self.B):
            i = (self._admit_cursor + off) % self.B
            if self._slots[i] is not None:
                continue
            while True:
                req = self._queue.pop(time.perf_counter())
                if req is None:
                    break
                err = self._never_fits(req)
                if err is not None:
                    self._reject_never_fit(req, err, done)
                    continue
                if req.max_new - len(req._gen) <= 0:
                    self._c_admitted.inc()
                    self._finish(req, req._gen)
                    done.append(req)
                    continue
                res = self._admit_one(i, req, paged)
                while res is None and self.policy.preemption:
                    # page pressure: evict a strictly lower-priority lane
                    # and retry; its pages (and cache evictions) cover us
                    lane = pick_victim(self._victim_lanes(),
                                       max_priority=req.priority)
                    if lane is None:
                        break
                    self._preempt(lane, done, "page pressure")
                    res = self._admit_one(i, req, paged)
                if res is None:
                    self._queue.push_front(req)
                    blocked = True
                    break
                if self._post_admission(i, req, res, done):
                    break
            if blocked:
                break

    def _admit_one(self, i: int, req: Request, paged: bool):
        """Admit ``req`` into lane ``i`` inside an ``admit`` span and
        record it. Returns (sb, tok, ok), or None on paged backpressure
        (nothing recorded for the request)."""
        t_a0 = time.perf_counter()
        with self._span("admit", slot=i, prompt=len(req.prompt),
                        req=req.trace_track or ""):
            if paged:
                plan = self._admit_paged_prep(i, req)
                if plan is None:
                    return None
                res = self._prefill_plan_serial(plan)
            else:
                res = self._admit(i, req)
        self._record_admission(req, t_a0, time.perf_counter(), res[2])
        return res

    def _admit(self, slot: int, req: Request) -> tuple:
        """Contiguous admission: chunk-prefill ``req`` into the one-lane
        scratch cache, then copy that cache into lane ``slot``. The prompt
        is left-padded to its bucket and run in attn_chunk-wide pieces;
        the last piece right-pads and reads the logits of the last real
        token (its pad rows stay masked until decode overwrites them).
        A preempted request re-admits with its prompt and whole budget,
        as it first did, and then replays its emitted tokens. Returns
        (next write position, token, finite)."""
        prompt = np.asarray(req.prompt, np.int32)
        s = len(prompt)
        max_new = req.max_new
        C = self.cfg.attn_chunk
        sb = self._bucket_len(s, max_new)
        if sb + max_new > self.max_len:
            raise ValueError(
                f"request does not fit the KV pool: prompt {s} (bucketed "
                f"{sb}) + max_new {max_new} > max_len {self.max_len}")
        n_chunks = -(-sb // C)
        buf = np.zeros(n_chunks * C, np.int32)
        buf[sb - s:sb] = prompt
        logits = None
        for ci in range(n_chunks):
            width = min(sb - ci * C, C)
            with self._span("prefill_chunk", chunk=ci, slot=slot):
                logits, self._slot_cache = api.prefill_chunk(
                    self.params, self.cfg, self._slot_cache,
                    self._tensor(buf[None, ci * C:(ci + 1) * C]), ci * C,
                    width - 1, self.qm)
            self._c_chunk_steps.inc()
            self._c_prefill_lane_steps.inc()
            self._h_prefill_batch.observe(1)
        with self._span("merge", slot=slot):
            self._merge_slot(slot)
        row = logits[0]
        if req._gen:
            row = self._replay(slot, req, sb)
        return (sb + len(req._gen), *self._first_token(req, row))

    def _merge_slot(self, slot: int) -> None:
        """Copy the scratch cache (every layer, K and V, codes and scales)
        into lane ``slot`` of the lanes' cache."""
        for name in ("k", "v"):
            dst, src = self._cache[name], self._slot_cache[name]
            if isinstance(dst, torch.Tensor):
                dst[:, slot] = src[:, 0]
            else:
                dst.codes[:, slot] = src.codes[:, 0]
                dst.scales[:, slot] = src.scales[:, 0]

    def _admit_batched(self, done: List[Request], knob: int) -> None:
        """Admit up to ``knob`` queued requests through ONE chunked-prefill
        loop whose calls carry every candidate lane (per-lane block tables,
        start offsets and last-token indices on the batch axis). A
        candidate whose prompt pages collide with hashes an earlier
        candidate of this batch registers is deferred to the next step,
        so its prefix hit is not lost. Lanes that are not candidates, or
        whose prompt ran out, ride along on an all-zeros table row (the
        scrap page); their logits rows are never read."""
        C = self.cfg.attn_chunk
        P = self.page_size
        plans: List[dict] = []
        pending: set = set()
        stop = False
        for off in range(self.B):
            if stop or len(plans) >= knob:
                break
            i = (self._admit_cursor + off) % self.B
            if self._slots[i] is not None:
                continue
            while True:
                req = self._queue.pop(time.perf_counter())
                if req is None:
                    stop = True
                    break
                err = self._never_fits(req)
                if err is not None:
                    self._reject_never_fit(req, err, done)
                    continue
                if req.max_new - len(req._gen) <= 0:
                    self._c_admitted.inc()
                    self._finish(req, req._gen)
                    done.append(req)
                    continue
                if plans and any(h in pending for h in self._page_hashes(
                        np.asarray(req.prompt, np.int32))):
                    self._queue.push_front(req)
                    stop = True
                    break
                t_a0 = time.perf_counter()
                plan = self._admit_paged_prep(i, req, in_flight=bool(plans))
                while plan is None and self.policy.preemption:
                    # page pressure: the serial path's victim and retry
                    lane = pick_victim(self._victim_lanes(),
                                       max_priority=req.priority)
                    if lane is None:
                        break
                    self._preempt(lane, done, "page pressure")
                    plan = self._admit_paged_prep(i, req,
                                                  in_flight=bool(plans))
                if plan is None:
                    self._queue.push_front(req)
                    stop = True
                    break
                plan["t0"] = t_a0
                pending.update(plan["hashes"][:plan["s"] // P])
                plans.append(plan)
                break
        if not plans:
            return
        if len(plans) == 1:
            # a batch of one is the serial path
            p = plans[0]
            req = p["req"]
            with self._span("admit", slot=p["slot"], prompt=len(req.prompt),
                            req=req.trace_track or ""):
                res = self._prefill_plan_serial(p)
            self._record_admission(req, p["t0"], time.perf_counter(), res[2])
            self._post_admission(p["slot"], req, res, done)
            return

        B = self.B
        tables = np.zeros((B, self._tables.shape[1]), np.int32)
        for p in plans:
            tables[p["slot"]] = self._tables[p["slot"]]
        tables_d = self._tensor(tables)
        n_steps = max(p["n_chunks"] for p in plans)
        lane_logits: dict = {}
        with self._span("admit", lanes=len(plans), batched=True):
            for ci in range(n_steps):
                active = [p for p in plans if ci < p["n_chunks"]]
                if ci and any(p["n_chunks"] == ci for p in plans):
                    # a lane just ran out of chunks: park it on the scrap
                    # table, or its ride-along rows would overwrite its KV
                    for p in plans:
                        if p["n_chunks"] <= ci:
                            tables[p["slot"]] = 0
                    tables_d = self._tensor(tables)
                toks = np.zeros((B, C), np.int32)
                starts = np.zeros(B, np.int32)
                last = np.zeros(B, np.int32)
                for p in active:
                    toks[p["slot"]] = p["buf"][ci * C:(ci + 1) * C]
                    starts[p["slot"]] = p["resume"] + ci * C
                    last[p["slot"]] = min(p["s"] - p["resume"] - ci * C,
                                          C) - 1
                with self._span("prefill_chunk", chunk=ci, paged=True,
                                prefill_batch=len(active)):
                    logits, self._cache = api.prefill_chunk_paged(
                        self.params, self.cfg, self._cache, tables_d,
                        self._tensor(toks), self._tensor(starts),
                        self._tensor(last), self.qm)
                self._c_chunk_steps.inc()
                self._c_prefill_lane_steps.inc(len(active))
                if len(active) > 1:
                    self._c_prefill_batched.inc()
                self._h_prefill_batch.observe(len(active))
                for p in active:
                    if ci == p["n_chunks"] - 1:
                        lane_logits[p["slot"]] = logits[p["slot"]]
            t_a1 = time.perf_counter()
            for p in plans:
                res = self._admit_paged_finish(p, lane_logits[p["slot"]])
                self._record_admission(p["req"], p["t0"], t_a1, res[2])
                self._post_admission(p["slot"], p["req"], res, done)

    # ------------------------------------------------------------------
    # Wave scheduler (static batching)
    # ------------------------------------------------------------------

    def _wave(self, reqs: List[Request]) -> List[Request]:
        """Serve ``reqs`` as one wave: left-pad every prompt to the bucketed
        longest length (pads are token 0 and are attended), prefill them
        together into a fresh contiguous cache, then decode in lockstep at
        one shared position, with one host sync at the end and a per-lane
        finite-logit guard. A wave with a sampled request samples every
        lane (greedy lanes take the argmax inside the sampler); an
        all-greedy wave runs the plain argmax."""
        t0 = time.time()
        B = len(reqs)
        max_new = max(r.max_new for r in reqs)
        S = self._bucket_len(max(len(r.prompt) for r in reqs), max_new)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt           # left-pad
        sampled = self._any_sampled(reqs)
        if sampled:
            # wave requests start at emission index 0, advance in lockstep
            *svecs, steps_d = self._samp_vectors(list(reqs), [0] * B)
        for r in reqs:
            r.state = RequestState.RUNNING

        def pick(logits, t):
            """The lanes' tokens of emission index t."""
            if not sampled:
                return logits.argmax(dim=-1).to(torch.int32)
            return sample_tokens(logits, *svecs, steps_d + t)

        with self._span("wave", batch=B, prompt_len=S, max_new=max_new):
            with self._span("prefill", batch=B, prompt_len=S):
                last_logits, cache = api.prefill(
                    self.params, self.cfg, self._tensor(toks), self.qm,
                    max_len=self.max_len, kv_quant=self.kv_quant)
                nxt = pick(last_logits, 0)
                ok = torch.isfinite(last_logits).all(dim=-1)
            toks_dev = [nxt]
            oks_dev = [ok]
            pos = S
            with self._span("decode_loop", steps=max(max_new - 1, 0)):
                for t in range(1, max_new):
                    poison = self._poison_lane(0)
                    logits, cache = api.decode(self.params, self.cfg, cache,
                                               nxt, pos, self.qm)
                    logits = self._poisoned(logits, poison)
                    oks_dev.append(torch.isfinite(logits).all(dim=-1))
                    nxt = pick(logits, t)
                    toks_dev.append(nxt)
                    pos += 1
            with self._span("host_sync", tokens=B * max_new):
                host = torch.stack(toks_dev, dim=1).cpu().numpy()  # 1 sync
                okh = torch.stack(oks_dev, dim=1).cpu().numpy()
        t1 = time.time()
        self._c_admitted.inc(B)
        self._c_decode_steps.inc(max(max_new - 1, 0))
        self._c_slot_steps.inc(B * max(max_new - 1, 0))
        for i, r in enumerate(reqs):
            bad = np.flatnonzero(~okh[i, :r.max_new])
            if bad.size:
                # only this lane fails: its output stops before the first
                # non-finite step
                out = self._trim_eos(host[i, :bad[0]].astype(np.int32))
                self._c_nan.inc()
                if self.tracer is not None and r.trace_track is not None:
                    self.tracer.instant("nan_guard", track=r.trace_track,
                                        cat="request", lane=i,
                                        step=int(bad[0]))
                self._finish(r, out, state=RequestState.FAILED,
                             error=f"non-finite logits in lane {i} at wave "
                                   f"step {int(bad[0])}")
            else:
                out = self._trim_eos(host[i, :r.max_new].astype(np.int32))
                self._finish(r, out)
            r.t_submit, r.t_done = t0, t1
            if r.on_token is not None:
                for t in out:
                    r.on_token(int(t))
        return reqs

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def _decode_burst(self, live: List[int], done: List[Request]) -> None:
        """Decode every lane (idle lanes ride along: paged on the scrap
        page, contiguous on their own stale rows).
        With no eos_id every lane runs exactly ``remaining`` more steps,
        so all steps up to the next lane completion are dispatched
        back-to-back, the sampled tokens fed straight back on the device,
        with one host sync for the whole burst. With a sampled lane live,
        every lane samples (idle and greedy lanes take the argmax); an
        all-greedy burst runs the plain argmax."""
        burst = 1 if self.eos_id is not None else min(
            self._slots[i].remaining for i in live)
        if any(self._slots[i].req.deadline_ms is not None for i in live):
            # deadlines are seen only between bursts: cap the burst so the
            # check stays timely (deadline-free traffic keeps the burst)
            burst = min(burst, max(1, self.policy.deadline_burst_cap))
        cur = np.zeros(self.B, np.int32)
        pos = np.zeros(self.B, np.int32)
        for i in live:
            cur[i] = self._slots[i].toks[-1]
            pos[i] = self._slots[i].pos
        cur_d, pos_d = self._tensor(cur), self._tensor(pos)
        paged = self.kv_layout == "paged"
        tables_d = self._tables_committed() if paged else None
        lanes = [sl.req if sl is not None else None for sl in self._slots]
        sampled = self._any_sampled(lanes)
        if sampled:
            # a lane's next emission index is the count of its tokens
            *svecs, steps_d = self._samp_vectors(
                lanes, [len(sl.toks) if sl is not None else 0
                        for sl in self._slots])
        toks_dev, oks_dev = [], []
        with self._span("decode_burst", steps=burst, lanes=len(live)):
            for _ in range(burst):
                poison = self._poison_lane(live[0])
                # the span times the host's launches; the device wait
                # shows in host_sync
                with self._span("decode_step", paged=paged):
                    if paged:
                        logits, self._cache = api.decode_paged(
                            self.params, self.cfg, self._cache, cur_d,
                            pos_d, tables_d, self.qm)
                    else:
                        logits, self._cache = api.decode(
                            self.params, self.cfg, self._cache, cur_d,
                            pos_d, self.qm)
                    logits = self._poisoned(logits, poison)
                    oks_dev.append(torch.isfinite(logits).all(dim=-1))
                    if sampled:
                        cur_d = sample_tokens(logits, *svecs, steps_d)
                        steps_d = steps_d + 1
                    else:
                        cur_d = logits.argmax(dim=-1).to(torch.int32)
                toks_dev.append(cur_d)
                pos_d = pos_d + 1
                self._c_decode_steps.inc()
                self._c_slot_steps.inc(self.B)
            with self._span("host_sync", steps=burst):
                host = torch.stack(toks_dev, dim=1).cpu().numpy()  # 1 sync
                okh = torch.stack(oks_dev, dim=1).cpu().numpy()
        for step in range(burst):
            for i in live:
                sl = self._slots[i]
                if sl is None:
                    continue
                if not okh[i, step]:
                    self._c_nan.inc()
                    if (self.tracer is not None
                            and sl.req.trace_track is not None):
                        self.tracer.instant("nan_guard",
                                            track=sl.req.trace_track,
                                            cat="request", lane=i, step=step)
                    self._slots[i] = None
                    self._release_lane(i)
                    self._finish(sl.req, sl.toks, state=RequestState.FAILED,
                                 error=f"non-finite logits in lane {i} at "
                                       f"decode position {sl.pos}")
                    done.append(sl.req)
                    continue
                tok = int(host[i, step])
                sl.req._steps.append((0, 1))
                self._emit(sl, tok)
                sl.remaining -= 1
                if sl.remaining == 0 or tok == self.eos_id:
                    self._finish(sl.req, sl.toks)
                    done.append(sl.req)
                    self._slots[i] = None
                    self._release_lane(i)

    def _spec_decode_step(self, live: List[int], done: List[Request]) -> None:
        """One speculative step over every lane. The host drafts up to
        ``spec.k`` tokens per live lane by prompt lookup over its prompt and
        emitted tokens, capped at ``remaining - 1`` so the emitted run never
        overruns the budget (nor the rows or pages admission reserved); one
        verify forward scores current token + drafts, and ``spec_accept``
        picks the accepted run plus one token, with one host sync. Rollback
        is a position rewind: ``pos`` advances by the emitted count only,
        and the rejected slots' rows stay masked until a later step
        overwrites them. Idle lanes verify nothing (``n_valid`` 0)."""
        K = self.spec.k
        C = K + 1
        toks = np.zeros((self.B, C), np.int32)
        pos = np.zeros(self.B, np.int64)
        n_valid = np.zeros(self.B, np.int64)
        steps = [0] * self.B
        n_prop = 0
        for i in live:
            sl = self._slots[i]
            ctx = np.concatenate([np.asarray(sl.req.prompt, np.int64),
                                  np.asarray(sl.toks, np.int64)])
            d = propose_ngram(ctx, K, self.spec.ngram_max,
                              self.spec.ngram_min)
            dn = max(0, min(len(d), sl.remaining - 1))
            toks[i, 0] = sl.toks[-1]
            toks[i, 1:1 + dn] = d[:dn]
            pos[i] = sl.pos
            n_valid[i] = dn + 1
            steps[i] = len(sl.toks)
            n_prop += dn
        self._c_spec_proposed.inc(n_prop)
        *svecs, steps_d = self._samp_vectors(
            [sl.req if sl is not None else None for sl in self._slots],
            steps)
        poison = self._poison_lane(live[0])
        toks_d = self._tensor(toks)
        # pos / n_valid stay host tensors: the verify forward derives its
        # write slots from them without a device sync
        pos_h, nv_h = torch.from_numpy(pos), torch.from_numpy(n_valid)
        paged = self.kv_layout == "paged"
        with self._span("verify_step", lanes=len(live), k=K,
                        proposed=n_prop, paged=paged):
            if paged:
                logits, self._cache = api.verify_paged(
                    self.params, self.cfg, self._cache, toks_d, pos_h, nv_h,
                    self._tables_committed(), self.qm)
            else:
                logits, self._cache = api.verify(
                    self.params, self.cfg, self._cache, toks_d, pos_h, nv_h,
                    self.qm)
            logits = self._poisoned(logits, poison)
            out, n_emit, okrow = spec_accept(
                logits, toks_d[:, 1:], self._tensor(n_valid - 1), *svecs,
                steps_d)
            with self._span("host_sync", steps=1):
                res = torch.cat([out, n_emit[:, None],
                                 okrow.to(torch.int32)],
                                dim=1).cpu().numpy()          # one sync
        self._c_decode_steps.inc()
        self._c_slot_steps.inc(self.B)
        for i in live:
            sl = self._slots[i]
            n = int(res[i, C])
            self._c_spec_accepted.inc(n - 1)
            row = res[i, :C]
            bad = np.flatnonzero(res[i, C + 1:C + 1 + n] == 0)
            if bad.size:
                # the lane keeps the tokens before its first non-finite
                # slot, then fails alone
                k0 = int(bad[0])
                for t in row[:k0]:
                    self._emit(sl, int(t))
                self._c_nan.inc()
                if (self.tracer is not None
                        and sl.req.trace_track is not None):
                    self.tracer.instant("nan_guard",
                                        track=sl.req.trace_track,
                                        cat="request", lane=i, step=k0)
                self._slots[i] = None
                self._release_lane(i)
                self._finish(sl.req, sl.toks, state=RequestState.FAILED,
                             error=f"non-finite logits in lane {i} at "
                                   f"verify position {sl.pos}")
                done.append(sl.req)
                continue
            emitted = row[:n]
            if self.eos_id is not None:
                hits = np.flatnonzero(emitted == self.eos_id)
                if hits.size:
                    # stop at (and include) the first EOS; later accepted
                    # drafts are dropped with the lane
                    emitted = emitted[:int(hits[0]) + 1]
            sl.req._steps.append((C, len(emitted)))
            for t in emitted:
                self._emit(sl, int(t))
            sl.remaining -= len(emitted)
            if sl.remaining == 0 or int(emitted[-1]) == self.eos_id:
                self._finish(sl.req, sl.toks)
                done.append(sl.req)
                self._slots[i] = None
                self._release_lane(i)

    def _poison_lane(self, default: int) -> int:
        """The ``nan_logits`` fault point, reached once a decode or
        verify step: the lane to poison (the rule's ``lane``, else
        ``default``), or -1."""
        if self._faults is None:
            return -1
        hit = self._faults.fire("nan_logits")
        return -1 if hit is None else int(hit.get("lane", default))

    @staticmethod
    def _poisoned(logits: torch.Tensor, lane: int) -> torch.Tensor:
        """``logits`` with lane ``lane``'s rows set to NaN (the fault's
        effect, ahead of the finite guard); unchanged for -1 or a lane
        the batch does not have."""
        if not 0 <= lane < logits.shape[0]:
            return logits
        logits = logits.clone()
        logits[lane] = float("nan")
        return logits

    @staticmethod
    def _emit(sl: _Slot, tok: int) -> None:
        """Append ``tok`` to the lane's tokens, advance its position and
        stream it."""
        sl.toks.append(tok)
        sl.pos += 1
        if sl.req.on_token is not None:
            sl.req.on_token(tok)

    # ------------------------------------------------------------------
    # Accounting
    # ------------------------------------------------------------------

    def _counter_values(self) -> dict:
        self._sync_alloc_metrics()
        return {"admitted": self.admitted,
                "decode_steps": self.decode_steps,
                "slot_steps": self.slot_steps,
                "useful_decode_tokens": self.useful_decode_tokens,
                "prefill_chunk_steps": self.prefill_chunk_steps,
                "prefill_batched_steps": int(self._c_prefill_batched.value),
                "prefill_lane_steps": int(self._c_prefill_lane_steps.value),
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "blocks_evicted": int(self._c_evicted.value),
                "spec_proposed_tokens": int(self._c_spec_proposed.value),
                "spec_accepted_tokens": int(self._c_spec_accepted.value),
                "resume_replay_steps": int(self._c_replay_steps.value)}

    @staticmethod
    def _acceptance(c: dict) -> float:
        return (c["spec_accepted_tokens"] / c["spec_proposed_tokens"]
                if c["spec_proposed_tokens"] else 0.0)

    @classmethod
    def _window(cls, c: dict) -> dict:
        """The windowed counters of ``c`` with the window's decode
        utilization and spec acceptance."""
        w = {k: c[k] for k in cls._WINDOW_KEYS}
        w["decode_utilization"] = (w["useful_decode_tokens"]
                                   / w["slot_steps"] if w["slot_steps"]
                                   else 0.0)
        w["spec_acceptance"] = cls._acceptance(w)
        return w

    def reset_stats(self) -> None:
        """Start a new stats window: ``stats()['window']`` counts from
        here. Not reset: the flat (cumulative) counters, the latency
        histograms and the gauges."""
        self._window_base = self._counter_values()

    @staticmethod
    def _quantiles(h) -> dict:
        if h.count == 0:
            return {"p50": None, "p99": None}
        return {"p50": h.quantile(0.5), "p99": h.quantile(0.99)}

    def stats(self) -> dict:
        """The schedule counters (cumulative since construction), decode
        utilization, TTFT / TPOT quantiles in seconds, and the lifecycle
        keys: ``submitted``, ``terminal`` (counts by terminal state; they
        sum to ``submitted`` at quiescence), ``preemptions``,
        ``nan_guard_trips``, ``rejected_never_fit``, and ``window``: the
        windowed counters since the last :meth:`reset_stats`, with their
        decode utilization and spec acceptance — the JAX engine's keys
        for the parts this engine has (it compiles nothing, so it has no
        compile counters, in the flat keys or in the window)."""
        cum = self._counter_values()
        ttft = self._quantiles(self._h_ttft)
        tpot = self._quantiles(self._h_tpot)
        return {"scheduler": self.scheduler, "backend": self.qm.backend,
                "kv_cache": (self.kv_quant.fmt if self.kv_quant else "none"),
                "kv_layout": self.kv_layout, "device": str(self.device),
                **cum,
                "decode_utilization": (
                    cum["useful_decode_tokens"] / cum["slot_steps"]
                    if cum["slot_steps"] else 0.0),
                "prefill_lanes_per_step": (
                    cum["prefill_lane_steps"]
                    / max(cum["prefill_chunk_steps"], 1)),
                "spec_acceptance": self._acceptance(cum),
                "blocks_in_use": (self._alloc.in_use if self._alloc
                                  else 0),
                "ttft_p50": ttft["p50"], "ttft_p99": ttft["p99"],
                "tpot_p50": tpot["p50"], "tpot_p99": tpot["p99"],
                "submitted": int(self._c_submitted.value),
                "terminal": {s.value: int(c.value)
                             for s, c in self._c_terminal.items()},
                "preemptions": int(self._c_preempt.value),
                "nan_guard_trips": int(self._c_nan.value),
                "rejected_never_fit": int(self._c_never_fit.value),
                "window": self._window(
                    {k: cum[k] - self._window_base[k]
                     for k in self._WINDOW_KEYS})}

    @staticmethod
    def _cache_bytes(cache) -> int:
        total = 0
        for leaf in cache.values():
            ts = ((leaf,) if isinstance(leaf, torch.Tensor)
                  else (leaf.codes, leaf.scales))
            total += sum(t.numel() * t.element_size() for t in ts
                         if t is not None)
        return total

    def kv_bytes_resident(self) -> int:
        """Bytes of KV cache holding data the engine may read. The
        contiguous layout reserves its (B, max_len) cache and the one-lane
        scratch cache up front, so all of it counts (the wave scheduler
        keeps no standing cache: 0). The paged layout counts the pages
        referenced by a live block table or cached for prefix reuse, plus
        the scrap page."""
        if self._cache is None:
            return 0
        total = self._cache_bytes(self._cache)
        if self.kv_layout != "paged":
            return total + self._cache_bytes(self._slot_cache)
        live = self._alloc.resident + self._alloc.reserved
        return total * live // self._alloc.n_pages

    def throughput(self, n_requests: int = 8, prompt_len: int = 32,
                   max_new: int = 32, seed: int = 0,
                   sampling: Optional[SamplingParams] = None) -> dict:
        """Tokens/second over a synthetic request wave, plus the schedule
        counters of this run (``window`` too: the same per-run values).
        ``sampling`` (None: greedy) applies to every request, request i
        with seed ``sampling.seed + i``. Host clock around work that ends
        in a device sync (the token fetch)."""
        rng = np.random.default_rng(seed)
        reqs = [Request(prompt=rng.integers(
            0, self.cfg.vocab_size, prompt_len).astype(np.int32),
            max_new=max_new,
            sampling=(dataclasses.replace(sampling, seed=sampling.seed + i)
                      if sampling is not None else None))
            for i in range(n_requests)]
        before = self.stats()
        t0 = time.perf_counter()
        done = self.generate(reqs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        toks = sum(len(r.out) for r in done)
        run = self.stats()
        for k in self._WINDOW_KEYS:
            run[k] -= before[k]
        run["window"] = self._window(run)
        run["decode_utilization"] = run["window"]["decode_utilization"]
        run["spec_acceptance"] = run["window"]["spec_acceptance"]
        return {"tokens": toks, "seconds": dt,
                "tok_per_s": toks / dt if dt > 0 else float("inf"), **run}
