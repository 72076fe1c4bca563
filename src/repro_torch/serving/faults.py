"""Deterministic fault injection for the serving engine (a copy of
``repro.serving.faults``, kept so the port imports nothing of ``repro``).

Chaos testing a serving loop is only useful if a failing run can be
*replayed*: every fault here fires at a scripted invocation count or
from a seeded per-rule RNG — never from wall clock — so a scenario is a
pure function of (workload, fault plan, seed).

Usage::

    fi = FaultInjector(seed=0)
    fi.inject("nan_logits", at=5, lane=1)       # 6th decode step, lane 1
    fi.inject("alloc_exhausted", at=0, times=2) # first two page allocs
    fi.inject("slow_step", every=4, delay_s=0.01)
    eng = Engine(..., faults=fi)

The engine calls :meth:`fire` at each **injection point**; ``fire``
returns the rule's payload dict when a fault should trigger there (and
logs it), else None. Points registered in the engine:

===================  ======================================================
point                effect when fired
===================  ======================================================
``alloc_exhausted``  the paged BlockAllocator reports exhaustion for this
                     allocation (backpressure / preemption path), pages
                     untouched
``evict_cache``      every cached (unreferenced) prefix page is evicted
                     before admission this step — forced cold cache
``nan_logits``       lane ``payload["lane"]`` gets NaN logits on this
                     decode step (the per-lane guard must fail only that
                     request)
``slow_step``        the engine sleeps ``payload["delay_s"]`` seconds at
                     the top of this step (drives deadline expiry
                     deterministically)
``corrupt_artifact`` not wired into the engine — tests fire it themselves
                     and apply :func:`corrupt_file` to an artifact copy
===================  ======================================================

Points registered in the HTTP server (``repro_torch.serving.server``, checked
by the supervisor worker and the SSE writer — docs/server.md):

===================  ======================================================
point                effect when fired
===================  ======================================================
``stuck_step``       the supervisor worker hangs *before* the next engine
                     step for up to ``payload["hang_s"]`` seconds (it
                     wakes early on the watchdog's abort signal), then
                     raises ``StuckStepError`` — exercises watchdog
                     detection + loop restart
``failed_step``      the supervisor worker raises ``RuntimeError`` in
                     place of the next engine step — exercises the
                     fail-poisoned-lane + requeue-bystanders recovery
``disconnect``       the SSE connection is force-closed before writing
                     the next event (``at=N`` = drop after N events) —
                     exercises mid-stream cancel
``slow_consumer``    the SSE writer sleeps ``payload["delay_s"]`` before
                     each flush — drives the bounded buffer into
                     coalesced-flush degradation
===================  ======================================================

Rules are matched against the point's own invocation counter (the
``at``-th call, every ``every``-th call, or an independent seeded
coin-flip with probability ``prob``), fire at most ``times`` times
(default: ``at`` rules once, others unbounded), and record every firing
in :attr:`log` for post-hoc assertions.

:func:`corrupt_file` is the artifact-corruption hook: byte flips or
truncation, seeded, for exercising the loader's integrity errors
(``docs/robustness.md``). It refuses to touch a path outside the
directory you pass as ``within`` — chaos tests corrupt *copies*.
"""
from __future__ import annotations

import dataclasses
import pathlib
import random
from typing import Dict, List, Optional, Tuple

__all__ = ["FaultInjector", "corrupt_file"]


@dataclasses.dataclass
class _Rule:
    point: str
    at: Optional[int]
    every: Optional[int]
    prob: Optional[float]
    times: Optional[int]          # None = unbounded
    payload: dict
    rng: random.Random
    fired: int = 0

    def matches(self, count: int) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.at is not None:
            # fires on invocations at, at+1, ... until `times` exhausted
            return count >= self.at
        if self.every is not None:
            return self.every > 0 and count % self.every == self.every - 1
        if self.prob is not None:
            return self.rng.random() < self.prob
        return True                # unconditional (bounded by times)


class FaultInjector:
    """Seeded, scripted fault plan. See module docstring for the point
    vocabulary; :meth:`fire` is the only engine-facing call."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rules: List[_Rule] = []
        self._counts: Dict[str, int] = {}
        #: every firing as (point, invocation_index, payload) — chaos
        #: tests replay/assert against this
        self.log: List[Tuple[str, int, dict]] = []

    def inject(self, point: str, at: Optional[int] = None,
               every: Optional[int] = None, prob: Optional[float] = None,
               times: Optional[int] = None, **payload) -> "FaultInjector":
        """Register a rule for ``point``. At most one of ``at`` (fire
        from that invocation index on), ``every`` (fire each N-th
        invocation), ``prob`` (seeded coin flip per invocation) may be
        given; none means fire on every invocation. ``times`` caps total
        firings (defaults to 1 for ``at`` rules — i.e. fire exactly on
        invocation ``at`` — unbounded otherwise). Returns self for
        chaining."""
        if sum(x is not None for x in (at, every, prob)) > 1:
            raise ValueError("give at most one of at/every/prob")
        if times is None and at is not None:
            times = 1
        # per-rule RNG: deterministic regardless of other points' traffic
        rng = random.Random((self.seed, point, len(self._rules)).__hash__())
        self._rules.append(_Rule(point, at, every, prob, times,
                                 dict(payload), rng))
        return self

    def fire(self, point: str, **context) -> Optional[dict]:
        """Called by the engine at injection point ``point``; returns the
        payload of the first matching rule (merged over ``context``), or
        None. Increments the point's invocation counter either way."""
        n = self._counts.get(point, 0)
        self._counts[point] = n + 1
        for rule in self._rules:
            if rule.point != point:
                continue
            if rule.matches(n):
                rule.fired += 1
                payload = {**context, **rule.payload}
                self.log.append((point, n, payload))
                return payload
        return None

    def fired(self, point: str) -> int:
        """How many times ``point`` actually injected a fault."""
        return sum(1 for p, _, _ in self.log if p == point)

    def calls(self, point: str) -> int:
        """How many times the engine *reached* ``point``."""
        return self._counts.get(point, 0)

    def summary(self) -> dict:
        return {"seed": self.seed,
                "points": dict(self._counts),
                "fired": {p: self.fired(p)
                          for p in {r.point for r in self._rules}},
                "log": [{"point": p, "n": n, "payload": pl}
                        for p, n, pl in self.log]}


def corrupt_file(path, *, mode: str = "flip", offset: Optional[int] = None,
                 nbytes: int = 1, seed: int = 0, within=None) -> dict:
    """Deterministically damage a file — the artifact-corruption hook.

    mode='flip' XORs ``nbytes`` bytes at ``offset`` (seeded-random
    position past the zip header when None) with 0xFF; mode='truncate'
    cuts the file to ``offset`` bytes (seeded-random fraction when
    None). Returns ``{"mode", "offset", "nbytes", "size"}`` describing
    what was done so a test can report it.

    Safety: refuses paths outside ``within`` when given (tests pass the
    tmp copy's directory), and always requires the file to exist."""
    p = pathlib.Path(path)
    if within is not None:
        if pathlib.Path(within).resolve() not in p.resolve().parents:
            raise ValueError(f"refusing to corrupt {p} outside {within}")
    data = bytearray(p.read_bytes())
    if not data:
        raise ValueError(f"{p} is empty — nothing to corrupt")
    rng = random.Random(seed)
    if mode == "flip":
        off = rng.randrange(min(len(data) - 1, 64),
                            len(data)) if offset is None else offset
        for i in range(off, min(off + nbytes, len(data))):
            data[i] ^= 0xFF
        p.write_bytes(bytes(data))
        return {"mode": mode, "offset": off, "nbytes": nbytes,
                "size": len(data)}
    if mode == "truncate":
        off = (rng.randrange(1, len(data)) if offset is None
               else min(offset, len(data)))
        p.write_bytes(bytes(data[:off]))
        return {"mode": mode, "offset": off, "nbytes": len(data) - off,
                "size": off}
    raise ValueError(f"unknown corruption mode {mode!r} "
                     f"(expected 'flip' or 'truncate')")
