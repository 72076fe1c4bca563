"""Span tracer exporting Chrome ``trace_event`` JSON (a copy of
``repro.obs.tracing``, kept so the port imports nothing of ``repro``).

``Tracer.span("decode_step", ...)`` context managers record wall-clock
intervals (``time.perf_counter`` — monotonic) onto *track buffers*:
by default the calling thread's track, or a named logical track
(``track="req-3"`` — the serving engine gives every request its own
track so lifecycle spans render as one lane per request). ``export``
writes the standard ``{"traceEvents": [...]}`` JSON that opens directly
in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Event vocabulary (the subset of the trace-event format we emit):

* ``ph: "X"`` — complete span: ``ts`` (start, microseconds since the
  tracer's epoch) + ``dur`` (microseconds), from :meth:`Tracer.span`.
* ``ph: "i"`` — instant event (zero duration, e.g. ``first_token``,
  ``compile:decode``), from :meth:`Tracer.instant`.
* ``ph: "M"`` — track-name metadata, synthesized at export.

Spans on one track follow stack discipline (a span entered inside
another ends before it) — :func:`validate_trace` checks exactly that,
and is what the schema test and the CI smoke step run against an
exported file.

Overhead: recording one span is two ``perf_counter`` calls and one
list append; nothing is flushed or synced until :meth:`export`. When no
tracer is installed the serving engine skips even that (``None`` check,
no context manager is created).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Union

__all__ = ["Tracer", "validate_trace"]


class _SpanCtx:
    """Context manager for one complete ('X') event."""

    __slots__ = ("tracer", "name", "tid", "cat", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, tid: int, cat: str,
                 args: Optional[dict]):
        self.tracer, self.name, self.tid = tracer, name, tid
        self.cat, self.args = cat, args
        self.t0 = 0.0

    def __enter__(self) -> "_SpanCtx":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        ev = {"ph": "X", "name": self.name, "cat": self.cat,
              "ts": self.tracer._us(self.t0),
              "dur": round((t1 - self.t0) * 1e6, 3),
              "pid": self.tracer.pid, "tid": self.tid}
        if self.args:
            ev["args"] = self.args
        self.tracer._events.append(ev)


class Tracer:
    """Collects span/instant events onto per-thread and named tracks.

    All timestamps come from one ``perf_counter`` epoch captured at
    construction, so tracks from different threads line up. The event
    buffer only grows; :meth:`export` may be called repeatedly (each
    call writes the full buffer).
    """

    def __init__(self, pid: int = 0):
        self.pid = pid
        self._epoch = time.perf_counter()
        self._events: List[dict] = []            # appends are GIL-atomic
        self._tracks: Dict[str, int] = {}        # track name -> tid
        self._seq: Dict[str, int] = {}           # next_index counters
        self._lock = threading.Lock()

    def next_index(self, key: str = "") -> int:
        """Monotone per-key counter — clients naming their own tracks
        (e.g. one per request) stay collision-free even when several
        producers share one tracer."""
        with self._lock:
            i = self._seq.get(key, 0)
            self._seq[key] = i + 1
            return i

    def _us(self, t: float) -> float:
        return round((t - self._epoch) * 1e6, 3)

    def _tid(self, track: Optional[str]) -> int:
        if track is None:
            t = threading.current_thread()
            track = f"thread:{t.name}"
        with self._lock:
            tid = self._tracks.get(track)
            if tid is None:
                tid = len(self._tracks)
                self._tracks[track] = tid
            return tid

    def span(self, name: str, track: Optional[str] = None,
             cat: str = "engine", **args) -> _SpanCtx:
        """``with tracer.span("decode_step", batch=4): ...`` records a
        complete event covering the block. ``track=None`` uses the
        calling thread's track; a string names a logical track (created
        on first use). Keyword args land in the event's ``args``."""
        return _SpanCtx(self, name, self._tid(track), cat, args or None)

    def complete(self, name: str, t0: float, t1: float,
                 track: Optional[str] = None, cat: str = "engine",
                 **args) -> None:
        """Record a span retroactively from two ``perf_counter``
        readings (for intervals whose start/end straddle many calls —
        e.g. a request's submit→done lifetime, closed at finish)."""
        ev = {"ph": "X", "name": name, "cat": cat,
              "ts": self._us(t0), "dur": round((t1 - t0) * 1e6, 3),
              "pid": self.pid, "tid": self._tid(track)}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, name: str, track: Optional[str] = None,
                cat: str = "engine", **args) -> None:
        """Zero-duration marker (compile events, first_token)."""
        ev = {"ph": "i", "name": name, "cat": cat, "s": "t",
              "ts": self._us(time.perf_counter()),
              "pid": self.pid, "tid": self._tid(track)}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def events(self) -> List[dict]:
        """Copy of the recorded events (no metadata rows)."""
        return list(self._events)

    def export(self, path) -> str:
        """Write Chrome trace-event JSON to ``path``; returns the path.
        Prepends thread_name metadata so Perfetto labels each track."""
        meta = [{"ph": "M", "name": "thread_name", "pid": self.pid,
                 "tid": tid, "args": {"name": name}}
                for name, tid in sorted(self._tracks.items(),
                                        key=lambda kv: kv[1])]
        doc = {"traceEvents": meta + self._events,
               "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return str(path)


def _load_events(src: Union[str, dict, list]) -> List[dict]:
    if isinstance(src, str):
        with open(src) as f:
            src = json.load(f)
    if isinstance(src, dict):
        src = src.get("traceEvents", [])
    if not isinstance(src, list):
        raise ValueError("trace must be a list of events or a dict with "
                         "a 'traceEvents' list")
    return src


def validate_trace(src: Union[str, dict, list]) -> List[dict]:
    """Validate Chrome trace-event JSON (path, parsed dict, or event
    list). Checks:

    * every event has ``ph``/``name``/``ts``/``pid``/``tid`` (metadata
      ``M`` rows need ``ph``/``name`` only), ``X`` events also ``dur``;
    * timestamps and durations are non-negative numbers;
    * per (pid, tid) track, ``X`` spans follow stack discipline —
      sorted by start, each span is either fully inside the enclosing
      open span or starts at/after its end (no partial overlap).

    Returns the non-metadata events; raises ``ValueError`` with the
    offending event on violation.
    """
    events = _load_events(src)
    out: List[dict] = []
    spans: Dict[tuple, List[dict]] = {}
    for ev in events:
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            raise ValueError(f"event missing ph/name: {ev!r}")
        if ev["ph"] == "M":
            continue
        for field in ("ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event missing {field!r}: {ev!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"bad ts: {ev!r}")
        if ev["ph"] == "X":
            if "dur" not in ev or not isinstance(ev["dur"], (int, float)) \
                    or ev["dur"] < 0:
                raise ValueError(f"X event missing/bad dur: {ev!r}")
            spans.setdefault((ev["pid"], ev["tid"]), []).append(ev)
        out.append(ev)
    eps = 1e-3   # exported timestamps are rounded to 3 decimals (ns)
    for track, evs in spans.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[dict] = []
        for ev in evs:
            end = ev["ts"] + ev["dur"]
            while stack and ev["ts"] >= stack[-1]["ts"] \
                    + stack[-1]["dur"] - eps:
                stack.pop()
            if stack and end > stack[-1]["ts"] + stack[-1]["dur"] + eps:
                raise ValueError(
                    f"span {ev['name']!r} on track {track} partially "
                    f"overlaps {stack[-1]['name']!r}: "
                    f"[{ev['ts']}, {end}] vs "
                    f"[{stack[-1]['ts']}, "
                    f"{stack[-1]['ts'] + stack[-1]['dur']}]")
            stack.append(ev)
    return out
