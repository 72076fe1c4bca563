"""Metrics registry: Counter / Gauge / Histogram under a labeled namespace.

Design points (the serving engine is the primary client):

* **Cheap updates.** ``Counter.inc`` / ``Gauge.set`` are one attribute
  add/store — the same cost as the plain ``self.admitted += 1`` engine
  counters they replace, so the registry can stay always-on in the
  serving hot loop without moving the benchmark.
* **Exact quantiles, bounded memory.** ``Histogram`` keeps fixed
  log-spaced bucket counts (Prometheus-style cumulative export) *and* a
  reservoir of raw samples capped at ``max_samples``. Up to the cap,
  ``quantile(q)`` is computed on the raw samples with numpy's default
  linear interpolation — bit-identical to ``np.percentile`` — which is
  what latency summaries over a serving run (thousands of requests)
  want. Past the cap the reservoir degrades to uniform random retention
  (Vitter's algorithm R) and quantiles become estimates; ``exact`` in
  the snapshot says which regime a histogram is in.
* **Labels are part of the identity.** ``registry.counter(name,
  labels)`` returns one instance per (name, sorted label items); the
  same key always returns the *same* instance. Re-registering a name as
  a different metric type, or with a different label keyset than its
  first registration, raises — silent collisions are how two call sites
  end up summing into each other's metric.
"""
from __future__ import annotations

import json
import math
import random
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


def log_buckets(lo: float, hi: float, per_decade: int = 5) -> List[float]:
    """Fixed log-spaced bucket upper bounds covering [lo, hi]."""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got lo={lo}, hi={hi}")
    n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
    return [lo * (hi / lo) ** (i / max(n - 1, 1)) for i in range(n)]


# default bounds: 10 microseconds .. 1000 seconds — covers kernel
# dispatches through whole-run latencies when observing seconds
DEFAULT_BUCKETS = tuple(log_buckets(1e-5, 1e3, per_decade=4))


class _Metric:
    """Common identity fields; subclasses add the value machinery."""

    kind = "abstract"

    def __init__(self, name: str, labels: Optional[dict] = None,
                 help: str = "", unit: str = ""):
        self.name = name
        self.labels = dict(labels or {})
        self.help = help
        self.unit = unit


class Counter(_Metric):
    """Monotonically increasing count (events, tokens, cumulative
    seconds). ``inc`` with a negative amount raises."""

    kind = "counter"

    def __init__(self, name, labels=None, help="", unit=""):
        super().__init__(name, labels, help, unit)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({amount}))")
        self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def data(self) -> dict:
        return {"value": self._value}


class Gauge(_Metric):
    """A value that goes up and down (blocks in use, queue depth)."""

    kind = "gauge"

    def __init__(self, name, labels=None, help="", unit=""):
        super().__init__(name, labels, help, unit)
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self._value -= amount

    @property
    def value(self) -> float:
        return self._value

    def data(self) -> dict:
        return {"value": self._value}


class Histogram(_Metric):
    """Distribution of observations with exact quantiles.

    Bucket counts (fixed log-spaced upper bounds, +inf terminal) feed
    the Prometheus export; the raw-sample reservoir feeds
    :meth:`quantile`. Up to ``max_samples`` observations the reservoir
    holds *every* sample and quantiles match ``np.percentile`` exactly;
    beyond it, reservoir sampling keeps a uniform subset and quantiles
    are estimates (``exact`` flips to False in :meth:`data`).
    """

    kind = "histogram"

    def __init__(self, name, labels=None, help="", unit="",
                 buckets: Optional[Tuple[float, ...]] = None,
                 max_samples: int = 65536, seed: int = 0):
        super().__init__(name, labels, help, unit)
        bs = tuple(buckets) if buckets is not None else DEFAULT_BUCKETS
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram {name}: bucket bounds must be "
                             f"strictly increasing, got {bs}")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)       # last = +inf overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._max_samples = max_samples
        self._samples: List[float] = []
        self._rng = random.Random(seed)          # reservoir replacement

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        # linear scan is fine: bucket lists are ~30 entries and the
        # serving engine observes per *request*, not per token
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self._counts[i] += 1
                break
        else:
            self._counts[-1] += 1
        if len(self._samples) < self._max_samples:
            self._samples.append(v)
        else:                                    # algorithm R
            j = self._rng.randrange(self.count)
            if j < self._max_samples:
                self._samples[j] = v

    @property
    def exact(self) -> bool:
        """True while the reservoir still holds every observation."""
        return self.count == len(self._samples)

    def quantile(self, q: float) -> float:
        """q-quantile (q in [0, 1]) of the retained samples — identical
        to ``np.percentile(samples, 100*q)`` (linear interpolation).
        NaN with no observations."""
        if not self._samples:
            return float("nan")
        return float(np.percentile(np.asarray(self._samples), 100.0 * q))

    def data(self) -> dict:
        d = {"count": self.count, "sum": self.sum,
             "min": self.min if self.count else float("nan"),
             "max": self.max if self.count else float("nan"),
             "exact": self.exact}
        for q in (0.5, 0.9, 0.99):
            d[f"p{int(q * 100)}"] = self.quantile(q)
        return d


def _label_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


class MetricsRegistry:
    """Namespace of labeled metrics.

    ``counter/gauge/histogram(name, labels)`` get-or-create: one
    instance per (name, labels) pair, with the *first* registration
    fixing the metric's type and label keyset — later callers asking
    for the same name with a different type or label-key shape raise
    ``ValueError`` (per-series label *values* vary freely). Thread-safe
    at registration; updates on the returned metric objects are plain
    attribute arithmetic (the GIL is their lock — all engine counters
    are updated from the scheduler thread anyway).
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, tuple], _Metric] = {}
        self._schema: Dict[str, Tuple[str, tuple]] = {}  # name->(kind,keys)
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: Optional[dict], kwargs):
        lk = _label_key(labels)
        keyset = tuple(sorted((labels or {}).keys()))
        with self._lock:
            sch = self._schema.get(name)
            if sch is not None and sch != (cls.kind, keyset):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{sch[0]} with label keys {list(sch[1])}; cannot "
                    f"re-register as {cls.kind} with label keys "
                    f"{list(keyset)}")
            m = self._metrics.get((name, lk))
            if m is None:
                m = cls(name, labels, **kwargs)
                self._metrics[(name, lk)] = m
                self._schema.setdefault(name, (cls.kind, keyset))
            return m

    def counter(self, name: str, labels: Optional[dict] = None,
                help: str = "", unit: str = "") -> Counter:
        return self._get(Counter, name, labels,
                         {"help": help, "unit": unit})

    def gauge(self, name: str, labels: Optional[dict] = None,
              help: str = "", unit: str = "") -> Gauge:
        return self._get(Gauge, name, labels,
                         {"help": help, "unit": unit})

    def histogram(self, name: str, labels: Optional[dict] = None,
                  help: str = "", unit: str = "",
                  buckets: Optional[Tuple[float, ...]] = None,
                  max_samples: int = 65536) -> Histogram:
        return self._get(Histogram, name, labels,
                         {"help": help, "unit": unit, "buckets": buckets,
                          "max_samples": max_samples})

    def get(self, name: str, labels: Optional[dict] = None):
        """Existing metric instance or None (no creation)."""
        return self._metrics.get((name, _label_key(labels)))

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """``{name: [{labels, kind, unit, ...values}, ...]}`` — every
        series of every metric, JSON-serializable."""
        out: Dict[str, list] = {}
        for m in self._metrics.values():
            out.setdefault(m.name, []).append(
                {"labels": dict(m.labels), "kind": m.kind,
                 "unit": m.unit, **m.data()})
        return out

    def render_prometheus(self) -> str:
        """Text exposition format (one HELP/TYPE block per metric name;
        histograms emit cumulative ``_bucket`` series plus
        ``_sum``/``_count``)."""
        by_name: Dict[str, List[_Metric]] = {}
        for m in self._metrics.values():
            by_name.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(by_name):
            series = by_name[name]
            head = series[0]
            if head.help:
                lines.append(f"# HELP {name} {head.help}")
            lines.append(f"# TYPE {name} {head.kind}")
            for m in series:
                lab = _render_labels(m.labels)
                if isinstance(m, Histogram):
                    cum = 0
                    for ub, c in zip(m.buckets, m._counts):
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{_render_labels({**m.labels, 'le': _fmt(ub)})}"
                            f" {cum}")
                    lines.append(
                        f"{name}_bucket"
                        f"{_render_labels({**m.labels, 'le': '+Inf'})}"
                        f" {m.count}")
                    lines.append(f"{name}_sum{lab} {_fmt(m.sum)}")
                    lines.append(f"{name}_count{lab} {m.count}")
                else:
                    lines.append(f"{name}{lab} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"

    def render_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1, sort_keys=True,
                          default=str)


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _render_labels(labels: dict) -> str:
    if not labels:
        return ""
    items = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + items + "}"
