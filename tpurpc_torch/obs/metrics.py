"""Always-on metrics registry: counters, gauges, histograms, fleet gauges.

A copy of ``tpurpc/obs/metrics.py`` (the same names and semantics):

* **Hot-path writes are plain-int, GIL-atomic bumps.** ``Counter.inc`` is a
  single attribute add: no lock, no dict lookup (instrumented modules cache
  the Counter object at import). A rare lost increment would skew a stat,
  never corrupt state.
* **Histograms amortize.** Data-plane histograms record once per batch;
  one lock per batch is noise.
* **State gauges cost the hot path nothing.** A :class:`FleetGauge` holds
  weak references to live objects and evaluates its function at scrape
  time only.

:mod:`tpurpc_torch.utils.stats` delegates here (one store), and the copy
ledger (:mod:`tpurpc_torch.tpu.ledger`) keeps its counters here. The
Prometheus text face (the reference's ``obs/scrape.py``) comes with the
scrape plane.
"""

from __future__ import annotations

import math
import threading
import weakref
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "FleetGauge", "LabeledCounter",
    "Registry", "registry", "counter", "gauge", "histogram", "fleet",
    "labeled_counter", "snapshot", "reset",
]


class Counter:
    """Monotonic counter. ``inc`` is the branch-free hot-path primitive."""

    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> int:
        return self.value

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-write-wins instantaneous value (explicitly set, not sampled)."""

    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def snapshot(self) -> float:
        return self.value

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Thread-safe histogram, two flavors:

    * ``kind="size"`` — EXACT counts for small integers (batch sizes,
      window depths): percentiles are precise below ``_EXACT_MAX``; larger
      values clamp into the top bucket (``stats.BatchHist``).
    * ``kind="latency"`` — 64 log2 buckets over nanoseconds with
      within-bucket linear interpolation, so p50/p99 don't snap to
      power-of-two bucket bounds.
    """

    _EXACT_MAX = 4096

    __slots__ = ("name", "kind", "_lock", "_counts", "_buckets", "_total",
                 "_n", "_max")

    def __init__(self, name: str, kind: str = "size"):
        if kind not in ("size", "latency"):
            raise ValueError(f"unknown histogram kind {kind!r}")
        self.name = name
        self.kind = kind
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = defaultdict(int)  # size flavor
        self._buckets = [0] * 64 if kind == "latency" else None
        self._total = 0
        self._n = 0
        self._max = 0

    def record(self, v: int) -> None:
        if v <= 0:
            return
        v = int(v)
        with self._lock:
            if self._buckets is None:
                self._counts[min(v, self._EXACT_MAX)] += 1
            else:
                self._buckets[min(63, v.bit_length())] += 1
            self._total += v
            self._n += 1
            if v > self._max:
                self._max = v

    def record_many(self, values) -> None:
        """Record a BATCH under one lock — the amortization this registry
        was designed around, for callers that accumulate per-item samples
        and flush per batch or lifetime."""
        with self._lock:
            for v in values:
                if v <= 0:
                    continue
                v = int(v)
                if self._buckets is None:
                    self._counts[min(v, self._EXACT_MAX)] += 1
                else:
                    self._buckets[min(63, v.bit_length())] += 1
                self._total += v
                self._n += 1
                if v > self._max:
                    self._max = v

    # -- percentiles ---------------------------------------------------------

    def _percentile_locked(self, q: float) -> float:
        if self._n == 0:
            return 0.0
        target = math.ceil(self._n * q)
        if self._buckets is None:
            seen = 0
            for size in sorted(self._counts):
                seen += self._counts[size]
                if seen >= target:
                    return size
            return self._max
        seen = 0
        for i, n in enumerate(self._buckets):
            if not n:
                continue
            if seen + n >= target:
                # bucket i holds values with bit_length == i, i.e.
                # [2^(i-1), 2^i); interpolate linearly inside it
                lo = 0 if i == 0 else 1 << (i - 1)
                hi = 1 << i
                frac = (target - seen) / n
                return min(lo + frac * (hi - lo), float(self._max))
            seen += n
        return float(self._max)

    def percentile(self, q: float) -> float:
        with self._lock:
            return self._percentile_locked(q)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if self._n == 0:
                return {"count": 0, "mean": 0.0, "p50": 0, "p99": 0, "max": 0}
            p50 = self._percentile_locked(0.5)
            p99 = self._percentile_locked(0.99)
            if self._buckets is None:
                p50, p99 = int(p50), int(p99)
            else:
                p50, p99 = round(p50, 1), round(p99, 1)
            return {
                "count": self._n,
                "mean": round(self._total / self._n, 2),
                "p50": p50,
                "p99": p99,
                "max": self._max,
            }

    def sum(self) -> int:
        with self._lock:
            return self._total

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            if self._buckets is not None:
                self._buckets = [0] * 64
            self._total = 0
            self._n = 0
            self._max = 0


class LabeledCounter:
    """A counter FAMILY keyed by a fixed label tuple (Prometheus labels):
    ``family.labels("method", "0").inc()``. Children are plain
    :class:`Counter`\\ s — the hot path caches the child and pays the same
    single GIL-atomic bump; ``labels()`` itself is a dict hit after the
    first call per label set. Cardinality is bounded (``_MAX_CHILDREN``):
    overflow collapses into an ``overflow`` child instead of growing the
    registry without bound on hostile method names."""

    kind = "labeled_counter"
    _MAX_CHILDREN = 512

    __slots__ = ("name", "labelnames", "_children", "_lock", "_overflow")

    def __init__(self, name: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], Counter] = {}
        self._lock = threading.Lock()
        self._overflow: Optional[Counter] = None

    def labels(self, *values) -> Counter:
        key = tuple(str(v) for v in values)
        c = self._children.get(key)
        if c is not None:
            return c
        with self._lock:
            c = self._children.get(key)
            if c is None:
                if len(self._children) >= self._MAX_CHILDREN:
                    if self._overflow is None:
                        self._overflow = Counter(self.name + ":overflow")
                    return self._overflow
                c = self._children[key] = Counter(self.name)
            return c

    def snapshot(self) -> Dict[Tuple[str, ...], int]:
        with self._lock:
            return {k: c.value for k, c in self._children.items()}

    def reset(self) -> None:
        with self._lock:
            self._children.clear()
            self._overflow = None


class FleetGauge:
    """Scrape-time aggregate over live instances (weakly referenced).

    ``track(obj)`` at construction is the ONLY hot-path cost (one WeakSet
    add per object lifetime); ``collect()`` evaluates ``fn(obj)`` for every
    still-live object at scrape time and returns ``(sum, object_count)``.
    A raising ``fn`` skips that object — a half-torn-down ring must not
    break the scrape."""

    kind = "fleet"

    def __init__(self, name: str, fn: Callable[[object], float]):
        self.name = name
        self._fn = fn
        self._refs: "weakref.WeakSet" = weakref.WeakSet()
        self._lock = threading.Lock()

    def track(self, obj) -> None:
        with self._lock:
            self._refs.add(obj)

    def collect(self) -> Tuple[float, int]:
        with self._lock:
            objs = list(self._refs)
        total = 0.0
        n = 0
        for o in objs:
            try:
                total += float(self._fn(o))
                n += 1
            except Exception:
                continue  # dying object: skip, never break the scrape
        return total, n


class Registry:
    """Name → metric. One process-wide instance (:func:`registry`);
    tests may build private ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, factory, want_cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, want_cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, lambda: Counter(name), Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, lambda: Gauge(name), Gauge)

    def histogram(self, name: str, kind: str = "size") -> Histogram:
        return self._get(name, lambda: Histogram(name, kind), Histogram)

    def fleet(self, name: str,
              fn: Optional[Callable[[object], float]] = None) -> FleetGauge:
        if fn is None:
            fn = lambda _o: 1.0  # noqa: E731 — membership count gauge
        return self._get(name, lambda: FleetGauge(name, fn), FleetGauge)

    def labeled_counter(self, name: str,
                        labelnames: Tuple[str, ...]) -> LabeledCounter:
        return self._get(name, lambda: LabeledCounter(name, labelnames),
                         LabeledCounter)

    # -- export --------------------------------------------------------------

    def metrics(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> Dict[str, Dict]:
        """All metrics as plain dicts (tests / JSON export)."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                                "histograms": {}, "fleet": {},
                                "labeled": {}}
        for name, m in self.metrics().items():
            if isinstance(m, Counter):
                out["counters"][name] = m.snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.snapshot()
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.snapshot()
            elif isinstance(m, LabeledCounter):
                out["labeled"][name] = {
                    ",".join(k): v for k, v in m.snapshot().items()}
            elif isinstance(m, FleetGauge):
                total, n = m.collect()
                out["fleet"][name] = {"sum": total, "objects": n}
        return out

    def counters_snapshot(self) -> Dict[str, int]:
        return {n: m.snapshot() for n, m in self.metrics().items()
                if isinstance(m, Counter)}

    def histograms_snapshot(self) -> Dict[str, Dict[str, float]]:
        return {n: m.snapshot() for n, m in self.metrics().items()
                if isinstance(m, Histogram)}

    def reset(self) -> None:
        """Zero counters/gauges/histograms (bench round isolation). Fleet
        gauges keep their membership: they describe live objects."""
        for m in self.metrics().values():
            if not isinstance(m, FleetGauge):
                m.reset()


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, kind: str = "size") -> Histogram:
    return _REGISTRY.histogram(name, kind)


def fleet(name: str, fn: Optional[Callable[[object], float]] = None
          ) -> FleetGauge:
    return _REGISTRY.fleet(name, fn)


def labeled_counter(name: str, labelnames: Tuple[str, ...]) -> LabeledCounter:
    return _REGISTRY.labeled_counter(name, labelnames)


def snapshot() -> Dict[str, Dict]:
    return _REGISTRY.snapshot()


def reset() -> None:
    _REGISTRY.reset()
