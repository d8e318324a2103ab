"""Ring time-series store: bounded in-process metric history.

A copy of ``tpurpc/obs/tsdb.py`` (the same series names, tiers, queries
and variables). ``/metrics`` is a point-in-time scrape; the tsdb answers
questions over time (did p99 degrade ten minutes ago, how long has that
gauge been pinned):

* a background **sampler** snapshots the registry
  (:mod:`tpurpc_torch.obs.metrics`) on a fixed grain: counters as their
  raw cumulative values (``rate()`` differentiates at query time,
  reset-aware), histograms as their p50/p99 quantiles, fleet gauges as
  their scrape-time sum, and the watchdog's rolling per-method p99s;
* samples land in **preallocated fixed-size rings** (``array('d')`` per
  series per tier), two tiers: a fine grain (``TPURPC_TSDB_FINE_S``,
  default 1 s) over the recent window (``TPURPC_TSDB_FINE_WINDOW_S``,
  default 5 min) and a coarse grain (``TPURPC_TSDB_COARSE_S``, default
  15 s) over the long window (``TPURPC_TSDB_COARSE_WINDOW_S``, default
  1 h). Coarse slots take every Nth fine sample (decimation: a quantile
  series' decimated sample is still a true observation);
* memory is **bounded by construction**: at most ``MAX_SERIES`` rings of
  fixed slot counts, allocated once per series at first sight;
* queries (:meth:`Tsdb.window`, :meth:`Tsdb.rate`,
  :meth:`Tsdb.quantile_over_time`) pick the tier by the requested span;
  they are what the SLO evaluator (:mod:`tpurpc_torch.obs.slo`) and the
  diagnosis engine read;
* served at ``GET /debug/history`` on the scrape plane
  (``?series=NAME&window_s=S`` for points, bare for the inventory).
  ``TPURPC_TSDB=0`` turns the sampler off.

:class:`ResetClamp` also lives here: the counter-reset detection shared by
the shard scrape merge and the fleet collector (a counter that went
backwards means its process restarted: continue from last-known + delta).

Each tick also samples the generation plane's rolling token-latency p99s
(``gen_itl_p99_us{class}``, ``gen_ttft_p99_us{class}``) from
:mod:`tpurpc_torch.obs.odyssey`, through a ``sys.modules`` gate; the fold
of the C core's counters before each tick (``obs/native_obs.py``) waits
for ROADMAP A7 (b). Shard workers start by
spawn and inherit no store, so :func:`postfork_reset` is only the
tests' fresh-instance reset.
"""

from __future__ import annotations

import threading
import time
from array import array
from typing import Dict, List, Optional, Tuple

from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _obs_profiler

__all__ = [
    "Tsdb", "ResetClamp", "get", "ensure_started", "enabled",
    "postfork_reset", "history_doc",
]

#: the sampler thread parked between ticks is infrastructure idle time
_LENS_STAGES = {"_loop": "idle", "sample_once": "idle"}
_obs_profiler.register_stages(__file__, _LENS_STAGES)

#: hard cap on tracked series — rings are preallocated per series, so this
#: bounds resident memory no matter how hostile the metric cardinality
MAX_SERIES = 768

#: self-accounting: sample ticks + series the cap refused
_TSDB_SAMPLES = _metrics.counter("tsdb_samples")
_TSDB_SERIES_DROPPED = _metrics.counter("tsdb_series_dropped")


class ResetClamp:
    """Monotonic-counter reset detection across scrapes of a restartable
    source (a shard worker, a fleet member). ``clamp(key, value)`` returns
    a NEVER-DECREASING view of the counter: when a fresh reading drops
    below the last one (the restart signature — counters only reset to
    zero by dying), the last-known value becomes a standing offset and the
    new reading counts as the delta since restart. Multiple restarts
    accumulate. ``resets`` counts detections (the merge paths export it)."""

    def __init__(self):
        self._last: Dict[object, float] = {}
        self._offset: Dict[object, float] = {}
        self.resets = 0

    def clamp(self, key, value: float) -> float:
        last = self._last.get(key)
        if last is not None and value < last:
            self._offset[key] = self._offset.get(key, 0.0) + last
            self.resets += 1
        self._last[key] = value
        return self._offset.get(key, 0.0) + value

    def forget(self, key_prefix=None) -> None:
        """Drop tracked state (all of it, or keys whose first tuple element
        matches ``key_prefix``) — a member deliberately removed from a
        fleet must not pin its offsets forever."""
        if key_prefix is None:
            self._last.clear()
            self._offset.clear()
            return
        for d in (self._last, self._offset):
            for k in [k for k in d
                      if isinstance(k, tuple) and k and k[0] == key_prefix]:
                d.pop(k, None)


class _Tier:
    """One downsampling tier: per-series preallocated value rings plus ONE
    shared stamp ring (every series in a tier is sampled on the same
    tick). Slot ``n % slots`` holds tick ``n``; NaN marks never-written
    slots and series registered after the tier started."""

    __slots__ = ("grain_s", "slots", "stamps", "values", "n")

    def __init__(self, grain_s: float, slots: int):
        self.grain_s = grain_s
        self.slots = max(8, int(slots))
        self.stamps = array("q", [0] * self.slots)
        self.values: Dict[str, array] = {}
        self.n = 0

    def add_series(self, name: str) -> None:
        if name not in self.values:
            self.values[name] = array("d", [float("nan")] * self.slots)

    def record(self, t_ns: int, readings: Dict[str, float]) -> None:
        slot = self.n % self.slots
        self.stamps[slot] = t_ns
        for name, ring in self.values.items():
            v = readings.get(name)
            ring[slot] = v if v is not None else float("nan")
        self.n += 1

    def points(self, name: str, since_ns: int) -> List[Tuple[int, float]]:
        ring = self.values.get(name)
        if ring is None or self.n == 0:
            return []
        out: List[Tuple[int, float]] = []
        first = max(0, self.n - self.slots)
        for i in range(first, self.n):
            slot = i % self.slots
            t = self.stamps[slot]
            v = ring[slot]
            if t >= since_ns and v == v:  # NaN-skip
                out.append((t, v))
        return out

    def resident_bytes(self) -> int:
        per = self.slots * 8
        return per * (1 + len(self.values))


def _env_float(name: str, default: float) -> float:
    import os

    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


class Tsdb:
    """The two-tier store and its sampler. One process-wide instance
    (:func:`get`); tests build private ones and drive
    :meth:`sample_once` deterministically."""

    def __init__(self, fine_s: Optional[float] = None,
                 fine_window_s: Optional[float] = None,
                 coarse_s: Optional[float] = None,
                 coarse_window_s: Optional[float] = None,
                 registry: Optional[_metrics.Registry] = None):
        self.fine_s = fine_s if fine_s is not None else _env_float(
            "TPURPC_TSDB_FINE_S", 1.0)
        fine_window = fine_window_s if fine_window_s is not None else \
            _env_float("TPURPC_TSDB_FINE_WINDOW_S", 300.0)
        self.coarse_s = coarse_s if coarse_s is not None else _env_float(
            "TPURPC_TSDB_COARSE_S", 15.0)
        coarse_window = coarse_window_s if coarse_window_s is not None else \
            _env_float("TPURPC_TSDB_COARSE_WINDOW_S", 3600.0)
        self.fine_s = max(0.01, self.fine_s)
        self.coarse_s = max(self.fine_s, self.coarse_s)
        self._registry = registry or _metrics.registry()
        self._fine = _Tier(self.fine_s, round(fine_window / self.fine_s))
        self._coarse = _Tier(self.coarse_s,
                             round(coarse_window / self.coarse_s))
        #: every Nth fine tick lands in the coarse tier too
        self._decim = max(1, round(self.coarse_s / self.fine_s))
        self._kinds: Dict[str, str] = {}  # series -> counter|gauge|quantile
        self._lock = threading.Lock()
        self._readings: Dict[str, float] = {}  # reused tick scratch
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sampling -------------------------------------------------------------

    def _register(self, name: str, kind: str) -> bool:
        if name in self._kinds:
            return True
        if len(self._kinds) >= MAX_SERIES:
            _TSDB_SERIES_DROPPED.inc()
            return False
        self._kinds[name] = kind
        self._fine.add_series(name)
        self._coarse.add_series(name)
        return True

    def _read_registry(self) -> Dict[str, float]:
        """One pass over the registry into the reused readings dict.
        Counters/gauges are attribute reads; histograms pay their own
        lock for two quantiles; labeled families flatten to one series
        per child (cardinality already bounded by the family)."""
        readings = self._readings
        readings.clear()
        for name, m in self._registry.metrics().items():
            if isinstance(m, _metrics.Counter):
                if self._register(name, "counter"):
                    readings[name] = float(m.value)
            elif isinstance(m, _metrics.Gauge):
                if self._register(name, "gauge"):
                    readings[name] = float(m.value)
            elif isinstance(m, _metrics.Histogram):
                for q, suffix in ((0.5, ":p50"), (0.99, ":p99")):
                    if self._register(name + suffix, "quantile"):
                        readings[name + suffix] = float(m.percentile(q))
                if self._register(name + ":count", "counter"):
                    readings[name + ":count"] = float(m.snapshot()["count"])
            elif isinstance(m, _metrics.LabeledCounter):
                for key, v in m.snapshot().items():
                    child = name + "{" + ",".join(key) + "}"
                    if self._register(child, "counter"):
                        readings[child] = float(v)
            elif isinstance(m, _metrics.FleetGauge):
                if self._register(name, "gauge"):
                    readings[name] = m.collect()[0]
        # the watchdog's ROLLING per-method p99s (µs): the latency signal
        # SLO burn rates threshold — a rolling window recovers when a
        # degradation ends, which the cumulative histograms never do.
        # (Process-wide stores only: a test's private registry stays pure.)
        if self._registry is not _metrics.registry():
            return readings
        try:
            from tpurpc_torch.obs import watchdog as _watchdog

            wd = _watchdog.get()
            worst = None
            for method, p99 in wd.method_p99s().items():
                sname = "watchdog_p99_us{" + method + "}"
                if self._register(sname, "gauge"):
                    readings[sname] = p99 / 1e3
                if worst is None or p99 > worst:
                    worst = p99
            if worst is not None and self._register(
                    "watchdog_rolling_p99_us", "gauge"):
                readings["watchdog_rolling_p99_us"] = worst / 1e3
        except Exception:
            pass
        # the generation plane's per-SLO-class ROLLING token-latency
        # p99s (gen_itl_p99_us{class} / gen_ttft_p99_us{class}) — the
        # watchdog_p99 move applied to tokens, so the new ITL/TTFT SLO
        # track kinds can fire AND resolve. sys.modules-gated: processes
        # that never served generation sample nothing new.
        try:
            import sys

            ody = sys.modules.get("tpurpc_torch.obs.odyssey")
            if ody is not None and ody.ACTIVE:
                for sname, v in ody.rolling_series().items():
                    if self._register(sname, "gauge"):
                        readings[sname] = v
        except Exception:
            pass
        return readings

    def sample_once(self, now_ns: Optional[int] = None) -> None:
        """One sampler tick (tests drive this directly with synthetic
        stamps; the daemon loop calls it on the fine grain)."""
        now = now_ns if now_ns is not None else time.monotonic_ns()
        with self._lock:
            readings = self._read_registry()
            self._fine.record(now, readings)
            if (self._fine.n - 1) % self._decim == 0:
                self._coarse.record(now, readings)
        _TSDB_SAMPLES.inc()

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.fine_s):
            try:
                self.sample_once()
            except Exception:
                pass  # the historian must never take anything down

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = threading.Event()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="tpurpc-tsdb")
        self._thread = t
        t.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
        self._thread = None

    # -- queries --------------------------------------------------------------

    def series(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._kinds)

    @property
    def fine_window_s(self) -> float:
        return self._fine.grain_s * self._fine.slots

    @property
    def coarse_window_s(self) -> float:
        return self._coarse.grain_s * self._coarse.slots

    def _tier_for(self, window_s: float) -> _Tier:
        fine_span = self._fine.grain_s * self._fine.slots
        return self._fine if window_s <= fine_span else self._coarse

    def window(self, name: str, window_s: float,
               now_ns: Optional[int] = None) -> List[Tuple[int, float]]:
        """Time-ordered ``(t_ns, value)`` points for one series over the
        trailing window, from the tier whose span covers it."""
        now = now_ns if now_ns is not None else time.monotonic_ns()
        since = now - int(window_s * 1e9)
        with self._lock:
            return self._tier_for(window_s).points(name, since)

    def snapshot_windows(self, window_s: Optional[float] = None,
                         now_ns: Optional[int] = None
                         ) -> Dict[str, List[Tuple[int, float]]]:
        """Every series' trailing window in ONE lock
        acquisition — the diagnosis engine's change-point scan needs a
        consistent cross-series view (per-series ``window()`` calls
        could straddle a sampler tick and skew onsets across series).
        Defaults to the fine window; empty series are omitted."""
        span = window_s if window_s is not None else self.fine_window_s
        now = now_ns if now_ns is not None else time.monotonic_ns()
        since = now - int(span * 1e9)
        out: Dict[str, List[Tuple[int, float]]] = {}
        with self._lock:
            tier = self._tier_for(span)
            for name in self._kinds:
                pts = tier.points(name, since)
                if pts:
                    out[name] = pts
        return out

    def rate(self, name: str, window_s: float,
             now_ns: Optional[int] = None) -> float:
        """Per-second rate of a cumulative series over the window: the sum
        of POSITIVE deltas (a negative delta is a counter reset — the
        restarted process re-counts from zero, so the post-reset value IS
        the missing delta) divided by the covered span."""
        pts = self.window(name, window_s, now_ns=now_ns)
        if len(pts) < 2:
            return 0.0
        total = 0.0
        prev = pts[0][1]
        for _t, v in pts[1:]:
            d = v - prev
            total += d if d >= 0 else v
            prev = v
        span_s = (pts[-1][0] - pts[0][0]) / 1e9
        return total / span_s if span_s > 0 else 0.0

    def delta(self, name: str, window_s: float,
              now_ns: Optional[int] = None) -> float:
        """Reset-aware cumulative increase over the window (rate × span,
        without dividing — what a budget integrator wants)."""
        pts = self.window(name, window_s, now_ns=now_ns)
        if len(pts) < 2:
            return 0.0
        total = 0.0
        prev = pts[0][1]
        for _t, v in pts[1:]:
            d = v - prev
            total += d if d >= 0 else v
            prev = v
        return total

    def quantile_over_time(self, name: str, q: float, window_s: float,
                           now_ns: Optional[int] = None) -> Optional[float]:
        """The q-quantile of the SAMPLED values over the window (each
        sample weighs equally — on a fixed grain that is time-weighting)."""
        pts = self.window(name, window_s, now_ns=now_ns)
        if not pts:
            return None
        vals = sorted(v for _t, v in pts)
        idx = min(len(vals) - 1, max(0, int(len(vals) * q)))
        return vals[idx]

    def over_threshold_fraction(self, name: str, threshold: float,
                                window_s: float,
                                now_ns: Optional[int] = None
                                ) -> Optional[float]:
        """Fraction of window samples strictly above ``threshold`` — the
        time-based "bad minutes" ratio latency SLOs burn against."""
        pts = self.window(name, window_s, now_ns=now_ns)
        if not pts:
            return None
        bad = sum(1 for _t, v in pts if v > threshold)
        return bad / len(pts)

    # -- export ---------------------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return self._fine.resident_bytes() + self._coarse.resident_bytes()

    def doc(self, series: Optional[str] = None,
            window_s: Optional[float] = None) -> dict:
        """The ``/debug/history`` body: the inventory (bare), or one
        series' points (``?series=``)."""
        out = {
            "fine": {"grain_s": self._fine.grain_s,
                     "slots": self._fine.slots, "samples": self._fine.n},
            "coarse": {"grain_s": self._coarse.grain_s,
                       "slots": self._coarse.slots,
                       "samples": self._coarse.n},
            "resident_bytes": self.resident_bytes(),
            "running": self._thread is not None and self._thread.is_alive(),
        }
        if series is None:
            out["series"] = sorted(self.series())
            return out
        w = window_s if window_s is not None else \
            self._fine.grain_s * self._fine.slots
        pts = self.window(series, w)
        out["series"] = series
        out["kind"] = self.series().get(series)
        out["window_s"] = w
        out["points"] = [[t, v] for t, v in pts]
        if self.series().get(series) == "counter":
            out["rate_per_s"] = round(self.rate(series, w), 3)
        return out


# -- process-wide instance -----------------------------------------------------

_instance: Optional[Tsdb] = None
_instance_lock = threading.Lock()


def enabled() -> bool:
    from tpurpc_torch.utils.config import _env

    return (_env("TPURPC_TSDB") or "1").lower() not in ("0", "off", "false")


def get() -> Tsdb:
    global _instance
    if _instance is None:
        with _instance_lock:
            if _instance is None:
                _instance = Tsdb()
    return _instance


def ensure_started() -> Optional[Tsdb]:
    """Start the process-wide sampler (idempotent; ``TPURPC_TSDB=0``
    no-ops). :class:`tpurpc_torch.rpc.server.Server` calls this at
    start."""
    if not enabled():
        return None
    db = get()
    db.start()
    return db


def history_doc(params: dict) -> dict:
    """``GET /debug/history`` rendering (scrape.py route hook)."""
    if not enabled():
        return {"enabled": False, "reason": "TPURPC_TSDB=0"}
    series = params.get("series") or None
    window_s = None
    raw = params.get("window_s")
    if raw:
        try:
            window_s = float(raw)
        except ValueError:
            window_s = None
    out = get().doc(series=series, window_s=window_s)
    out["enabled"] = True
    return out


def postfork_reset() -> None:
    """Forget the process-wide store (the next :func:`get` builds a fresh
    one on the current variables). The reference's forked shard workers
    call it; the port's spawned workers start with none, and tests use it
    to rebuild the store on another grain. A running sampler is not
    stopped: stop it first."""
    global _instance, _instance_lock
    _instance_lock = threading.Lock()
    _instance = None
