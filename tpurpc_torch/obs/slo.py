"""SLO burn-rate alerting over the ring tsdb.

A copy of ``tpurpc/obs/slo.py`` (the same objectives, windows, states,
flight codes and variables), evaluated in-process over
:mod:`tpurpc_torch.obs.tsdb`'s history:

* **Objectives** are declared per method (or server-wide) with up to
  three budget tracks: ``errors`` (the non-OK share of
  ``srv_calls{method,code}``, sheds excluded, against ``target_pct``),
  ``sheds`` (``srv_admission_rejected`` against its own, looser
  ``shed_target_pct``: a server shedding under overload is doing its
  job) and ``latency`` (the share of tsdb samples of a rolling quantile
  series, by default the watchdog's rolling p99, above ``latency_ms``).
  ``ttft``/``itl`` threshold the generation plane's rolling token
  latencies (``gen_ttft_p99_us{class}``/``gen_itl_p99_us{class}``, which
  :mod:`tpurpc_torch.obs.odyssey` feeds the tsdb).
* **Multi-window multi-burn-rate**: each objective evaluates
  ``(fast, slow, threshold)`` pairs, by default ``(TPURPC_SLO_FAST_S,
  TPURPC_SLO_SLOW_S, 14.4)`` and ``(5×fast, 5×slow, 6.0)``; an alert fires
  only when both windows of a pair burn over the threshold.
* **State machine** per (objective, track): ``ok → pending`` when a fast
  window burns hot, ``pending → firing`` when a pair's slow window agrees,
  ``firing → ok`` when no pair sustains the burn. States are served at
  ``GET /debug/slo``, a firing alert degrades ``/healthz``, the edges are
  flight events (``SLO_FIRING``/``SLO_RESOLVED`` under ``slo:<name>``),
  and a firing page reaches the stall watchdog as an ``slo`` stage
  (:meth:`tpurpc_torch.obs.watchdog.StallWatchdog.external_trip`), whose
  trip hooks capture evidence (:mod:`tpurpc_torch.obs.bundle`).

The evaluator is one daemon thread on ``TPURPC_SLO_EVAL_S`` (default a
quarter of the fast window); it starts only once an objective exists.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _metrics

__all__ = [
    "SloObjective", "SloEvaluator", "declare", "objectives", "get",
    "ensure_started", "firing", "health_lines", "slo_doc", "reset",
    "postfork_reset", "TRACK_CODES",
]

#: flight-event a1 values naming the burning track (append-only).
#: ``ttft`` and ``itl`` threshold the generation plane's ROLLING per-class
#: p99 series (``gen_ttft_p99_us{class}`` / ``gen_itl_p99_us{class}``)
#: exactly like ``latency`` thresholds the watchdog roll.
TRACK_CODES = {"errors": 0, "sheds": 1, "latency": 2, "ttft": 3, "itl": 4}
TRACK_NAMES = {v: k for k, v in TRACK_CODES.items()}

#: anomaly counters: alert transitions, always-on
_FIRED = _metrics.labeled_counter("slo_alerts_fired", ("objective", "track"))
_RESOLVED = _metrics.counter("slo_alerts_resolved")


def _env_float(name: str, default: float) -> float:
    import os

    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def default_windows() -> List[Tuple[float, float, float]]:
    """The env-scaled window pairs: ``(fast_s, slow_s, burn_threshold)``.
    Defaults (60 s / 720 s and 300 s / 3600 s) fit inside the tsdb's
    fine/coarse spans; tests scale the envs down to fractions of a
    second."""
    fast = max(0.1, _env_float("TPURPC_SLO_FAST_S", 60.0))
    slow = max(fast, _env_float("TPURPC_SLO_SLOW_S", 720.0))
    return [(fast, slow, 14.4), (5 * fast, 5 * slow, 6.0)]


class _TrackState:
    __slots__ = ("state", "since_ns", "fired", "last_burn", "last_transition")

    def __init__(self):
        self.state = "ok"
        self.since_ns = 0
        self.fired = 0
        self.last_burn = (0.0, 0.0)   # (fast, slow) of the hottest pair
        self.last_transition = ""


class SloObjective:
    """One declared objective. ``method=None`` binds server-wide. Tracks
    exist for whichever targets were given: ``target_pct`` opens the
    ``errors`` + ``sheds`` pair, ``latency_ms`` opens ``latency``, and
    ``ttft_ms`` / ``itl_ms`` open the token-latency
    objectives over the ``slo_class``'s rolling p99 series — "p99 ITL
    over X ms" as a burn-rate page that can resolve."""

    def __init__(self, name: str, method: Optional[str] = None,
                 target_pct: Optional[float] = None,
                 latency_ms: Optional[float] = None,
                 latency_target_pct: float = 99.0,
                 shed_target_pct: float = 95.0,
                 series: Optional[str] = None,
                 ttft_ms: Optional[float] = None,
                 itl_ms: Optional[float] = None,
                 token_target_pct: float = 99.0,
                 slo_class: str = "interactive",
                 windows: Optional[List[Tuple[float, float, float]]] = None):
        self.name = name
        self.method = method
        self.target_pct = target_pct
        self.latency_ms = latency_ms
        self.latency_target_pct = latency_target_pct
        self.shed_target_pct = shed_target_pct
        self.ttft_ms = ttft_ms
        self.itl_ms = itl_ms
        self.token_target_pct = token_target_pct
        self.slo_class = slo_class
        #: the sampled quantile series the latency track thresholds (µs):
        #: by default the watchdog's ROLLING p99 — per-method when the
        #: objective is, the worst-method roll otherwise. Rolling, not the
        #: cumulative histogram: the signal must RECOVER when the
        #: degradation ends or a fired alert could never resolve.
        if series:
            self.series = series
        elif method is not None:
            self.series = "watchdog_p99_us{" + method + "}"
        else:
            self.series = "watchdog_rolling_p99_us"
        self.windows = list(windows) if windows else default_windows()
        self.tag = _flight.tag_for(f"slo:{name}")
        #: threshold tracks share one evaluation shape: (series, µs bar)
        self._threshold_tracks: Dict[str, Tuple[str, float]] = {}
        if latency_ms is not None:
            self._threshold_tracks["latency"] = (self.series,
                                                 latency_ms * 1000.0)
        if ttft_ms is not None:
            self._threshold_tracks["ttft"] = (
                "gen_ttft_p99_us{" + slo_class + "}", ttft_ms * 1000.0)
        if itl_ms is not None:
            self._threshold_tracks["itl"] = (
                "gen_itl_p99_us{" + slo_class + "}", itl_ms * 1000.0)
        self.tracks: Dict[str, _TrackState] = {}
        if target_pct is not None:
            self.tracks["errors"] = _TrackState()
            self.tracks["sheds"] = _TrackState()
        for t in self._threshold_tracks:
            self.tracks[t] = _TrackState()

    # -- budget math ----------------------------------------------------------

    def _budget(self, track: str) -> float:
        if track == "errors":
            return max(1e-9, 1.0 - (self.target_pct or 100.0) / 100.0)
        if track == "sheds":
            return max(1e-9, 1.0 - self.shed_target_pct / 100.0)
        if track in ("ttft", "itl"):
            return max(1e-9, 1.0 - self.token_target_pct / 100.0)
        return max(1e-9, 1.0 - self.latency_target_pct / 100.0)

    def _counts(self, db, window_s: float,
                now_ns: Optional[int]) -> Tuple[float, float, float]:
        """(total, errors, sheds) deltas over the window from the tsdb's
        flattened ``srv_calls{method,code}`` children + the shed counter."""
        total = errors = 0.0
        prefix = "srv_calls{"
        for name in db.series():
            if not name.startswith(prefix):
                continue
            inner = name[len(prefix):-1]
            method, _, code = inner.rpartition(",")
            if self.method is not None and method != self.method:
                continue
            d = db.delta(name, window_s, now_ns=now_ns)
            total += d
            if code not in ("0", "OK"):
                errors += d
        sheds = db.delta("srv_admission_rejected", window_s, now_ns=now_ns)
        return total, errors, sheds

    def bad_ratio(self, db, track: str, window_s: float,
                  now_ns: Optional[int] = None) -> Optional[float]:
        """The fraction of the window that was 'bad' for one track, or
        None when the window holds no evidence yet."""
        thr = self._threshold_tracks.get(track)
        if thr is not None:
            series, bar_us = thr
            return db.over_threshold_fraction(series, bar_us, window_s,
                                              now_ns=now_ns)
        total, errors, sheds = self._counts(db, window_s, now_ns)
        if track == "sheds":
            denom = total + sheds
            return (sheds / denom) if denom > 0 else None
        if total <= 0:
            return None
        # pushback-aware: sheds never reach a handler, so they cannot be
        # in srv_calls — errors here are handler/transport failures only
        return errors / total

    def burns(self, db, track: str, now_ns: Optional[int] = None
              ) -> List[Tuple[float, float, float]]:
        """Per window pair: ``(burn_fast, burn_slow, threshold)`` — burn
        rate is bad_ratio / budget (1.0 = exactly on budget)."""
        budget = self._budget(track)
        out = []
        for fast_s, slow_s, thr in self.windows:
            bf = self.bad_ratio(db, track, fast_s, now_ns=now_ns)
            bs = self.bad_ratio(db, track, slow_s, now_ns=now_ns)
            out.append(((bf or 0.0) / budget, (bs or 0.0) / budget, thr))
        return out


class SloEvaluator:
    """Holds the declared objectives and drives their state machines on a
    cadence. One process-wide instance (:func:`get`); tests build private
    ones and call :meth:`evaluate_once` with a pinned clock."""

    def __init__(self, eval_s: Optional[float] = None, tsdb=None):
        fast = default_windows()[0][0]
        self.eval_s = eval_s if eval_s is not None else max(
            0.05, _env_float("TPURPC_SLO_EVAL_S", fast / 4.0))
        self._tsdb = tsdb
        self._objectives: Dict[str, SloObjective] = {}
        self._lock = threading.Lock()
        self._history: List[dict] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _db(self):
        if self._tsdb is not None:
            return self._tsdb
        from tpurpc_torch.obs import tsdb as _tsdb_mod

        return _tsdb_mod.get()

    # -- declaration ----------------------------------------------------------

    def declare(self, objective: SloObjective) -> SloObjective:
        with self._lock:
            self._objectives[objective.name] = objective
        return objective

    def objectives(self) -> List[SloObjective]:
        with self._lock:
            return list(self._objectives.values())

    # -- evaluation -----------------------------------------------------------

    def _transition(self, obj: SloObjective, track: str, st: _TrackState,
                    new_state: str, burn: Tuple[float, float],
                    now_ns: int) -> None:
        old = st.state
        st.state = new_state
        st.since_ns = now_ns
        st.last_transition = f"{old}->{new_state}"
        self._history.append({
            "t": time.time(),  # tpr: allow(wallclock)
            "objective": obj.name, "track": track,
            "from": old, "to": new_state,
            "burn_fast": round(burn[0], 2), "burn_slow": round(burn[1], 2),
        })
        del self._history[:-128]
        if new_state == "firing":
            st.fired += 1
            _FIRED.labels(obj.name, track).inc()
            tag = obj.tag
            track_code = TRACK_CODES.get(track, 0)
            burn_pct = int(burn[0] * 100)
            _flight.emit(_flight.SLO_FIRING, tag, track_code, burn_pct)
            self._page(obj, track, burn)
        elif old == "firing":
            _RESOLVED.inc()
            tag = obj.tag
            track_code = TRACK_CODES.get(track, 0)
            burn_pct = int(burn[0] * 100)
            _flight.emit(_flight.SLO_RESOLVED, tag, track_code, burn_pct)

    def _page(self, obj: SloObjective, track: str,
              burn: Tuple[float, float]) -> None:
        """The watchdog bridge: a firing page lands in /debug/stalls with
        stage ``slo`` (and through the watchdog's trip hooks, triggers
        automatic evidence capture)."""
        try:
            from tpurpc_torch.obs import watchdog as _watchdog

            _watchdog.get().external_trip(
                "slo", obj.name,
                f"SLO burn-rate alert firing: track={track} "
                f"burn={burn[0]:.1f}x fast / {burn[1]:.1f}x slow "
                f"(method={obj.method or '*'})")
        except Exception:
            pass  # paging plumbing must never break the evaluator

    def evaluate_once(self, now_ns: Optional[int] = None) -> None:
        now = now_ns if now_ns is not None else time.monotonic_ns()
        db = self._db()
        for obj in self.objectives():
            for track, st in obj.tracks.items():
                try:
                    burns = obj.burns(db, track, now_ns=now)
                except Exception:
                    continue
                # the hottest pair drives the display; conditions scan all
                hot = max(burns, key=lambda b: b[0] / b[2]) if burns else \
                    (0.0, 0.0, 1.0)
                st.last_burn = (round(hot[0], 2), round(hot[1], 2))
                fire = any(bf >= thr and bs >= thr for bf, bs, thr in burns)
                pend = any(bf >= thr for bf, _bs, thr in burns)
                # ok always passes through pending (Prometheus `for:`
                # semantics): the acceptance contract is that a page is
                # OBSERVABLY pending→firing, never a 0-to-paged jump
                if st.state == "ok" and pend:
                    self._transition(obj, track, st, "pending",
                                     st.last_burn, now)
                elif st.state == "pending":
                    if fire:
                        self._transition(obj, track, st, "firing",
                                         st.last_burn, now)
                    elif not pend:
                        self._transition(obj, track, st, "ok",
                                         st.last_burn, now)
                elif st.state == "firing" and not fire:
                    self._transition(obj, track, st, "ok",
                                     st.last_burn, now)

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.eval_s):
            try:
                self.evaluate_once()
            except Exception:
                pass  # the pager must never take the server down

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = threading.Event()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="tpurpc-slo")
        self._thread = t
        t.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
        self._thread = None

    # -- export ---------------------------------------------------------------

    def firing(self) -> List[dict]:
        out = []
        for obj in self.objectives():
            for track, st in obj.tracks.items():
                if st.state == "firing":
                    out.append({"objective": obj.name, "track": track,
                                "method": obj.method,
                                "burn_fast": st.last_burn[0],
                                "burn_slow": st.last_burn[1],
                                "since_ns": st.since_ns})
        return out

    def doc(self) -> dict:
        objs = []
        for obj in self.objectives():
            tracks = {}
            for track, st in obj.tracks.items():
                tracks[track] = {
                    "state": st.state,
                    "budget": obj._budget(track),
                    "burn_fast": st.last_burn[0],
                    "burn_slow": st.last_burn[1],
                    "since_ns": st.since_ns,
                    "fired": st.fired,
                }
            objs.append({
                "name": obj.name,
                "method": obj.method,
                "target_pct": obj.target_pct,
                "latency_ms": obj.latency_ms,
                "latency_target_pct": obj.latency_target_pct,
                "shed_target_pct": obj.shed_target_pct,
                "ttft_ms": obj.ttft_ms,
                "itl_ms": obj.itl_ms,
                "slo_class": obj.slo_class,
                "series": obj.series,
                "windows": [list(w) for w in obj.windows],
                "tracks": tracks,
            })
        with self._lock:
            history = list(self._history)
        return {"objectives": objs, "history": history,
                "eval_s": self.eval_s,
                "firing": self.firing(),
                "running": self._thread is not None
                and self._thread.is_alive()}


# -- process-wide instance -----------------------------------------------------

_instance: Optional[SloEvaluator] = None
_instance_lock = threading.Lock()


def get() -> SloEvaluator:
    global _instance
    if _instance is None:
        with _instance_lock:
            if _instance is None:
                _instance = SloEvaluator()
    return _instance


def declare(name: str, **kwargs) -> SloObjective:
    """Declare (or replace) one objective and make sure the evaluator and
    its tsdb substrate are running. See :class:`SloObjective`."""
    obj = get().declare(SloObjective(name, **kwargs))
    ensure_started()
    return obj


def objectives() -> List[SloObjective]:
    return get().objectives()


def firing() -> List[dict]:
    ev = _instance
    return ev.firing() if ev is not None else []


def ensure_started() -> Optional[SloEvaluator]:
    """Start the evaluator iff objectives exist (idempotent). Also starts
    the tsdb sampler — burn rates integrate over its history."""
    ev = get()
    if not ev.objectives():
        return None
    from tpurpc_torch.obs import tsdb as _tsdb_mod

    _tsdb_mod.ensure_started()
    ev.start()
    return ev


def slo_doc() -> dict:
    """``GET /debug/slo`` body."""
    return get().doc()


def health_lines() -> List[str]:
    """One ``slo`` line per non-ok (objective, track) for /healthz —
    scrape.py appends these under the same ``sys.modules`` gate the kv
    and gen lines use, so processes without an SLO plane keep their
    exact old bodies."""
    out = []
    ev = _instance
    if ev is None:
        return out
    for obj in ev.objectives():
        for track, st in obj.tracks.items():
            if st.state != "ok":
                out.append(
                    f"slo {obj.name}: state={st.state} track={track} "
                    f"burn={st.last_burn[0]:.1f}x/{st.last_burn[1]:.1f}x")
    return sorted(out)


def reset() -> None:
    """Test isolation: stop the evaluator and forget every objective."""
    global _instance
    ev = _instance
    if ev is not None:
        ev.stop()
    _instance = None


def postfork_reset() -> None:
    """Forget the process-wide evaluator without stopping it (the
    reference's forked workers call it; the port's spawned workers start
    with none)."""
    global _instance, _instance_lock
    _instance_lock = threading.Lock()
    _instance = None
