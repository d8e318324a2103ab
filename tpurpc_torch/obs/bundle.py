"""Automatic evidence capture: the self-contained postmortem.

A copy of ``tpurpc/obs/bundle.py`` (the same layout, caps, rate limit,
flight code and variables). When an SLO alert fires or the stall watchdog
trips, the evidence is in this process (the flight ring, the tail traces,
the collapsed profile, the waterfall, the tsdb window around the event)
but volatile. A bundle freezes it to disk at the moment of degradation::

    <root>/bundle-<utcstamp>-<trigger>-<pid>-<seq>/
        flight-<pid>.json   the flight ring as a plain JSON event list
                            (the TPURPC_FLIGHT_DUMP format)
        traces.json         chrome-trace export of the span buffer
        profile.txt         collapsed stacks (flamegraph.pl input)
        waterfall.json      per-hop byte-flow table
        history.json        every tsdb series' fine window, with kinds
        slo.json            objective/track states and transitions
        stalls.json         the watchdog's snapshot
        diagnosis.json      the ranked causal hypotheses at capture time
        meta.json           trigger, detail, stamps

Every file but the flight dump is a JSON object (or text), so a directory
walk that reads each ``*.json`` as a flight dump sees events only in
``flight-*.json``: the bundle is a valid protocol-check argument.

Discipline: at most one bundle per ``min_interval_s``
(``TPURPC_BUNDLE_MIN_INTERVAL_S``, default 30 s) per trigger key and a
global floor of half that between any two; at most ``max_bundles``
directories and ``max_total_bytes`` under the root, oldest deleted first.

Arming: :func:`enable` (or ``TPURPC_BUNDLE_DIR`` through
:func:`maybe_enable_from_env`, which ``Server.start`` calls) registers a
watchdog trip hook; a firing SLO reaches the watchdog through
``external_trip``, so one hook covers both triggers. Rendering:
``python -m tpurpc_torch.tools.bundle <dir>``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _metrics

__all__ = [
    "BundleWriter", "enable", "disable", "enabled", "get",
    "maybe_enable_from_env", "capture", "TRIGGER_CODES", "list_bundles",
]

#: flight-event a1 values naming the capture trigger (append-only)
TRIGGER_CODES = {"slo": 0, "watchdog": 1, "manual": 2}

_BUNDLES_WRITTEN = _metrics.counter("bundles_written")
_BUNDLES_RATELIMITED = _metrics.counter("bundles_ratelimited")

#: interned once: the bundle plane's flight entity
_BUNDLE_TAG = _flight.tag_for("bundle")


class BundleWriter:
    def __init__(self, root: str, max_bundles: int = 8,
                 max_total_bytes: int = 64 << 20,
                 min_interval_s: Optional[float] = None):
        self.root = root
        self.max_bundles = max(1, int(max_bundles))
        self.max_total_bytes = int(max_total_bytes)
        if min_interval_s is None:
            raw = os.environ.get("TPURPC_BUNDLE_MIN_INTERVAL_S", "")
            try:
                min_interval_s = float(raw) if raw else 30.0
            except ValueError:
                min_interval_s = 30.0
        self.min_interval_s = min_interval_s
        self._lock = threading.Lock()
        self._last_by_key: Dict[str, float] = {}
        self._last_any = 0.0
        self._seq = 0

    # -- rate limiting --------------------------------------------------------

    def _admit(self, key: str) -> bool:
        now = time.monotonic()
        with self._lock:
            last = self._last_by_key.get(key, 0.0)
            if now - last < self.min_interval_s:
                return False
            # global floor: two DIFFERENT alerts in the same second are
            # one incident — half the per-key interval apart is enough
            if now - self._last_any < self.min_interval_s / 2:
                return False
            self._last_by_key[key] = now
            self._last_any = now
            self._seq += 1
            return True

    # -- capture --------------------------------------------------------------

    def capture(self, trigger: str, detail: str = "",
                key: Optional[str] = None) -> Optional[str]:
        """Write one bundle; returns its directory path, or None when
        rate-limited or on any failure (evidence capture must never take
        down the thing it is documenting)."""
        key = key or trigger
        if not self._admit(key):
            _BUNDLES_RATELIMITED.inc()
            return None
        try:
            return self._write(trigger, detail)
        except Exception:
            return None

    def _write(self, trigger: str, detail: str) -> str:
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        pid = os.getpid()
        name = f"bundle-{stamp}-{trigger}-{pid}-{self._seq}"
        path = os.path.join(self.root, name)
        os.makedirs(path, exist_ok=True)

        # 1) the flight ring, TPURPC_FLIGHT_DUMP format (a plain list)
        events = _flight.RECORDER.snapshot()
        self._dump(path, f"flight-{pid}.json", events, raw_list=True)

        # 2) tail traces (chrome-trace doc — a JSON object)
        try:
            from tpurpc_torch.obs import tracing as _tracing

            self._dump(path, "traces.json", _tracing.chrome_trace())
        except Exception:
            pass
        # 3) collapsed profile
        try:
            from tpurpc_torch.obs import profiler as _profiler

            with open(os.path.join(path, "profile.txt"), "w",
                      encoding="utf-8") as f:
                f.write(_profiler.collapsed_text())
        except Exception:
            pass
        # 4) the byte-flow waterfall
        try:
            from tpurpc_torch.obs import lens as _lens

            self._dump(path, "waterfall.json", _lens.waterfall())
        except Exception:
            pass
        # 5) the tsdb window bracketing the event: every series' fine
        #    window (bounded: fine slots x series cap, all floats)
        try:
            from tpurpc_torch.obs import tsdb as _tsdb

            db = _tsdb.get()
            span = db.fine_window_s
            kinds = db.series()
            hist = {"window_s": span, "grain_s": db.fine_s, "series": {},
                    # series kinds ride along so the
                    # offline replay applies the same reset-aware delta
                    # transform the live change-point scan uses
                    "kinds": {}}
            for s in sorted(kinds):
                pts = db.window(s, span)
                if pts:
                    hist["series"][s] = [[t, v] for t, v in pts]
                    hist["kinds"][s] = kinds[s]
            self._dump(path, "history.json", hist)
        except Exception:
            pass
        # 6) SLO + watchdog state
        try:
            from tpurpc_torch.obs import slo as _slo

            self._dump(path, "slo.json", _slo.slo_doc())
        except Exception:
            pass
        try:
            from tpurpc_torch.obs import watchdog as _watchdog

            self._dump(path, "stalls.json", _watchdog.get().snapshot())
        except Exception:
            pass
        # 7) the diagnosis AT CAPTURE TIME — the ranked
        #    hypotheses for the trip that caused this bundle (a JSON
        #    object, no top-level "events": protocol walks stay clean)
        try:
            from tpurpc_torch.obs import diagnose as _diagnose

            if _diagnose.enabled():
                self._dump(path, "diagnosis.json",
                           _diagnose.diagnose(_diagnose.LivePlanes()))
        except Exception:
            pass
        meta = {
            "trigger": trigger,
            "detail": detail,
            "pid": pid,
            "t_wall": time.time(),  # tpr: allow(wallclock)
            "t_mono_ns": time.monotonic_ns(),
            "seq": self._seq,
            # NB: not "events" — a directory protocol walk reads any
            # top-level "events" key as a flight stream
            "n_events": len(events),
            "tool": "tpurpc_torch.obs.bundle",
        }
        self._dump(path, "meta.json", meta)

        self._enforce_caps(keep=name)
        _BUNDLES_WRITTEN.inc()
        trig = TRIGGER_CODES.get(trigger, 2)
        seq = self._seq
        _flight.emit(_flight.BUNDLE_WRITTEN, _BUNDLE_TAG, trig, seq)
        return path

    @staticmethod
    def _dump(path: str, fname: str, obj, raw_list: bool = False) -> None:
        assert raw_list or isinstance(obj, dict), fname
        with open(os.path.join(path, fname), "w", encoding="utf-8") as f:
            json.dump(obj, f)

    # -- caps -----------------------------------------------------------------

    def _bundles(self) -> List[str]:
        try:
            names = [n for n in os.listdir(self.root)
                     if n.startswith("bundle-")
                     and os.path.isdir(os.path.join(self.root, n))]
        except OSError:
            return []
        return sorted(names)  # utc stamp prefix: lexical == chronological

    def _enforce_caps(self, keep: str) -> None:
        names = self._bundles()
        while len(names) > self.max_bundles:
            victim = names.pop(0)
            if victim == keep and names:
                victim = names.pop(0)
            shutil.rmtree(os.path.join(self.root, victim),
                          ignore_errors=True)
        while len(names) > 1 and self._total_bytes() > self.max_total_bytes:
            victim = names.pop(0)
            if victim == keep:
                continue
            shutil.rmtree(os.path.join(self.root, victim),
                          ignore_errors=True)

    def _total_bytes(self) -> int:
        total = 0
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, fn))
                except OSError:
                    continue
        return total


# -- process-wide arming -------------------------------------------------------

_writer: Optional[BundleWriter] = None
_writer_lock = threading.Lock()


def _on_trip(diag: dict) -> None:
    """The watchdog trip hook: one capture per trip, keyed by stage+method
    so a flapping alert (same page over and over) is one bundle per
    rate-limit interval while a DIFFERENT page still captures."""
    w = _writer
    if w is None:
        return
    trigger = "slo" if diag.get("stage") == "slo" else "watchdog"
    key = f"{diag.get('stage')}:{diag.get('method')}"
    w.capture(trigger,
              detail=f"{diag.get('method')} stage={diag.get('stage')}: "
                     f"{diag.get('detail', '')}",
              key=key)


def enable(root: str, **kwargs) -> BundleWriter:
    """Arm automatic capture into ``root`` (idempotent per path)."""
    global _writer
    from tpurpc_torch.obs import watchdog as _watchdog

    with _writer_lock:
        if _writer is None or _writer.root != root:
            os.makedirs(root, exist_ok=True)
            _writer = BundleWriter(root, **kwargs)
        _watchdog.add_trip_hook(_on_trip)
        return _writer


def disable() -> None:
    global _writer
    from tpurpc_torch.obs import watchdog as _watchdog

    with _writer_lock:
        _watchdog.remove_trip_hook(_on_trip)
        _writer = None


def enabled() -> bool:
    return _writer is not None


def get() -> Optional[BundleWriter]:
    return _writer


def maybe_enable_from_env() -> Optional[BundleWriter]:
    """``TPURPC_BUNDLE_DIR=<dir>`` arms capture; ``Server.start`` calls
    this so any serving process opts in by environment alone."""
    root = os.environ.get("TPURPC_BUNDLE_DIR", "")
    if not root:
        return None
    return enable(root)


def capture(trigger: str = "manual", detail: str = "") -> Optional[str]:
    """Manual capture through the armed writer (None when disarmed)."""
    w = _writer
    return w.capture(trigger, detail=detail) if w is not None else None


def list_bundles(root: str) -> List[str]:
    """Bundle directory names under ``root``, oldest first."""
    return BundleWriter(root)._bundles()
