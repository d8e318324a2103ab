"""The causal diagnosis engine: from seeing to explaining.

A copy of ``tpurpc/obs/diagnose.py`` (the same rules, causes, scores and
documents). The telemetry planes (tsdb, flight, watchdog, lens, and the
generation plane's ledgers and the C core's counters once ported) each see
a fault; this module correlates them into a ranked answer to "why". A
SYMPTOM (an active or recent watchdog trip, a firing SLO, or an operator
query) goes in; ranked hypotheses come out, each with a cause slug, a
combined confidence, the cited evidence as ``(plane, ref, value)``
triples, and an ``actionable`` hint.

Three layers, all pure reads:

* **onset**: :func:`detect_onset` fixes when a series changed: counters
  become reset-aware positive deltas, then an exhaustive mean-shift split
  (O(n) by prefix sums) scored as ``|Δmean| · sqrt(nl·nr/n) / pooled_sd``;
  only splits past ``min_score`` count.
* **rules**: a registry of ``Rule(symptom_kinds, collect, score)``;
  collect functions only READ the planes, score functions turn facts into
  hypotheses. Per cause the confidences combine noisy-OR,
  ``1 - Π(1 - c_i)``, capped at 0.99.
* **faces**: ``GET /debug/diagnose`` on the scrape plane (shard fan-out
  through :func:`merge_diagnose_docs`), ``/fleet/diagnose`` on the
  collector, and ``python -m tpurpc_torch.tools.diagnose <bundle-dir>``
  replaying a bundle through :class:`BundlePlanes` into the same report;
  every bundle also carries the ``diagnosis.json`` written at trip time.

``TPURPC_DIAGNOSE=0`` turns the plane off. All six stock rules are
registered; ``seq-ledger`` reads the generation plane's ledgers
(:mod:`tpurpc_torch.obs.odyssey`, through a ``sys.modules`` gate), and one
reads nothing yet: ``native-counters``' planes gate on
``tpurpc_torch.obs.native_obs`` (ROADMAP A7 (b)).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Hypothesis", "Rule", "Planes", "LivePlanes", "BundlePlanes",
    "detect_onset", "series_shifts", "find_symptom", "diagnose",
    "diagnose_doc", "diagnose_bundle", "merge_diagnose_docs",
    "render_text", "enabled", "register", "rules", "ACTIONS",
]


def enabled() -> bool:
    from tpurpc_torch.utils.config import _env

    return (_env("TPURPC_DIAGNOSE") or "1").lower() not in (
        "0", "off", "false")


# -- change-point detection ----------------------------------------------------

#: fewest points a series needs before an onset claim is admissible
MIN_POINTS = 8
#: t-like score floor — below it a split is noise, not an onset
MIN_SCORE = 4.0


def detect_onset(points: Sequence[Tuple[int, float]], kind: str = "gauge",
                 min_points: int = MIN_POINTS,
                 min_score: float = MIN_SCORE) -> Optional[dict]:
    """The single strongest mean shift in one series, or None.

    ``points`` are time-ordered ``(t_ns, value)``. Counter series are
    first reduced to reset-aware positive deltas (a negative delta is a
    restart; the post-reset value IS the missing delta — the exact
    algebra ``Tsdb.rate`` uses), so a restarting worker cannot fake a
    cliff. The returned onset names the FIRST point of the right-hand
    (post-shift) segment:

        {"t_ns", "index", "direction" (+1 rise / -1 fall),
         "magnitude" (right mean - left mean), "score"}
    """
    pts = list(points)
    if len(pts) < min_points:
        return None
    if kind == "counter":
        ts: List[int] = []
        vals: List[float] = []
        prev = pts[0][1]
        for t, v in pts[1:]:
            d = v - prev
            vals.append(d if d >= 0 else v)
            ts.append(t)
            prev = v
    else:
        ts = [t for t, _v in pts]
        vals = [v for _t, v in pts]
    n = len(vals)
    if n < min_points:
        return None
    # prefix sums: every candidate split scored in O(1), the scan in O(n)
    ps = [0.0] * (n + 1)
    pss = [0.0] * (n + 1)
    for i, v in enumerate(vals):
        ps[i + 1] = ps[i] + v
        pss[i + 1] = pss[i] + v * v
    best_score = 0.0
    best_i = -1
    best_mag = 0.0
    for i in range(2, n - 1):
        nl = i
        nr = n - i
        ml = ps[i] / nl
        mr = (ps[n] - ps[i]) / nr
        var_l = max(0.0, pss[i] / nl - ml * ml)
        var_r = max(0.0, (pss[n] - pss[i]) / nr - mr * mr)
        pooled = math.sqrt((var_l * nl + var_r * nr) / n)
        score = abs(mr - ml) * math.sqrt(nl * nr / n) / (pooled + 1e-9)
        if score > best_score:
            best_score, best_i, best_mag = score, i, mr - ml
    if best_i < 0 or best_score < min_score:
        return None
    return {
        "t_ns": ts[best_i],
        "index": best_i,
        "direction": 1 if best_mag > 0 else -1,
        "magnitude": round(best_mag, 6),
        "score": round(min(best_score, 1e6), 2),
    }


def series_shifts(windows: Dict[str, List[Tuple[int, float]]],
                  kinds: Dict[str, str]) -> Dict[str, dict]:
    """Onsets for every series that has one (the cross-plane scan the
    tsdb-shift rule and the report's ``onsets`` block are built from)."""
    out: Dict[str, dict] = {}
    for name, pts in windows.items():
        onset = detect_onset(pts, kind=kinds.get(name, "gauge"))
        if onset is not None:
            out[name] = onset
    return out


# -- planes: one read-only adapter per evidence source -------------------------


class Planes:
    """Read-only view over every telemetry plane. The rules below speak
    ONLY this interface, so the live route and the offline bundle replay
    run the identical engine — parity is structural, not aspirational.
    Every accessor is total: a missing/broken plane reads as empty."""

    def __init__(self):
        self._shifts: Optional[Dict[str, dict]] = None

    # per-source accessors (overridden)
    def now_ns(self) -> int:
        return 0

    def windows(self) -> Dict[str, List[Tuple[int, float]]]:
        return {}

    def kinds(self) -> Dict[str, str]:
        return {}

    def flight_events(self) -> List[dict]:
        return []

    def watchdog(self) -> dict:
        return {}

    def slo(self) -> Optional[dict]:
        return None

    def seq(self) -> Optional[dict]:
        return None

    def waterfall(self) -> Optional[dict]:
        return None

    def native(self) -> Dict[str, float]:
        return {}

    # shared derived view
    def shifts(self) -> Dict[str, dict]:
        if self._shifts is None:
            self._shifts = series_shifts(self.windows(), self.kinds())
        return self._shifts


class LivePlanes(Planes):
    """The in-process view: tsdb snapshot, merged flight timeline
    (Python + native lanes), watchdog snapshot, SLO/seq/lens docs, C
    metrics table. Each source is fetched once and cached — one
    diagnosis is one consistent read."""

    def __init__(self, now_ns: Optional[int] = None):
        super().__init__()
        self._now = now_ns if now_ns is not None else time.monotonic_ns()
        self._windows: Optional[Dict[str, List[Tuple[int, float]]]] = None
        self._kinds: Dict[str, str] = {}
        self._flight: Optional[List[dict]] = None
        self._watchdog: Optional[dict] = None

    def now_ns(self) -> int:
        return self._now

    def windows(self) -> Dict[str, List[Tuple[int, float]]]:
        if self._windows is None:
            try:
                from tpurpc_torch.obs import tsdb as _tsdb

                if _tsdb.enabled():
                    db = _tsdb.get()
                    self._windows = db.snapshot_windows(now_ns=self._now)
                    self._kinds = db.series()
                else:
                    self._windows = {}
            except Exception:
                self._windows = {}
        return self._windows

    def kinds(self) -> Dict[str, str]:
        self.windows()
        return self._kinds

    def flight_events(self) -> List[dict]:
        if self._flight is None:
            try:
                from tpurpc_torch.obs import flight as _flight

                self._flight = _flight.snapshot(
                    since_ns=self._now - 120_000_000_000, limit=1024)
            except Exception:
                self._flight = []
        return self._flight

    def watchdog(self) -> dict:
        if self._watchdog is None:
            try:
                from tpurpc_torch.obs import watchdog as _watchdog

                self._watchdog = _watchdog.get().snapshot()
            except Exception:
                self._watchdog = {}
        return self._watchdog

    def slo(self) -> Optional[dict]:
        # sys.modules gate: a process without an SLO plane stays without
        mod = sys.modules.get("tpurpc_torch.obs.slo")
        if mod is None:
            return None
        try:
            return mod.slo_doc()
        except Exception:
            return None

    def seq(self) -> Optional[dict]:
        mod = sys.modules.get("tpurpc_torch.obs.odyssey")
        if mod is None:
            return None
        try:
            return mod.seq_doc()
        except Exception:
            return None

    def waterfall(self) -> Optional[dict]:
        try:
            from tpurpc_torch.obs import lens as _lens

            if not _lens.enabled():
                return None
            return _lens.waterfall()
        except Exception:
            return None

    def native(self) -> Dict[str, float]:
        mod = sys.modules.get("tpurpc_torch.obs.native_obs")
        if mod is None:
            return {}
        try:
            return mod.counters() or {}
        except Exception:
            return {}


class BundlePlanes(Planes):
    """The offline view: a postmortem bundle directory replayed
    through the same interface. ``history.json`` feeds the tsdb windows
    (with its ``kinds`` map when present — older bundles fall back to
    name-suffix inference), ``flight-*.json`` the event algebra,
    ``stalls.json``/``slo.json``/``waterfall.json`` the rest. ``now``
    is the capture stamp (``meta.json`` ``t_mono_ns``) so edge ages are
    computed against WHEN the evidence froze, not when a human reads it."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        self._history = self._load("history.json") or {}
        self._stalls = self._load("stalls.json") or {}
        self._slo = self._load("slo.json")
        self._waterfall = self._load("waterfall.json")
        self._meta = self._load("meta.json") or {}
        self._flight: List[dict] = []
        try:
            for name in sorted(os.listdir(root)):
                if name.startswith("flight-") and name.endswith(".json"):
                    evs = self._load(name)
                    if isinstance(evs, list):
                        self._flight.extend(
                            e for e in evs if isinstance(e, dict))
        except OSError:
            pass
        self._flight.sort(key=lambda e: e.get("t_ns", 0))

    def _load(self, fname: str):
        try:
            with open(os.path.join(self.root, fname),
                      encoding="utf-8") as f:
                return json.load(f)
        except Exception:
            return None

    def now_ns(self) -> int:
        t = self._meta.get("t_mono_ns")
        if t:
            return int(t)
        best = 0
        for pts in (self._history.get("series") or {}).values():
            if pts:
                best = max(best, int(pts[-1][0]))
        if self._flight:
            best = max(best, int(self._flight[-1].get("t_ns", 0)))
        return best

    def windows(self) -> Dict[str, List[Tuple[int, float]]]:
        series = self._history.get("series") or {}
        return {name: [(int(t), float(v)) for t, v in pts]
                for name, pts in series.items()}

    def kinds(self) -> Dict[str, str]:
        kinds = self._history.get("kinds")
        if isinstance(kinds, dict) and kinds:
            return kinds
        # bundles without a kinds map: quantile exports are
        # named ``:pNN``/``:count``; everything else scores safest as a
        # gauge (counters merely lose the delta transform)
        out = {}
        for name in (self._history.get("series") or {}):
            out[name] = "quantile" if ":" in name else "gauge"
        return out

    def flight_events(self) -> List[dict]:
        return self._flight

    def watchdog(self) -> dict:
        return self._stalls

    def slo(self) -> Optional[dict]:
        return self._slo

    def waterfall(self) -> Optional[dict]:
        return self._waterfall

    def meta(self) -> dict:
        return self._meta


# -- symptom ------------------------------------------------------------------


def find_symptom(planes: Planes, want: Optional[str] = None
                 ) -> Optional[dict]:
    """Resolve what we are diagnosing: ``{"kind", "detail", ...}``.

    ``want`` None/"auto" walks the precedence ladder — an ACTIVE
    watchdog stall beats a firing SLO beats recent watchdog history
    (the bundle replay case: the trip that caused the capture is
    history by the time the snapshot freezes). "slo"/"watchdog" pin one
    plane; "healthz" is an alias for auto (healthz degradation IS
    watchdog-or-slo); any other string is an operator query diagnosed
    against every rule."""
    wd = planes.watchdog() or {}
    slo = planes.slo() or {}
    firing = slo.get("firing") or []
    active = wd.get("active") or []
    history = wd.get("history") or []

    def _wd_symptom(d: dict, state: str) -> dict:
        return {"kind": "watchdog", "state": state,
                "stage": d.get("stage"), "method": d.get("method"),
                "detail": d.get("detail"), "t_ns": d.get("since_ns")}

    def _slo_symptom(a: dict) -> dict:
        return {"kind": "slo", "state": "firing",
                "detail": f"{a.get('objective')}/{a.get('track')}",
                "t_ns": a.get("since_ns")}

    if want in (None, "", "auto", "healthz"):
        if active:
            return _wd_symptom(active[0], "active")
        if firing:
            return _slo_symptom(firing[0])
        if history:
            return _wd_symptom(history[-1], "history")
        return None
    if want == "watchdog":
        if active:
            return _wd_symptom(active[0], "active")
        if history:
            return _wd_symptom(history[-1], "history")
        return None
    if want == "slo":
        return _slo_symptom(firing[0]) if firing else None
    return {"kind": "query", "detail": want, "t_ns": None}


# -- hypotheses ---------------------------------------------------------------


class Hypothesis:
    """One candidate cause with its cited evidence. ``evidence`` is a
    list of ``(plane, ref, value)`` triples — ``plane`` names the source
    ("watchdog", "flight", "tsdb", "lens", "seq", "native"), ``ref`` is
    a chaseable locator inside it, ``value`` the observed number."""

    __slots__ = ("cause", "confidence", "evidence", "rule")

    def __init__(self, cause: str, confidence: float,
                 evidence: Optional[List[tuple]] = None,
                 rule: str = ""):
        self.cause = cause
        self.confidence = max(0.0, min(1.0, confidence))
        self.evidence = list(evidence or [])
        self.rule = rule


#: cause-slug prefix -> the operator hint each ranked cause carries.
#: Keys match the part of a cause before the first ":".
ACTIONS: Dict[str, str] = {
    "credit-starvation": "grow ring credits or shed load from this pair "
                         "(TPURPC_RING_SLOTS / reroute)",
    "peer-not-reading": "restart or drain the wedged peer; reroute its "
                        "pairs until it reads again",
    "h2-flow-control": "raise the h2 window or move bulk tensors to the "
                       "rendezvous path",
    "ctrl-ring": "bounce the peer's ring consumer; grow "
                 "TPURPC_CTRL_RING_SLOTS if sized too small",
    "rendezvous": "inspect the peer's claim path; lower "
                  "TPURPC_RENDEZVOUS_CLAIM_TIMEOUT_S to fail fast to "
                  "the framed path",
    "kv-swap": "throttle admissions until the swap clears; check host "
               "arena pressure",
    "migration": "cancel or retry the migration; check the destination "
                 "peer's health",
    "decode-step": "the model step is the long pole — check device "
                   "health / batch size, not the transport",
    "batcher-wait": "raise batcher concurrency or lower the fan-in "
                    "window",
    "poller-wake": "check poller thread liveness; a lost kick needs a "
                   "transport bounce",
    "device-infer": "the peer's handler/device is the long pole — "
                    "diagnose THAT process (fleet view: /fleet/diagnose)",
    "slo": "walk the cited evidence; if none, the objective may be "
           "mis-sized for current load",
    "native-ctrl-frozen": "the peer's C drain loop froze — restart the "
                          "peer process; capture its stacks first",
    "native-pin-wait": "a claim waiter holds landing windows across a "
                       "close — check for leaked claims on the peer",
    "native-rdv-fallback": "bulk sends degrading to framed path — check "
                           "claim timeouts and window placement failures",
    "native-delivery": "the delivery shard is not draining — check "
                       "decode/materialization backpressure",
    "hot-account": "one account dominates step time — rebalance or "
                   "rate-limit it (autopilot: shed/reroute the account)",
    "slow-hop": "the named hop is the pipeline bottleneck — rebalance "
                "copy work or grow that stage",
    "metric-shift": "unattributed shift — correlate the named series "
                    "with deploys/load changes",
}


def _action_for(cause: str) -> Optional[str]:
    return ACTIONS.get(cause.partition(":")[0])


# -- rule registry ------------------------------------------------------------


class Rule:
    """One declarative evidence rule. ``collect`` pulls facts from the
    planes (READ-ONLY — the ``diag`` lint rule audits it), ``score``
    turns them into hypotheses. ``symptom_kinds`` gates which symptom
    kinds the rule runs for (empty = all)."""

    __slots__ = ("name", "symptom_kinds", "collect", "score")

    def __init__(self, name: str, symptom_kinds: Sequence[str],
                 collect: Callable, score: Callable):
        self.name = name
        self.symptom_kinds = frozenset(symptom_kinds)
        self.collect = collect
        self.score = score


_RULES: List[Rule] = []


def register(rule: Rule) -> None:
    _RULES.append(rule)


def rules() -> List[Rule]:
    return list(_RULES)


# -- rule: watchdog stage (the most specific single witness) -------------------


def _collect_watchdog_stage(planes: Planes, symptom: dict) -> List[tuple]:
    snap = planes.watchdog() or {}
    facts = [("active", d) for d in (snap.get("active") or [])]
    facts.extend(("history", d) for d in (snap.get("history") or [])[-8:])
    return facts


def _score_watchdog_stage(facts: List[tuple], planes: Planes,
                          symptom: dict) -> List[Hypothesis]:
    out = []
    seen = set()
    for state, d in facts:
        stage = d.get("stage")
        if not stage:
            continue
        key = (stage, d.get("since_ns"))
        if key in seen:
            continue
        seen.add(key)
        conf = 0.9 if state == "active" else 0.55
        ev = [("watchdog", f"{state}:{d.get('method')}",
               d.get("age_s"))]
        cause = d.get("cause") or {}
        if cause.get("entity"):
            ev.append(("watchdog", "entity", cause["entity"]))
        for item in (cause.get("evidence") or [])[:4]:
            ev.append(tuple(item))
        out.append(Hypothesis(stage, conf, ev, rule="watchdog-stage"))
    return out


register(Rule("watchdog-stage", (), _collect_watchdog_stage,
              _score_watchdog_stage))


# -- rule: flight edge algebra near onset --------------------------------------


def _collect_flight_edges(planes: Planes, symptom: dict) -> dict:
    """Open-bracket algebra over the merged flight tail (native lane
    included) — the same pairing the watchdog sweeps, recomputed here so
    a bundle replay (or a diagnosis with the watchdog off) still has
    first-class edge evidence."""
    from tpurpc_torch.obs import flight as _flight

    now = planes.now_ns()
    open_lease = 0
    lease_ent = None
    open_rdv: Dict[tuple, int] = {}
    open_ctrl: Dict[str, int] = {}
    open_nctrl: Dict[str, int] = {}
    open_pin: Dict[str, int] = {}
    open_dlv: Dict[str, int] = {}
    open_stall: Dict[str, int] = {}
    fallbacks: List[int] = []
    last_h2 = 0
    h2_ent = None
    for e in planes.flight_events():
        code = e.get("code")
        ent = e.get("entity")
        t = e.get("t_ns", 0)
        if code == _flight.LEASE_RESERVE:
            open_lease += 1
            lease_ent = ent
        elif code in (_flight.LEASE_COMMIT, _flight.LEASE_ABORT):
            open_lease = max(0, open_lease - 1)
        elif code == _flight.CTRL_STALL_BEGIN:
            (open_nctrl if e.get("lane") == "native"
             else open_ctrl)[ent] = t
        elif code == _flight.CTRL_STALL_END:
            (open_nctrl if e.get("lane") == "native"
             else open_ctrl).pop(ent, None)
        elif code == _flight.WRITE_STALL_BEGIN:
            open_stall[ent] = t
        elif code == _flight.WRITE_STALL_END:
            open_stall.pop(ent, None)
        elif code == _flight.NATIVE_PIN_WAIT_BEGIN:
            open_pin[ent] = t
        elif code == _flight.NATIVE_PIN_WAIT_END:
            open_pin.pop(ent, None)
        elif code == _flight.NATIVE_DLV_STALL_BEGIN:
            open_dlv[ent] = t
        elif code == _flight.NATIVE_DLV_STALL_END:
            open_dlv.pop(ent, None)
        elif code == _flight.NATIVE_RDV_FALLBACK:
            fallbacks.append(t)
        elif code == _flight.RDV_OFFER:
            open_rdv[(ent, "o", e.get("a1"))] = t
        elif code == _flight.RDV_CLAIM:
            open_rdv.pop((ent, "o", e.get("a1")), None)
            open_rdv[(ent, "l", e.get("a2"))] = t
        elif code in (_flight.RDV_COMPLETE, _flight.RDV_RELEASE):
            open_rdv.pop((ent, "l", e.get("a1")), None)
            if code == _flight.RDV_RELEASE:
                open_rdv.pop((ent, "o", e.get("a2")), None)
        elif code == _flight.H2_WINDOW_EXHAUSTED:
            last_h2 = t
            h2_ent = ent
    return {"now": now, "open_lease": open_lease, "lease_ent": lease_ent,
            "open_rdv": open_rdv, "open_ctrl": open_ctrl,
            "open_nctrl": open_nctrl, "open_pin": open_pin,
            "open_dlv": open_dlv, "open_stall": open_stall,
            "fallbacks": fallbacks, "last_h2": last_h2, "h2_ent": h2_ent}


def _edge_hyp(cause: str, conf: float, table: Dict, now: int,
              ref_prefix: str) -> Optional[Hypothesis]:
    if not table:
        return None
    ev = []
    for key, t in sorted(table.items(), key=lambda kv: kv[1])[:3]:
        ent = key[0] if isinstance(key, tuple) else key
        ev.append(("flight", f"{ref_prefix}:{ent}@{t}",
                   round((now - t) / 1e9, 3)))
    return Hypothesis(cause, conf, ev, rule="flight-edges")


def _score_flight_edges(facts: dict, planes: Planes,
                        symptom: dict) -> List[Hypothesis]:
    now = facts["now"]
    out: List[Hypothesis] = []
    if facts["open_lease"] > 0:
        out.append(Hypothesis(
            "credit-starvation", 0.6,
            [("flight", f"lease-reserve-open:{facts['lease_ent']}",
              facts["open_lease"])], rule="flight-edges"))
    for cause, conf, table, pref in (
            ("native-ctrl-frozen", 0.7, facts["open_nctrl"], "ctrl-stall"),
            ("ctrl-ring", 0.6, facts["open_ctrl"], "ctrl-stall"),
            ("native-pin-wait", 0.6, facts["open_pin"], "pin-wait"),
            ("native-delivery", 0.55, facts["open_dlv"], "dlv-stall"),
            ("peer-not-reading", 0.5, facts["open_stall"], "write-stall"),
            ("rendezvous", 0.5, facts["open_rdv"], "rdv-open")):
        # a fresh edge is traffic, not a wedge: only brackets open for
        # at least a second count as evidence on their own
        aged = {k: t for k, t in table.items() if now - t >= 1_000_000_000}
        h = _edge_hyp(cause, conf, aged, now, pref)
        if h is not None:
            out.append(h)
    recent_fb = [t for t in facts["fallbacks"] if now - t < 10_000_000_000]
    if len(recent_fb) >= 3:
        out.append(Hypothesis(
            "native-rdv-fallback", 0.6,
            [("flight", f"rdv-fallback@{t}", 1) for t in recent_fb[-3:]],
            rule="flight-edges"))
    if facts["last_h2"] and now - facts["last_h2"] < 15_000_000_000:
        out.append(Hypothesis(
            "h2-flow-control", 0.45,
            [("flight", f"h2-exhausted:{facts['h2_ent']}@{facts['last_h2']}",
              round((now - facts["last_h2"]) / 1e9, 3))],
            rule="flight-edges"))
    return out


register(Rule("flight-edges", (), _collect_flight_edges,
              _score_flight_edges))


# -- rule: tsdb rate shifts near onset -----------------------------------------

#: series-name fragment -> cause slug (ordered; first match wins)
_SERIES_CAUSE: List[Tuple[str, str]] = [
    ("write_stalled", "peer-not-reading"),
    ("credit", "credit-starvation"),
    ("ctrl_ring", "ctrl-ring"),
    ("rdv_fallback", "native-rdv-fallback"),
    ("fallback", "native-rdv-fallback"),
    ("pin_wait", "native-pin-wait"),
    ("dlv_", "native-delivery"),
    ("kv_swap", "kv-swap"),
    ("swap", "kv-swap"),
    ("migration", "migration"),
    ("h2_", "h2-flow-control"),
    ("batcher", "batcher-wait"),
    ("decode", "decode-step"),
]


def _collect_tsdb_shifts(planes: Planes, symptom: dict) -> List[tuple]:
    shifts = planes.shifts()
    t_sym = symptom.get("t_ns") if symptom else None
    out = []
    for name, onset in shifts.items():
        # when the symptom has an onset stamp, only shifts within ±60s
        # of it correlate; an operator query takes the whole window
        if t_sym and abs(onset["t_ns"] - t_sym) > 60_000_000_000:
            continue
        out.append((name, onset))
    out.sort(key=lambda kv: kv[1]["score"], reverse=True)
    return out[:12]


def _score_tsdb_shifts(facts: List[tuple], planes: Planes,
                       symptom: dict) -> List[Hypothesis]:
    out = []
    for name, onset in facts:
        cause = None
        for frag, slug in _SERIES_CAUSE:
            if frag in name:
                cause = slug
                break
        ev = [("tsdb", f"{name}@{onset['t_ns']}",
               onset["magnitude"])]
        if cause is None:
            # watchdog_stalls{stage} shifting IS the stage's counter
            if name.startswith("watchdog_stalls{"):
                cause = name[len("watchdog_stalls{"):].rstrip("}")
                out.append(Hypothesis(cause, 0.4, ev, rule="tsdb-shift"))
            else:
                out.append(Hypothesis(
                    f"metric-shift:{name}", 0.2, ev, rule="tsdb-shift"))
            continue
        conf = 0.45 * min(1.0, onset["score"] / 8.0)
        out.append(Hypothesis(cause, conf, ev, rule="tsdb-shift"))
    return out


register(Rule("tsdb-shift", (), _collect_tsdb_shifts, _score_tsdb_shifts))


# -- rule: lens slowest hop (corroborative) ------------------------------------


def _collect_lens_hop(planes: Planes, symptom: dict) -> Optional[dict]:
    return planes.waterfall()


def _score_lens_hop(facts: Optional[dict], planes: Planes,
                    symptom: dict) -> List[Hypothesis]:
    if not facts:
        return []
    slowest = facts.get("slowest_hop")
    if not slowest:
        return []
    row = next((r for r in facts.get("hops", [])
                if r.get("hop") == slowest), {})
    if not row.get("busy_ms"):
        return []
    return [Hypothesis(
        f"slow-hop:{slowest}", 0.3,
        [("lens", f"hop:{slowest}", row.get("gbps"))], rule="lens-hop")]


register(Rule("lens-hop", (), _collect_lens_hop, _score_lens_hop))


# -- rule: seq-ledger costliest account ----------------------------------------


def _collect_seq_ledger(planes: Planes, symptom: dict) -> Optional[dict]:
    return planes.seq()


def _score_seq_ledger(facts: Optional[dict], planes: Planes,
                      symptom: dict) -> List[Hypothesis]:
    if not facts or not facts.get("enabled"):
        return []
    accounts = facts.get("accounts") or {}
    total = float(facts.get("step_us_total") or 0.0)
    if not accounts or total <= 0:
        return []
    name, row = max(accounts.items(),
                    key=lambda kv: kv[1].get("step_us", 0))
    share = (row.get("step_us") or 0) / total
    if share < 0.5:
        return []
    return [Hypothesis(
        f"hot-account:{name}", 0.35,
        [("seq", f"account:{name}", round(share, 3))],
        rule="seq-ledger")]


register(Rule("seq-ledger", (), _collect_seq_ledger, _score_seq_ledger))


# -- rule: native fallback/stall counters (corroborative) ----------------------


def _collect_native_counters(planes: Planes,
                             symptom: dict) -> Dict[str, float]:
    return planes.native()


def _score_native_counters(facts: Dict[str, float], planes: Planes,
                           symptom: dict) -> List[Hypothesis]:
    out = []
    for key, cause, conf in (("rdv_fallbacks", "native-rdv-fallback", 0.25),
                             ("dlv_stalls", "native-delivery", 0.2),
                             ("pin_waits", "native-pin-wait", 0.15)):
        v = facts.get(key) or 0
        if v > 0:
            out.append(Hypothesis(
                cause, conf, [("native", key, v)],
                rule="native-counters"))
    return out


register(Rule("native-counters", (), _collect_native_counters,
              _score_native_counters))


# -- combination + ranking -----------------------------------------------------


def _combine(hyps: List[Hypothesis]) -> List[dict]:
    """Noisy-OR per cause: independent planes agreeing compound, one
    plane repeating itself does not (evidence dedups on (plane, ref))."""
    by: Dict[str, dict] = {}
    for h in hyps:
        agg = by.setdefault(h.cause, {"cause": h.cause, "miss": 1.0,
                                      "evidence": [], "rules": [],
                                      "_seen": set()})
        agg["miss"] *= (1.0 - h.confidence)
        if h.rule and h.rule not in agg["rules"]:
            agg["rules"].append(h.rule)
        for plane, ref, value in h.evidence:
            k = (plane, ref)
            if k in agg["_seen"]:
                continue
            agg["_seen"].add(k)
            if len(agg["evidence"]) < 8:
                agg["evidence"].append([plane, ref, value])
    out = []
    for agg in by.values():
        conf = min(0.99, 1.0 - agg["miss"])
        out.append({"cause": agg["cause"],
                    "confidence": round(conf, 3),
                    "evidence": agg["evidence"],
                    "rules": agg["rules"],
                    "actionable": _action_for(agg["cause"])})
    out.sort(key=lambda d: (-d["confidence"], d["cause"]))
    return out


# -- the engine ----------------------------------------------------------------


def diagnose(planes: Planes, want: Optional[str] = None) -> dict:
    """Run every applicable rule and return the ranked report — the one
    document all three faces serve."""
    symptom = find_symptom(planes, want)
    hyps: List[Hypothesis] = []
    if symptom is not None:
        kind = symptom.get("kind")
        for rule in _RULES:
            if rule.symptom_kinds and kind not in rule.symptom_kinds:
                continue
            try:
                facts = rule.collect(planes, symptom)
                hyps.extend(rule.score(facts, planes, symptom) or [])
            except Exception:
                continue  # one broken rule must never break the report
    shifts = planes.shifts()
    top = sorted(shifts.items(), key=lambda kv: kv[1]["score"],
                 reverse=True)[:16]
    return {
        "enabled": True,
        "symptom": symptom,
        "hypotheses": _combine(hyps),
        "onsets": {name: onset for name, onset in top},
        "rules_run": [r.name for r in _RULES],
    }


def diagnose_doc(params: Optional[dict] = None) -> dict:
    """``GET /debug/diagnose`` body (the scrape-plane face)."""
    params = params or {}
    if not enabled():
        return {"enabled": False, "reason": "TPURPC_DIAGNOSE=0"}
    doc = diagnose(LivePlanes(), want=params.get("symptom") or None)
    from tpurpc_torch.obs import shard as _shard

    if _shard.shard_id() >= 0:
        doc["shard"] = _shard.shard_id()
    return doc


def diagnose_bundle(root: str, want: Optional[str] = None) -> dict:
    """The offline face: replay a postmortem bundle directory through
    the identical engine (``python -m tpurpc_torch.tools.diagnose <dir>``)."""
    planes = BundlePlanes(root)
    doc = diagnose(planes, want=want)
    doc["bundle"] = os.path.basename(os.path.abspath(root))
    meta = planes.meta()
    if meta:
        doc["trigger"] = meta.get("trigger")
    return doc


def merge_diagnose_docs(docs: Dict[str, dict], label: str = "shard"
                        ) -> dict:
    """The pure shard/fleet merge: per-source reports keyed by shard id
    or member target -> one report. Hypotheses re-combine by cause
    across sources (noisy-OR again), each evidence row tagged with its
    source; ``corroboration`` lists which sources cite each cause — the
    "3 members degraded, all cite the same peer" signal the fleet face
    exists for."""
    merged: Dict[str, dict] = {}
    symptoms: List[dict] = []
    enabled_any = False
    for src in sorted(docs):
        doc = docs[src] or {}
        if not doc.get("enabled"):
            continue
        enabled_any = True
        sym = doc.get("symptom")
        if sym:
            symptoms.append(dict(sym, **{label: src}))
        for h in doc.get("hypotheses", ()):
            agg = merged.setdefault(h["cause"], {
                "cause": h["cause"], "miss": 1.0, "evidence": [],
                "rules": [], "sources": [],
                "actionable": h.get("actionable")})
            agg["miss"] *= (1.0 - (h.get("confidence") or 0.0))
            agg["sources"].append(src)
            for r in h.get("rules", ()):
                if r not in agg["rules"]:
                    agg["rules"].append(r)
            for plane, ref, value in h.get("evidence", ()):
                if len(agg["evidence"]) < 12:
                    agg["evidence"].append(
                        [plane, f"{label}={src}:{ref}", value])
    hyps = []
    for agg in merged.values():
        hyps.append({"cause": agg["cause"],
                     "confidence": round(min(0.99, 1.0 - agg["miss"]), 3),
                     "evidence": agg["evidence"],
                     "rules": agg["rules"],
                     "sources": agg["sources"],
                     "actionable": agg["actionable"]})
    hyps.sort(key=lambda d: (-d["confidence"], d["cause"]))
    # watchdog symptoms outrank slo outrank query; active beats history
    order = {"watchdog": 0, "slo": 1, "healthz": 2, "query": 3}
    symptoms.sort(key=lambda s: (order.get(s.get("kind"), 9),
                                 s.get("state") != "active"))
    return {
        "enabled": enabled_any,
        "sources": sorted(docs),
        "symptom": symptoms[0] if symptoms else None,
        "symptoms": symptoms,
        "hypotheses": hyps,
        "corroboration": {c: a["sources"] for c, a in merged.items()
                          if len(a["sources"]) > 1},
    }


# -- text face ----------------------------------------------------------------


def render_text(doc: Optional[dict] = None) -> str:
    """The ``?text=1`` / CLI rendering of one report."""
    if doc is None:
        doc = diagnose_doc()
    if not doc.get("enabled"):
        return f"diagnose: disabled ({doc.get('reason')})\n"
    lines = []
    sym = doc.get("symptom")
    if sym is None:
        lines.append("diagnose: no active symptom")
    else:
        what = sym.get("stage") or sym.get("detail") or sym.get("kind")
        lines.append(f"symptom [{sym.get('kind')}] {what}"
                     + (f" method={sym['method']}"
                        if sym.get("method") else ""))
    hyps = doc.get("hypotheses") or []
    if not hyps:
        lines.append("  no hypotheses")
    for i, h in enumerate(hyps[:8], 1):
        lines.append(f"  #{i} {h['cause']:<24} "
                     f"confidence={h['confidence']:.2f} "
                     f"rules={','.join(h.get('rules', []))}")
        for plane, ref, value in h.get("evidence", [])[:4]:
            lines.append(f"       [{plane}] {ref} = {value}")
        if h.get("actionable"):
            lines.append(f"       -> {h['actionable']}")
    cor = doc.get("corroboration")
    if cor:
        for cause, srcs in sorted(cor.items()):
            lines.append(f"  corroborated: {cause} cited by "
                         f"{len(srcs)} sources ({', '.join(map(str, srcs))})")
    return "\n".join(lines) + "\n"
