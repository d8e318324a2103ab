"""Stall watchdog: find the wedged RPC and name the stage.

A copy of ``tpurpc/obs/watchdog.py``. A background sweeper walks an
in-process registry of in-flight RPCs (server handlers and the pipelined
client's calls register): a call in flight past a multiple of its
method's ROLLING p99 (``TPURPC_WATCHDOG_MULT``, default 8), or past a
static floor while the method has no history (``TPURPC_WATCHDOG_MIN_S``,
default 1.0), yields a diagnosis naming the blocked *stage*, derived from
the flight recorder's tail and the registry's fleet gauges
(``credit-starvation``, ``peer-not-reading``, ``h2-flow-control``,
``ctrl-ring``, ``rendezvous``, ``batcher-wait``, ``poller-wake``,
``device-infer``, ...). A trip bumps ``watchdog_trips`` and
``watchdog_stalls{stage}``, emits ``WATCHDOG_TRIP``, flags the call's trace
for tail capture, and logs a flight replay.

Registration is a dict store and one monotonic stamp per RPC; completion
feeds a fixed-size rolling window per method (:meth:`rolling_p99_ns` is
what the admission gate and the load report read). The sweeper is one
daemon thread, started at the first ``call_started``, that sweeps every
``TPURPC_WATCHDOG_SWEEP_S`` (default 0.25 s); :meth:`StallWatchdog.stop`
ends it. ``TPURPC_WATCHDOG=0`` disables everything.

Left out: the stages diagnosed from the C core's evidence (the
reference's ``obs/native_obs.py`` and its ``native`` flight lane, ROADMAP
A7 (b); their names stay in :data:`STAGES`, append-only). A shard worker's
snapshot names its shard (:mod:`tpurpc_torch.obs.shard`).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _obs_profiler
from tpurpc_torch.utils.config import _env

__all__ = ["StallWatchdog", "get", "call_started", "call_finished",
           "STAGES"]

#: the sweeper thread parked between sweeps is infrastructure idle time,
#: not unattributed serving work
_LENS_STAGES = {"_loop": "idle", "sweep_once": "idle"}
_obs_profiler.register_stages(__file__, _LENS_STAGES)

_log = logging.getLogger("tpurpc_torch.watchdog")

STAGES = ("credit-starvation", "peer-not-reading", "h2-flow-control",
          "ctrl-ring", "rendezvous", "kv-swap", "migration", "decode-step",
          "batcher-wait", "poller-wake", "device-infer", "slo", "unknown",
          # stages the reference diagnoses from its C core's shm flight
          # ring + metrics table (append-only, like the event codes)
          "native-ctrl-frozen", "native-pin-wait", "native-rdv-fallback",
          "native-delivery")

# trip hooks: evidence capture registers here so every sweeper trip and
# every external trip can snapshot a postmortem. Hooks run on the tripping
# thread (never an RPC hot path) and must never raise outward.

_trip_hooks: List = []


def add_trip_hook(fn) -> None:
    """Register ``fn(diag_dict)`` to run once per NEW trip (sweeper or
    external). Duplicate registrations are ignored."""
    if fn not in _trip_hooks:
        _trip_hooks.append(fn)


def remove_trip_hook(fn) -> None:
    try:
        _trip_hooks.remove(fn)
    except ValueError:
        pass


def _run_trip_hooks(diag: dict) -> None:
    for fn in list(_trip_hooks):
        try:
            fn(diag)
        except Exception:
            _log.exception("watchdog trip hook failed")

#: anomaly counters (always-on registry): total trips + per-stage breakdown
_TRIPS = _metrics.counter("watchdog_trips")
_STALLS = _metrics.labeled_counter("watchdog_stalls", ("stage",))

_BEGIN_END = {
    _flight.WRITE_STALL_BEGIN: _flight.WRITE_STALL_END,
    _flight.CREDIT_STARVE_BEGIN: _flight.CREDIT_STARVE_END,
}


class _Roll:
    """Fixed-size rolling duration window per method; p99 cached 0.5 s."""

    __slots__ = ("buf", "n", "_p99", "_stamp")
    SIZE = 128

    def __init__(self):
        self.buf = [0] * self.SIZE
        self.n = 0
        self._p99 = None
        self._stamp = 0.0

    def record(self, dur_ns: int) -> None:
        self.buf[self.n % self.SIZE] = dur_ns
        self.n += 1

    def p99_ns(self) -> Optional[int]:
        if self.n < 8:
            return None  # too little history to call anything an outlier
        now = time.monotonic()
        if self._p99 is None or now - self._stamp > 0.5:
            window = sorted(self.buf[:min(self.n, self.SIZE)])
            self._p99 = window[max(0, int(len(window) * 0.99) - 1)]
            self._stamp = now
        return self._p99


class StallWatchdog:
    def __init__(self, sweep_s: Optional[float] = None,
                 mult: Optional[float] = None,
                 min_stall_s: Optional[float] = None):
        self.enabled = (_env("TPURPC_WATCHDOG") or "1").lower() not in (
            "0", "off", "false")
        self.sweep_s = sweep_s if sweep_s is not None else float(
            _env("TPURPC_WATCHDOG_SWEEP_S") or "0.25")
        self.mult = mult if mult is not None else float(
            _env("TPURPC_WATCHDOG_MULT") or "8")
        self.min_stall_s = min_stall_s if min_stall_s is not None else float(
            _env("TPURPC_WATCHDOG_MIN_S") or "1.0")
        #: token -> [method, t0_ns, trace_id, kind, tripped]
        self._inflight: Dict[int, list] = {}
        self._tokens = itertools.count(1)
        self._rolls: Dict[str, _Roll] = {}
        self._active: List[dict] = []
        self._history: deque = deque(maxlen=64)
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()

    # -- per-RPC face (hot-ish: one dict store / delete) ----------------------

    def call_started(self, method: str, trace_id: int = 0,
                     kind: str = "server") -> Optional[int]:
        if not self.enabled:
            return None
        tok = next(self._tokens)
        # [method, t0, trace_id, kind, tripped-stages] — the last slot
        # records which stages already paged for THIS call: a diagnosis
        # that sharpens re-trips under the sharper stage, each stage at
        # most once
        self._inflight[tok] = [method, time.monotonic_ns(), trace_id, kind,
                               set()]
        if self._thread is None:
            self._ensure_thread()
        return tok

    def call_finished(self, token: Optional[int],
                      error: bool = False) -> None:
        if token is None:
            return
        entry = self._inflight.pop(token, None)
        if entry is None or error:
            return  # failures don't tighten the p99 bar
        dur = time.monotonic_ns() - entry[1]
        method = entry[0]
        roll = self._rolls.get(method)
        if roll is None:
            if len(self._rolls) >= 256:
                return  # bounded method cardinality
            roll = self._rolls.setdefault(method, _Roll())
        roll.record(dur)

    def slow_threshold_ns(self, method: str) -> Optional[int]:
        """``mult × rolling-p99`` for tail capture's slow bar, or None
        without enough history."""
        roll = self._rolls.get(method)
        if roll is None:
            return None
        p99 = roll.p99_ns()
        return None if p99 is None else int(p99 * self.mult)

    def rolling_p99_ns(self) -> Optional[int]:
        """The WORST rolling p99 across methods with history, or None —
        the admission gate and the load report read this as the server's
        latency signal (one method in trouble is the fleet signal;
        averaging would hide it)."""
        worst = None
        for roll in list(self._rolls.values()):
            p99 = roll.p99_ns()
            if p99 is not None and (worst is None or p99 > worst):
                worst = p99
        return worst

    def method_p99s(self) -> Dict[str, int]:
        """Per-method rolling p99s (ns) for methods with enough history:
        unlike the cumulative ``srv_call_us`` histogram, a rolling window
        recovers after a degradation ends."""
        out: Dict[str, int] = {}
        for method, roll in list(self._rolls.items()):
            p99 = roll.p99_ns()
            if p99 is not None:
                out[method] = p99
        return out

    # -- the sweeper ----------------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._thread_lock:
            if self._thread is not None:
                return
            self._stop.clear()
            t = threading.Thread(target=self._loop, daemon=True,
                                 name="tpurpc-watchdog")
            self._thread = t
            t.start()

    def stop(self) -> None:
        """End the sweeper thread (the next ``call_started`` starts a new
        one). The reference's sweeper runs until the process exits; the
        port's tests and smoke stop what they start."""
        with self._thread_lock:
            t, self._thread = self._thread, None
            self._stop.set()
            self._wake.set()
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.sweep_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.sweep_once()
            except Exception:  # the watchdog must never take anything down
                _log.exception("watchdog sweep failed")

    def _stall_bar_ns(self, method: str) -> int:
        bar = int(self.min_stall_s * 1e9)
        p99m = self.slow_threshold_ns(method)
        if p99m is not None:
            bar = max(bar, p99m)  # never page on a method's normal tail
        return bar

    def sweep_once(self, now_ns: Optional[int] = None) -> List[dict]:
        """One sweep: rebuild the active diagnosis list; fire trip actions
        for newly detected stalls. Exposed for tests (deterministic
        sweeps) — the daemon loop calls it on the configured cadence."""
        now = now_ns if now_ns is not None else time.monotonic_ns()
        active: List[dict] = []
        to_trip: List[tuple] = []
        evidence = None
        for tok, entry in list(self._inflight.items()):
            method, t0, trace_id, kind, tripped_stages = entry
            age = now - t0
            if age < self._stall_bar_ns(method):
                continue
            if evidence is None:
                evidence = self._gather_evidence(now)
            stage, detail = self._attribute(evidence, kind, age)
            diag = {
                "method": method,
                "kind": kind,
                "stage": stage,
                "detail": detail,
                # the same diagnosis as a structured
                # object (stage + entity + evidence refs) — the prose
                # above stays byte-identical for the text face
                "cause": self._cause_struct(evidence, stage),
                "age_s": round(age / 1e9, 3),
                "trace_id": f"{trace_id:016x}" if trace_id else None,
                "since_ns": t0,
            }
            active.append(diag)
            if stage not in tripped_stages:
                tripped_stages.add(stage)
                to_trip.append((diag, trace_id, age))
        self._active = active
        if active:
            for d in active:
                done = {"t": time.time()}  # tpr: allow(wallclock)
                done.update(d)
                if not self._history or self._history[-1].get(
                        "since_ns") != d["since_ns"] or \
                        self._history[-1].get("stage") != d["stage"]:
                    self._history.append(done)
        # trips fire AFTER the snapshot state is updated: a trip hook
        # that reads
        # ``snapshot()`` must see the diagnosis that tripped it
        for diag, trace_id, age in to_trip:
            self._trip(diag, trace_id, age)
        return active

    def _trip(self, diag: dict, trace_id: int, age_ns: int) -> None:
        _TRIPS.inc()
        _STALLS.labels(diag["stage"]).inc()
        _flight.emit(_flight.WATCHDOG_TRIP,
                     _flight.tag_for(diag["method"]), age_ns // 1_000_000)
        if trace_id:
            # postmortem spans: promote the wedged call's provisional trace
            # NOW, while it is still in flight — /traces has the tree even
            # if the call never completes
            from tpurpc_torch.obs import tracing as _tracing

            _tracing.tail_flag(trace_id)
        _log.warning(
            "stall: %s %s in flight %.2fs — stage %s (%s)\n%s",
            diag["kind"], diag["method"], diag["age_s"], diag["stage"],
            diag["detail"],
            _flight.dump_text(
                since_ns=diag["since_ns"] - 1_000_000_000))
        _run_trip_hooks(diag)

    def external_trip(self, stage: str, method: str, detail: str) -> None:
        """A trip raised by another verification subsystem rather than the
        sweeper (the reference's live protocol verifier calls this when a
        declared flight machine sees an illegal transition). Counts like a
        sweeper trip
        (``watchdog_trips`` / ``watchdog_stalls{stage}``), lands in the
        history served at ``/debug/stalls``, and logs one flight replay —
        but registers no in-flight call (there is nothing to age out)."""
        if not self.enabled:
            return
        _TRIPS.inc()
        _STALLS.labels(stage).inc()
        diag = {
            "method": method,
            "kind": "external",
            "stage": stage,
            "detail": detail,
            # an external verifier supplies no flight-edge evidence
            "cause": {"stage": stage, "entity": None, "evidence": []},
            "age_s": 0.0,
            "trace_id": None,
            "since_ns": time.monotonic_ns(),
        }
        done = {"t": time.time()}  # tpr: allow(wallclock)
        done.update(diag)
        self._history.append(done)
        _log.warning(
            "external trip: %s — stage %s (%s)\n%s",
            method, stage, detail,
            _flight.dump_text(
                since_ns=time.monotonic_ns() - 2_000_000_000))
        _run_trip_hooks(diag)

    # -- stage attribution ----------------------------------------------------

    def _gather_evidence(self, now_ns: int) -> dict:
        """One pass over the flight tail + fleet gauges, shared by every
        diagnosis in a sweep."""
        events = _flight.snapshot(
            since_ns=now_ns - 60_000_000_000, limit=512)
        open_lease = 0
        open_edges: Dict[tuple, int] = {}  # (begin_code, tag) -> t_ns
        # unmatched rendezvous edges — an OFFER the peer
        # never claimed ((tag, 'o', req)) or a claimed region never
        # completed/released ((tag, 'l', lease)) — are the evidence a call
        # is wedged INSIDE a bulk-tensor handoff, not in the ring/h2 path
        open_rdv: Dict[tuple, int] = {}
        # an open (unmatched) ring-full stall edge — the
        # producer sees the peer's descriptor ring full and the consumer
        # is not draining it; paired with a nonzero ctrl_ring_backlog
        # gauge this outranks the generic rendezvous story (the wedge is
        # the CONTROL plane, not the transfer)
        open_ctrl: Dict[int, int] = {}
        # per-scheduler step bracket — an open
        # GEN_STEP_BEGIN (no matching END) is a decode step IN the model
        # right now; its age says whether that is traffic or a wedge. The
        # last END stamp catches the other failure shape: sequences
        # waiting while the loop has stopped stepping entirely.
        open_step: Dict[int, int] = {}
        # open swap/migration brackets — a KV_SWAP_BEGIN
        # or MIG_BEGIN with no matching END is a sequence mid-move; aged
        # past the stall floor it is the wedge, and it outranks the
        # generic decode-step story (more specific evidence wins)
        open_swap: Dict[tuple, int] = {}
        open_mig: Dict[tuple, int] = {}
        last_step_end = 0
        last_step_batch = 0
        last_h2 = 0
        for e in events:
            code = e["code"]
            if code == _flight.LEASE_RESERVE:
                open_lease += 1
            elif code in (_flight.LEASE_COMMIT, _flight.LEASE_ABORT):
                open_lease = max(0, open_lease - 1)
            elif code in _BEGIN_END:
                open_edges[(code, e["tag"])] = e["t_ns"]
            elif code in _BEGIN_END.values():
                for b, en in _BEGIN_END.items():
                    if en == code:
                        open_edges.pop((b, e["tag"]), None)
            elif code == _flight.H2_WINDOW_EXHAUSTED:
                last_h2 = e["t_ns"]
            elif code == _flight.CTRL_STALL_BEGIN:
                open_ctrl[e["tag"]] = e["t_ns"]
            elif code == _flight.CTRL_STALL_END:
                open_ctrl.pop(e["tag"], None)
            elif code == _flight.RDV_OFFER:
                open_rdv[(e["tag"], "o", e["a1"])] = e["t_ns"]
            elif code == _flight.RDV_CLAIM:
                open_rdv.pop((e["tag"], "o", e["a1"]), None)
                open_rdv[(e["tag"], "l", e["a2"])] = e["t_ns"]
            elif code == _flight.RDV_COMPLETE:
                open_rdv.pop((e["tag"], "l", e["a1"]), None)
            elif code == _flight.RDV_RELEASE:
                open_rdv.pop((e["tag"], "l", e["a1"]), None)
                open_rdv.pop((e["tag"], "o", e["a2"]), None)
            elif code == _flight.GEN_STEP_BEGIN:
                open_step[e["tag"]] = e["t_ns"]
                last_step_batch = e["a1"]
            elif code == _flight.GEN_STEP_END:
                open_step.pop(e["tag"], None)
                last_step_end = e["t_ns"]
            elif code == _flight.KV_SWAP_BEGIN:
                open_swap[(e["tag"], e["a1"])] = e["t_ns"]
            elif code == _flight.KV_SWAP_END:
                open_swap.pop((e["tag"], e["a1"]), None)
            elif code == _flight.MIG_BEGIN:
                open_mig[(e["tag"], e["a1"])] = e["t_ns"]
            elif code == _flight.MIG_END:
                open_mig.pop((e["tag"], e["a1"]), None)

        def fleet_sum(name: str) -> float:
            m = _metrics.registry().metrics().get(name)
            if m is None or not isinstance(m, _metrics.FleetGauge):
                return 0.0
            return m.collect()[0]

        return {
            "now_ns": now_ns,
            "open_lease": open_lease,
            "open_edges": open_edges,
            "open_rdv": open_rdv,
            "open_ctrl": open_ctrl,
            "ctrl_ring_backlog": fleet_sum("ctrl_ring_backlog"),
            "open_swap": open_swap,
            "open_mig": open_mig,
            "open_step": open_step,
            "last_step_end_ns": last_step_end,
            "last_step_batch": last_step_batch,
            "last_h2_ns": last_h2,
            "pairs_write_stalled": fleet_sum("pairs_write_stalled"),
            "batcher_queue_depth": fleet_sum("batcher_queue_depth"),
            "pairs_msg_waiting": fleet_sum("pairs_msg_waiting"),
            "decode_waiting": fleet_sum("decode_waiting"),
            "decode_running": fleet_sum("decode_running"),
        }

    def _attribute(self, ev: dict, kind: str, age_ns: int) -> tuple:
        now = ev["now_ns"]
        starve_age = 0
        for (code, tag), t in ev["open_edges"].items():
            starve_age = max(starve_age, now - t)
        if ev["open_lease"] > 0:
            return ("credit-starvation",
                    "send-lease held: reserve without commit/abort in the "
                    "flight tail — the ring write lock is wedged")
        # a stuck descriptor ring is MORE specific than the
        # rendezvous story it wedges — the control op (offer/claim/
        # complete) is sitting in a ring nobody drains.  Evidence: an aged
        # open ring-full stall bracket, or posted-but-unconsumed records
        # (the backlog gauge) behind an aged rendezvous edge.
        open_ctrl = ev.get("open_ctrl") or {}
        backlog = ev.get("ctrl_ring_backlog", 0)
        open_rdv = ev.get("open_rdv") or {}
        ctrl_age = 0
        if open_ctrl:
            ctrl_age = max(now - t for t in open_ctrl.values())
        elif backlog > 0 and open_rdv:
            ctrl_age = max(now - t for t in open_rdv.values())
        if ctrl_age >= self.min_stall_s * 1e9 / 2:
            return ("ctrl-ring",
                    f"descriptor-ring control plane stalled "
                    f"{ctrl_age / 1e9:.2f}s: {int(backlog)} posted "
                    f"record(s) undrained"
                    + (f", {len(open_ctrl)} link(s) ring-full"
                       if open_ctrl else "")
                    + " — the peer's ring consumer stopped draining")
        if open_rdv:
            oldest = max(now - t for t in open_rdv.values())
            # a fresh edge is a transfer IN PROGRESS (claim round trips are
            # µs-scale); only an edge aged past half the stall floor is
            # evidence of a wedge rather than of traffic
            if oldest >= self.min_stall_s * 1e9 / 2:
                offers = sum(1 for k in open_rdv if k[1] == "o")
                claims = len(open_rdv) - offers
                return ("rendezvous",
                        f"bulk-tensor rendezvous wedged {oldest / 1e9:.2f}s:"
                        f" {offers} offer(s) unanswered, {claims} claimed "
                        "region(s) without complete/release in the flight "
                        "tail")
        # an aged open swap/migration bracket is MORE
        # specific than the decode-step story — the loop (or a migration
        # thread) is inside a KV move, and every stream behind the
        # boundary waits on it
        open_swap = ev.get("open_swap") or {}
        if open_swap:
            oldest = max(now - t for t in open_swap.values())
            if oldest >= self.min_stall_s * 1e9 / 2:
                return ("kv-swap",
                        f"KV swap wedged {oldest / 1e9:.2f}s: a "
                        f"swap begin without its end in the flight tail "
                        f"({len(open_swap)} open) — the host copy or "
                        "arena re-admission is stuck")
        open_mig = ev.get("open_mig") or {}
        if open_mig:
            oldest = max(now - t for t in open_mig.values())
            if oldest >= self.min_stall_s * 1e9 / 2:
                return ("migration",
                        f"live migration wedged {oldest / 1e9:.2f}s: "
                        f"{len(open_mig)} sequence(s) detached with no "
                        "migration-end — the peer handoff "
                        "(offer/ship/complete) is stuck")
        open_step = ev.get("open_step") or {}
        if open_step:
            oldest = max(now - t for t in open_step.values())
            # a fresh step edge is a decode step in flight (ms-scale);
            # only one aged past half the stall floor is a wedge — the
            # model call itself is the long pole, and every stream in the
            # batch is stalled behind it
            if oldest >= self.min_stall_s * 1e9 / 2:
                return ("decode-step",
                        f"decode step wedged {oldest / 1e9:.2f}s in the "
                        f"model (batch of {int(ev.get('last_step_batch', 0))}"
                        "): every running stream waits on this step")
        if (ev.get("decode_waiting", 0) > 0
                and not open_step
                and (not ev.get("last_step_end_ns")
                     or now - ev["last_step_end_ns"]
                     >= self.min_stall_s * 1e9)):
            return ("decode-step",
                    f"{int(ev['decode_waiting'])} sequence(s) waiting but "
                    "the decode loop has not completed a step inside the "
                    "stall window — the scheduler thread is wedged or "
                    "starved")
        if starve_age or ev["pairs_write_stalled"] > 0:
            if starve_age > 2 * age_ns or (
                    starve_age > 3 * self.min_stall_s * 1e9):
                return ("peer-not-reading",
                        "write stall/credit starvation persisted "
                        f"{starve_age / 1e9:.2f}s: the peer is connected "
                        "but not draining its receive ring")
            return ("credit-starvation",
                    "ring writer out of credits "
                    f"({int(ev['pairs_write_stalled'])} pair(s) "
                    "write-stalled)")
        if ev["last_h2_ns"] and now - ev["last_h2_ns"] < age_ns + int(1e9):
            # an exhaustion event within the stalled call's lifetime
            # (plus a second of slack for sweep-phase skew)
            return ("h2-flow-control",
                    "h2 send window exhausted: the peer stopped granting "
                    "WINDOW_UPDATE credit")
        if ev["batcher_queue_depth"] > 0:
            return ("batcher-wait",
                    f"{int(ev['batcher_queue_depth'])} request(s) parked "
                    "in the fan-in batcher queue")
        if ev["pairs_msg_waiting"] > 0:
            return ("poller-wake",
                    "a complete message is sitting undrained in a pair's "
                    "receive ring — wake latency or a lost kick")
        if kind == "server":
            return ("device-infer",
                    "transport quiet, handler still executing: the "
                    "model/device call is the long pole")
        return ("device-infer",
                "no local transport anomaly: the call is in flight at the "
                "peer (its handler/device is the long pole)")

    def _cause_struct(self, ev: dict, stage: str) -> dict:
        """the machine-readable twin of ``_attribute`` —
        the stage, the entity (connection/link) the oldest witness names,
        and ``[plane, ref, value]`` evidence rows citing the exact flight
        edges / gauges the prose describes. ``diagnose.py`` consumes this
        directly; the prose face stays untouched. ``device-infer`` (and
        external trips) legitimately carry no local evidence."""
        now = ev["now_ns"]
        evidence: List[list] = []
        entity: Optional[str] = None

        def add_table(table, slug, tag_index=None):
            nonlocal entity
            for key, t in sorted(table.items(), key=lambda kv: kv[1])[:4]:
                tag = key[tag_index] if tag_index is not None else key
                name = _flight.tag_name(tag)
                if entity is None:
                    entity = name
                evidence.append(
                    ["flight", f"{slug}:{name}@{t}",
                     round((now - t) / 1e9, 3)])

        def add_gauge(name):
            v = ev.get(name, 0)
            if v:
                evidence.append(["metrics", name, v])

        if stage == "credit-starvation":
            if ev.get("open_lease"):
                evidence.append(
                    ["flight", "lease-reserve-open", ev["open_lease"]])
            add_table(ev.get("open_edges") or {}, "stall-edge", 1)
            add_gauge("pairs_write_stalled")
        elif stage == "peer-not-reading":
            add_table(ev.get("open_edges") or {}, "stall-edge", 1)
            add_gauge("pairs_write_stalled")
        elif stage == "ctrl-ring":
            add_table(ev.get("open_ctrl") or {}, "ctrl-ring-full")
            add_gauge("ctrl_ring_backlog")
            if not ev.get("open_ctrl"):
                add_table(ev.get("open_rdv") or {}, "rdv-open", 0)
        elif stage == "rendezvous":
            add_table(ev.get("open_rdv") or {}, "rdv-open", 0)
        elif stage == "kv-swap":
            add_table(ev.get("open_swap") or {}, "kv-swap-open", 0)
        elif stage == "migration":
            add_table(ev.get("open_mig") or {}, "mig-open", 0)
        elif stage == "decode-step":
            add_table(ev.get("open_step") or {}, "step-open")
            add_gauge("decode_waiting")
            if ev.get("last_step_end_ns"):
                evidence.append(
                    ["flight", f"last-step-end@{ev['last_step_end_ns']}",
                     round((now - ev["last_step_end_ns"]) / 1e9, 3)])
        elif stage == "h2-flow-control":
            if ev.get("last_h2_ns"):
                evidence.append(
                    ["flight", f"h2-exhausted@{ev['last_h2_ns']}",
                     round((now - ev["last_h2_ns"]) / 1e9, 3)])
        elif stage == "batcher-wait":
            add_gauge("batcher_queue_depth")
        elif stage == "poller-wake":
            add_gauge("pairs_msg_waiting")
        return {"stage": stage, "entity": entity, "evidence": evidence}

    # -- export ---------------------------------------------------------------

    def active(self) -> List[dict]:
        return list(self._active)

    def snapshot(self) -> dict:
        out = {
            "active": list(self._active),
            "history": list(self._history),
            "inflight": len(self._inflight),
            "sweep_s": self.sweep_s,
            "mult": self.mult,
            "min_stall_s": self.min_stall_s,
            "enabled": self.enabled,
        }
        # a shard worker's registry names its shard, so the aggregated
        # /debug/stalls view attributes each diagnosis
        from tpurpc_torch.obs import shard as _shard

        if _shard.shard_id() >= 0:
            out["shard"] = _shard.shard_id()
        return out

    def reset(self) -> None:
        """Test isolation: forget in-flight calls and diagnoses (the
        sweeper thread, if started, keeps running harmlessly)."""
        self._inflight.clear()
        self._rolls.clear()
        self._active = []
        self._history.clear()


_instance: Optional[StallWatchdog] = None
_instance_lock = threading.Lock()


def get() -> StallWatchdog:
    global _instance
    if _instance is None:
        with _instance_lock:
            if _instance is None:
                _instance = StallWatchdog()
    return _instance


def call_started(method: str, trace_id: int = 0,
                 kind: str = "server") -> Optional[int]:
    return get().call_started(method, trace_id, kind)


def call_finished(token: Optional[int], error: bool = False) -> None:
    if token is not None:
        get().call_finished(token, error=error)
