"""Flight recorder: an always-on binary ring of transport events.

A copy of ``tpurpc/obs/flight.py``: the same event codes, record layout
and names, so both packages' rings read alike. Rare-event failures
(credit starvation, wake-latency stalls, a drain racing a call) are what
sampled telemetry misses; the recorder keeps the last ``capacity`` state
transitions (``TPURPC_FLIGHT_BUFFER``, default 4096) for a postmortem.

* **Events are edges, not traffic.** Only state transitions emit (a
  connection dying, a hedge firing, a drain starting).
* **Preallocated encoder.** ``emit`` is one ``struct.pack_into`` of five
  ints into a preallocated ``bytearray`` ring: no dicts, no strings.
* **Lock-free.** Slot allocation is ``next()`` on an ``itertools.count``;
  a reader racing a wrap may see one torn record, which the decoder skips.

Record layout (32 bytes, little-endian)::

    <Q t_ns> <H code> <H tag> <I tid> <q a1> <q a2>

``tag`` is an interned small int naming the entity (connection, method,
the ``hedge`` tag); intern once via :func:`tag_for`. Dump on ``SIGUSR2``
(stderr), at exit (``TPURPC_FLIGHT_DUMP=<dir>``) or when the stall
watchdog trips.

A shard worker's decoded records carry its shard id
(:mod:`tpurpc_torch.obs.shard`). Left out: the merge of the C core's shm
ring (``obs/native_obs.py``, ROADMAP A7 (b)) and the live protocol
verifier behind
``TPURPC_VERIFY_PROTOCOL`` (``analysis/protocol.py``, ROADMAP A12).
"""

from __future__ import annotations

import itertools
import struct
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "RECORDER", "FlightRecorder", "emit", "tag_for", "tag_name",
    "snapshot", "dump_text", "install_sigusr2", "EVENT_NAMES",
]

# -- event codes --------------------------------------------------------------
# Stable small ints: they land in the binary ring and in dumps; append-only.

PAIR_CONNECT = 1          # a1 = peer ring size
PAIR_DISCONNECT = 2       # graceful close
WRITE_STALL_BEGIN = 3     # pair sender stalled (want_write edge up)
WRITE_STALL_END = 4       # stall resolved (want_write edge down)
CREDIT_STARVE_BEGIN = 5   # ring writer out of credits; a1 = in-flight bytes
CREDIT_STARVE_END = 6
LEASE_RESERVE = 7         # a1 = reserved bytes
LEASE_COMMIT = 8
LEASE_ABORT = 9
POLLER_BP = 10            # hybrid waiter (re)adopted the busy-poll window
POLLER_EV = 11            # hybrid waiter parked on fds (EWMA below floor)
H2_WINDOW_EXHAUSTED = 12  # a1 = stream id
BATCH_FLUSH = 13          # a1 = flush reason code, a2 = batch size
DEADLINE_EXPIRED = 14     # a1 = configured timeout (us)
PEER_DEATH = 15           # pair/connection died unexpectedly
RECONNECT = 16            # subchannel re-dialed after a death
CONN_CONNECT = 17         # client transport connection established
CONN_DEAD = 18            # client transport connection died; a1 = 1 if graceful
CALL_FIRST_OK = 19        # first OK call on a connection (reconnect proof)
WATCHDOG_TRIP = 20        # a1 = stalled-call age (ms)
# hedging / drain / admission / subchannel health
HEDGE_FIRED = 21          # a1 = attempt index (1 = first hedge)
HEDGE_WON = 22            # a1 = winning attempt index (0 = original)
HEDGE_CANCELLED = 23      # a1 = cancelled attempt index
DRAIN_BEGIN = 24          # a1 = connections at drain start
DRAIN_END = 25            # a1 = streams still open at budget expiry (0=clean)
ADMIT_REJECT = 26         # a1 = inflight at rejection, a2 = pushback (ms)
SUBCH_EJECT = 27          # a1 = subchannel index, a2 = reason (0=errors,1=slow)
SUBCH_REINSTATE = 28      # a1 = subchannel index
# shard lifecycle + connection handoff
SHARD_START = 29          # worker up; a1 = shard id, a2 = n_shards
SHARD_EXIT = 30           # worker exited gracefully; a1 = shard id
SHARD_DEATH = 31          # supervisor saw a worker die; a1 = shard id, a2 = wait status
CONN_HANDOFF = 32         # supervisor passed an accepted fd; a1 = shard id
# one-sided rendezvous bulk-tensor transfers.
# Edges pair per link tag: OFFER(a1=req) closed by CLAIM(a1=req) or
# RELEASE(a2=req); CLAIM opens a lease edge (a2=lease) closed by
# COMPLETE(a1=lease) or RELEASE(a1=lease) — the watchdog's rendezvous-stage
# evidence is an unmatched edge in this algebra.
RDV_OFFER = 33            # a1 = request id, a2 = payload bytes
RDV_CLAIM = 34            # a1 = request id (0 = cached grant), a2 = lease id
RDV_WRITE = 35            # one-sided payload write done; a1 = lease id, a2 = bytes
RDV_COMPLETE = 36         # a1 = lease id, a2 = bytes
RDV_RELEASE = 37          # lease/offer abandoned; a1 = lease id (0 = none), a2 = request id
# continuous-batching decode scheduler. One
# STEP pair per DEVICE STEP (amortized over every running stream, like
# BATCH_FLUSH) brackets the membership events: a JOIN/LEAVE/RETIRE names
# the sequence that entered/left between two steps — the acceptance
# evidence that batching is continuous. An open STEP edge is the
# watchdog's `decode-step` stage evidence.
GEN_STEP_BEGIN = 38       # a1 = running batch size, a2 = waiting depth
GEN_STEP_END = 39         # a1 = running batch size, a2 = tokens emitted
GEN_JOIN = 40             # a1 = sequence id, a2 = prompt tokens (0 = resume)
GEN_LEAVE = 41            # client left mid-stream; a1 = seq id, a2 = emitted
GEN_RETIRE = 42           # natural finish; a1 = seq id, a2 = tokens emitted
GEN_SHED = 43             # a1 = slo class (0=interactive,1=batch), a2 = pushback ms
GEN_PREEMPT = 44          # a1 = seq id, a2 = slo class of the preempted seq
# the paged KV-cache plane + disaggregated
# prefill/decode. Alloc/free/prefix-hit are sequence-lifetime edges;
# KV_SWAP_BEGIN/END bracket one swap (a2: 0 = out-to-host, 1 = in-from-
# host) and MIG_BEGIN/MIG_END bracket one live migration — an open
# bracket aged past the stall floor is the watchdog's `kv-swap` /
# `migration` stage evidence. KV_SHIP_* are the block-granular handoff's
# control edges (OFFER-KV answered by a grant, COMPLETE after the
# one-sided block writes); KV_QUARANTINE records blocks pulled from
# circulation on a death path (never an alloc/free pair — quarantined
# blocks do not come back).
KV_ALLOC = 45             # a1 = owner/seq key, a2 = blocks allocated
KV_FREE = 46              # a1 = owner/seq key (0 = raw), a2 = blocks freed
KV_SWAP_BEGIN = 47        # a1 = seq key, a2 = direction (0=out, 1=in)
KV_SWAP_END = 48          # a1 = seq key, a2 = direction
KV_PREFIX_HIT = 49        # a1 = seq key, a2 = entries reused (prefill skipped)
KV_SHIP_OFFER = 50        # a1 = handoff id, a2 = payload bytes offered
KV_SHIP_COMPLETE = 51     # a1 = handoff id, a2 = payload bytes landed
KV_QUARANTINE = 52        # a1 = handoff/seq key (0 = link), a2 = blocks
MIG_BEGIN = 53            # a1 = seq id, a2 = entries to move
MIG_END = 54              # a1 = seq id, a2 = 1 ok / 0 failed
# the live protocol verifier's breadcrumb — a
# declared flight-event state machine (analysis/protocol.py) saw an
# illegal transition. a1 = machine index, a2 = the offending event code.
PROTO_VIOLATION = 55
# shared-memory descriptor rings for the
# rendezvous control plane. ADOPT fires once per link when the peer's ring
# descriptor verifies; SPIN/PARK are the consumer's hot↔cold flips (the
# POLLER_BP/EV discipline applied to ring polling); STALL_BEGIN/END
# bracket the producer's ring-full condition — an aged open stall edge is
# the watchdog's `ctrl-ring` evidence that the consumer stopped draining.
CTRL_ADOPT = 56           # a1 = ring slots, a2 = slot bytes
CTRL_SPIN = 57            # consumer hot-polling the ring; a1 = consumed so far
CTRL_PARK = 58            # consumer parked on the framed path; a1 = consumed
CTRL_STALL_BEGIN = 59     # producer saw the ring full; a1 = backlog
CTRL_STALL_END = 60       # space returned (consumer drained)
# SLO burn-rate alerting + automatic evidence
# capture. FIRING/RESOLVED bracket one alert episode per (objective tag,
# track) — the slo protocol machine forbids a double-fire or an orphan
# resolve. BUNDLE_WRITTEN records one postmortem bundle landing on disk
# (a1 = trigger code: 0 slo / 1 watchdog / 2 manual, a2 = bundle ordinal).
SLO_FIRING = 61           # a1 = track (0=errors,1=sheds,2=latency), a2 = burn x100
SLO_RESOLVED = 62         # a1 = track, a2 = burn x100 at resolve
BUNDLE_WRITTEN = 63       # a1 = trigger code, a2 = bundle ordinal
# sequence identity as a first-class flight
# key — the `seq-journey` protocol machine (analysis/protocol.py) runs
# over these plus the GEN_JOIN/LEAVE/RETIRE/PREEMPT and MIG_*
# events, keyed (scheduler tag, seq id). SUBMIT opens the journey (before
# any JOIN can fire — emitted under the admission lock), FIRST_TOKEN is
# the one per-sequence token edge (TTFT; events are edges, not traffic —
# per-token emission stays banned), DETACH is the migration sender's
# hand-out (the journey continues on the peer under the same trace).
SEQ_SUBMIT = 64           # a1 = seq id, a2 = prompt tokens
SEQ_FIRST_TOKEN = 65      # a1 = seq id, a2 = TTFT (us)
SEQ_DETACH = 66           # a1 = seq id, a2 = KV entries handed out
# the connection-scale plane. PARK/UNPARK bracket
# one parked episode per pair (the `park` protocol machine forbids a
# double-park or an unpark with no preceding park); ACCEPT_SHED is the
# listener's pre-handshake pushback under a reconnect storm.
PAIR_PARK = 67            # a1 = ring bytes returned to the pool
PAIR_UNPARK = 68          # a1 = ring bytes re-leased, a2 = 1 if remote wake
ACCEPT_SHED = 69          # a1 = inflight handshakes, a2 = pushback (ms)
# native-only edges. The C plane (native/src/
# tpr_obs.cc) REUSES the shared codes above for every edge the Python
# plane also records (RDV_*, CTRL_*, CONN_*) so the protocol machines
# replay it unmodified; these five are edges only the C core can see.
# They arrive through the merged module-level snapshot() with lane
# "native" — the Python recorder never emits them.
NATIVE_PIN_WAIT_BEGIN = 70   # link close() waiting on window pins; a1 = pins
NATIVE_PIN_WAIT_END = 71     # a1 = ns waited
NATIVE_DLV_STALL_BEGIN = 72  # delivery-shard backlog over high water; a1 = depth
NATIVE_DLV_STALL_END = 73    # backlog drained below low water; a1 = depth
NATIVE_RDV_FALLBACK = 74     # eligible send fell back framed; a1 = bytes,
                             # a2 = reason (0 no claim, 1 write failed)

EVENT_NAMES: Dict[int, str] = {
    PAIR_CONNECT: "pair-connect",
    PAIR_DISCONNECT: "pair-disconnect",
    WRITE_STALL_BEGIN: "write-stall-begin",
    WRITE_STALL_END: "write-stall-end",
    CREDIT_STARVE_BEGIN: "credit-starve-begin",
    CREDIT_STARVE_END: "credit-starve-end",
    LEASE_RESERVE: "lease-reserve",
    LEASE_COMMIT: "lease-commit",
    LEASE_ABORT: "lease-abort",
    POLLER_BP: "poller-mode-bp",
    POLLER_EV: "poller-mode-ev",
    H2_WINDOW_EXHAUSTED: "h2-window-exhausted",
    BATCH_FLUSH: "batch-flush",
    DEADLINE_EXPIRED: "deadline-expired",
    PEER_DEATH: "peer-death",
    RECONNECT: "reconnect",
    CONN_CONNECT: "conn-connect",
    CONN_DEAD: "conn-dead",
    CALL_FIRST_OK: "call-first-ok",
    WATCHDOG_TRIP: "watchdog-trip",
    HEDGE_FIRED: "hedge-fired",
    HEDGE_WON: "hedge-won",
    HEDGE_CANCELLED: "hedge-cancelled",
    DRAIN_BEGIN: "drain-begin",
    DRAIN_END: "drain-end",
    ADMIT_REJECT: "admit-reject",
    SUBCH_EJECT: "subch-ejected",
    SUBCH_REINSTATE: "subch-reinstated",
    SHARD_START: "shard-start",
    SHARD_EXIT: "shard-exit",
    SHARD_DEATH: "shard-death",
    CONN_HANDOFF: "conn-handoff",
    RDV_OFFER: "rdv-offer",
    RDV_CLAIM: "rdv-claim",
    RDV_WRITE: "rdv-write",
    RDV_COMPLETE: "rdv-complete",
    RDV_RELEASE: "rdv-release",
    GEN_STEP_BEGIN: "gen-step-begin",
    GEN_STEP_END: "gen-step-end",
    GEN_JOIN: "gen-join",
    GEN_LEAVE: "gen-leave",
    GEN_RETIRE: "gen-retire",
    GEN_SHED: "gen-shed",
    GEN_PREEMPT: "gen-preempt",
    KV_ALLOC: "kv-alloc",
    KV_FREE: "kv-free",
    KV_SWAP_BEGIN: "kv-swap-begin",
    KV_SWAP_END: "kv-swap-end",
    KV_PREFIX_HIT: "kv-prefix-hit",
    KV_SHIP_OFFER: "kv-ship-offer",
    KV_SHIP_COMPLETE: "kv-ship-complete",
    KV_QUARANTINE: "kv-quarantine",
    MIG_BEGIN: "migration-begin",
    MIG_END: "migration-end",
    PROTO_VIOLATION: "proto-violation",
    CTRL_ADOPT: "ctrl-adopt",
    CTRL_SPIN: "ctrl-spin",
    CTRL_PARK: "ctrl-park",
    CTRL_STALL_BEGIN: "ctrl-stall-begin",
    CTRL_STALL_END: "ctrl-stall-end",
    SLO_FIRING: "slo-firing",
    SLO_RESOLVED: "slo-resolved",
    BUNDLE_WRITTEN: "bundle-written",
    SEQ_SUBMIT: "seq-submit",
    SEQ_FIRST_TOKEN: "seq-first-token",
    SEQ_DETACH: "seq-detach",
    PAIR_PARK: "pair-park",
    PAIR_UNPARK: "pair-unpark",
    ACCEPT_SHED: "accept-shed",
    NATIVE_PIN_WAIT_BEGIN: "native-pin-wait-begin",
    NATIVE_PIN_WAIT_END: "native-pin-wait-end",
    NATIVE_DLV_STALL_BEGIN: "native-dlv-stall-begin",
    NATIVE_DLV_STALL_END: "native-dlv-stall-end",
    NATIVE_RDV_FALLBACK: "native-rdv-fallback",
}

#: batch-flush reason codes (a1 of BATCH_FLUSH) — mirrors the jaxshim
#: flush-reason counters so one event names both the decision and the size
FLUSH_REASONS = ("size", "timer", "drained", "close")
FLUSH_REASON_CODE = {name: i for i, name in enumerate(FLUSH_REASONS)}

_REC = struct.Struct("<QHHIqq")
RECORD_BYTES = _REC.size  # 32
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _default_capacity() -> int:
    from tpurpc_torch.utils.config import _env

    raw = _env("TPURPC_FLIGHT_BUFFER") or ""
    try:
        return max(64, int(raw)) if raw else 4096
    except ValueError:
        return 4096


# -- tag interning ------------------------------------------------------------

_tag_lock = threading.Lock()
_tags: Dict[str, int] = {}
_tag_names: List[str] = ["-"]  # tag 0 = anonymous


def tag_for(name: str) -> int:
    """Intern ``name`` to a small int, once per entity lifetime (connect
    time) — the hot emit path then carries only ints. Bounded at 2^16-1
    tags; overflow degrades to the anonymous tag 0, never an error."""
    t = _tags.get(name)
    if t is not None:
        return t
    with _tag_lock:
        t = _tags.get(name)
        if t is None:
            if len(_tag_names) >= 0xFFFF:
                return 0
            t = len(_tag_names)
            _tag_names.append(name)
            _tags[name] = t
        return t


def tag_name(tag: int) -> str:
    try:
        return _tag_names[tag]
    except IndexError:
        return f"#{tag}"


# -- live verification tap ------------------------------------------------------
#
# A verifier installed here sees every recorded event AFTER the pack. Cost
# when unset: one global load + None check per event. (The reference's
# TPURPC_VERIFY_PROTOCOL=1 installs its protocol checker here; the port
# has none until ROADMAP A12.)

_verify = None


def set_verify_hook(hook) -> None:
    """Install (or clear, with ``None``) the per-event verification tap:
    ``hook(code, tag, a1, a2)`` is called for every recorded event."""
    global _verify
    _verify = hook


def verify_hook():
    return _verify


# -- the recorder -------------------------------------------------------------

class FlightRecorder:
    """Fixed-size binary event ring. See the module docstring for the cost
    argument; the public face is :meth:`emit` (hot) and :meth:`snapshot`
    (cold — decodes, validates, time-orders)."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity or _default_capacity()
        self._buf = bytearray(self.capacity * RECORD_BYTES)
        self._slots = itertools.count()
        self.enabled = True

    # -- hot path ------------------------------------------------------------

    def emit(self, code: int, tag: int = 0, a1: int = 0, a2: int = 0) -> None:
        """Record one event: one pack_into, zero allocation beyond the slot
        int. Never raises — a recorder failure must not take down the
        transport it is recording."""
        if not self.enabled:
            return
        try:
            _REC.pack_into(
                self._buf, (next(self._slots) % self.capacity) * RECORD_BYTES,
                time.monotonic_ns(), code, tag,
                threading.get_ident() & 0xFFFFFFFF,
                min(max(int(a1), _I64_MIN), _I64_MAX),
                min(max(int(a2), _I64_MIN), _I64_MAX))
        except (struct.error, ValueError):
            pass
        if _verify is not None:
            try:
                _verify(code, tag, a1, a2)
            except Exception:
                pass  # verification must never break the recorder contract

    # -- cold paths ----------------------------------------------------------

    def snapshot(self, since_ns: int = 0,
                 limit: Optional[int] = None) -> List[dict]:
        """Decode the ring into time-ordered event dicts (oldest first).

        Slot order is not arrival order after a wrap, so ordering comes from
        the monotonic stamps; zeroed slots and torn/unknown records (a
        reader racing a wrap) are skipped — defensive by design."""
        out: List[dict] = []
        # a worker's events carry its shard id, so merged replays
        # (obs.shard.aggregate_flight) attribute every edge
        from tpurpc_torch.obs import shard as _shard

        sid = _shard.shard_id()
        buf = bytes(self._buf)  # one copy: decode from a stable image
        for off in range(0, len(buf), RECORD_BYTES):
            t_ns, code, tag, tid, a1, a2 = _REC.unpack_from(buf, off)
            if t_ns == 0 or code not in EVENT_NAMES or t_ns < since_ns:
                continue
            rec = {"t_ns": t_ns, "code": code,
                   "event": EVENT_NAMES[code], "tag": tag,
                   "entity": tag_name(tag), "tid": tid,
                   "a1": a1, "a2": a2}
            if sid >= 0:
                rec["shard"] = sid
            out.append(rec)
        out.sort(key=lambda d: d["t_ns"])
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def dump_text(self, since_ns: int = 0) -> str:
        """Human-readable replay (the SIGUSR2 / watchdog-trip rendering)."""
        events = self.snapshot(since_ns=since_ns)
        if not events:
            return "flight recorder: no events\n"
        t0 = events[0]["t_ns"]
        lines = [f"flight recorder: {len(events)} events "
                 f"(capacity {self.capacity})"]
        for e in events:
            lines.append(
                f"  +{(e['t_ns'] - t0) / 1e6:10.3f}ms "
                f"{e['event']:<22} {e['entity']:<20} "
                f"a1={e['a1']} a2={e['a2']} tid={e['tid']:#x}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every slot (test isolation). Not synchronized against
        concurrent emitters — callers quiesce first."""
        for i in range(len(self._buf)):
            self._buf[i] = 0


#: the process-wide recorder; hot modules cache ``flight.emit`` (below)
RECORDER = FlightRecorder()

#: module-level emit — the one name instrumented sites call
#: (``_flight.emit(CODE, tag, a1, a2)``)
emit = RECORDER.emit


def snapshot(since_ns: int = 0, limit: Optional[int] = None) -> List[dict]:
    """The process's flight view, oldest first (the reference merges its
    C core's shm ring in here; the port has no C core yet)."""
    return RECORDER.snapshot(since_ns=since_ns, limit=limit)


def dump_text(since_ns: int = 0) -> str:
    """Human-readable replay of :func:`snapshot` (the SIGUSR2 and
    watchdog-trip rendering)."""
    return RECORDER.dump_text(since_ns=since_ns)


# -- SIGUSR2 dump -------------------------------------------------------------

_sig_installed = False


def install_sigusr2() -> bool:
    """Dump the flight ring to stderr on SIGUSR2 (``kill -USR2 <pid>``).

    Best-effort: signal handlers only install from the main thread, and not
    every platform has SIGUSR2 — failure leaves the recorder fully usable
    via ``/debug/flight``. The previous handler is chained."""
    global _sig_installed
    if _sig_installed:
        return True
    import signal
    import sys

    if not hasattr(signal, "SIGUSR2"):
        return False
    try:
        prev = signal.getsignal(signal.SIGUSR2)

        def _dump(signum, frame):
            try:
                sys.stderr.write(RECORDER.dump_text())
                sys.stderr.flush()
            except Exception:
                pass
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)

        signal.signal(signal.SIGUSR2, _dump)
    except (ValueError, OSError):  # non-main thread / exotic platform
        return False
    _sig_installed = True
    return True


install_sigusr2()


# -- at-exit dump ---------------------------------------------------------------
#
# TPURPC_FLIGHT_DUMP=<dir> makes every process write its flight ring as
# <dir>/flight-<pid>.json at interpreter exit (the reference replays such
# dumps through its protocol checker, ROADMAP A12).

def _install_exit_dump() -> None:
    import atexit
    import json
    import os

    from tpurpc_torch.utils.config import _env

    target = _env("TPURPC_FLIGHT_DUMP") or ""
    if not target:
        return

    def _dump_at_exit():
        try:
            # the clock anchor (pid + bracketed mono/wall pair) lets an
            # offline reader rebase several per-process dumps of one run
            # onto the shared wall clock
            from tpurpc_torch.obs import tracing as _tracing

            doc = {"events": snapshot(),
                   "clock_anchor": _tracing.clock_anchor()}
            os.makedirs(target, exist_ok=True)
            path = os.path.join(target, f"flight-{os.getpid()}.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f)
        except Exception:
            pass  # a failed postmortem dump must not fail the exit

    atexit.register(_dump_at_exit)


_install_exit_dump()
