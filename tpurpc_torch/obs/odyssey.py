"""Sequence-lifecycle tracing, token latency and cost ledgers.

A copy of ``tpurpc/obs/odyssey.py`` (the same names, metric names, JSON
keys and ``TPURPC_ODYSSEY``). A generation *sequence* lives across many
RPCs and up to three processes (prefill -> KV ship -> decode -> preempt/
swap -> migrate); this module is its record, three planes over one
per-sequence ledger:

* **Journey tracing.** The originating RPC's
  :class:`~tpurpc_torch.obs.tracing.TraceContext` rides into the
  scheduler's sequence and across the disagg control plane (``OfferKv``
  fields, the ``migrate()`` offers), so one trace id stitches admission,
  prefill, the KV ship, every decode window, preemption, swap and
  migration. Spans land in the span ring of whichever process did the
  work; :func:`journey` merges the processes' ``/traces?trace_id=``
  exports onto one wall-clock axis through their clock anchors. A slow,
  shed, preempted or migrated sequence always commits its provisional
  trace (the tail-commit rule at sequence granularity).
* **Token latency.** Inter-token latency (``gen_itl_us`` +
  ``gen_itl_<class>_us``) and time-per-output-token (``gen_tpot_us`` +
  ``gen_tpot_<class>_us``) histograms recorded at the stream edge, and
  bounded rolling windows whose p99s the tsdb samples as
  ``gen_itl_p99_us{class}`` / ``gen_ttft_p99_us{class}``, so an ITL/TTFT
  objective (:mod:`tpurpc_torch.obs.slo`) can resolve when a degradation
  ends.
* **Cost accounting.** :class:`SeqLedger`: device-step microseconds (each
  step's duration split evenly over its batch rows), prefill microseconds,
  KV byte-seconds held in the arena and swap byte-seconds held on the host,
  bytes shipped over block grants, preemption/swap/migration counts.
  Ledgers roll up by the metadata key :data:`ACCOUNT_KEY`
  (``tpurpc-account``; default ``anon``) and export at ``GET /debug/seq``,
  merged across shard workers (:mod:`tpurpc_torch.obs.shard`) and fleet
  members (the collector's ``/fleet/seq``).

Cost model: every hook runs at a sequence edge or once per device step,
except the one per-token ITL record (a subtraction and a list append; the
histogram and the rolling window fill in batches of 64).
``TPURPC_ODYSSEY=0`` (or :func:`force`) drops even that; the flight
``SEQ_*`` edges stay.

Account-key grammar: ``[A-Za-z0-9._:-]{1,64}``; other characters become
``_``, longer keys are cut, an empty or absent key is ``anon``
(:func:`sanitize_account`).

Two differences from the reference. It names the overall ``gen_itl_us``
and ``gen_tpot_us`` histograms in its docstring but registers only the
per-class ones; the port registers both (``/debug/seq``'s ``itl`` and
``tpot`` blocks stay per class, as the reference's). And the port's shard
workers spawn and inherit nothing, so ``postfork_reset`` has no caller and
is not copied.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import tracing as _tracing

__all__ = [
    "ACTIVE", "ACCOUNT_KEY", "DEFAULT_ACCOUNT", "SeqLedger",
    "configure", "force", "enabled", "sanitize_account",
    "seq_submit", "seq_join", "seq_prefill", "seq_first_token",
    "seq_token", "seq_step", "seq_swap", "seq_preempt", "seq_detached",
    "seq_migrated", "seq_done",
    "itl_p99_us", "ttft_p99_us", "rolling_series",
    "seq_doc", "accounts_snapshot", "merge_seq_docs", "journey",
    "reset",
]

#: metadata key carrying the accounting identity (tenant stand-in)
ACCOUNT_KEY = "tpurpc-account"
DEFAULT_ACCOUNT = "anon"

#: the one gate the scheduler's hot sites load
ACTIVE = True
_forced: Optional[bool] = None

#: completed-sequence ring and per-class rolling token-latency windows
_DONE_CAP = 256
_ROLL_CAP = 512

#: terminal outcomes a ledger can settle with
_OUTCOMES = ("retire", "left", "shed", "refused", "failed", "migrated")

# -- token-latency histograms (per SLO class; the hot path records ONE) ------
_ITL = {
    "interactive": _metrics.histogram("gen_itl_interactive_us",
                                      kind="latency"),
    "batch": _metrics.histogram("gen_itl_batch_us", kind="latency"),
}
_TPOT = {
    "interactive": _metrics.histogram("gen_tpot_interactive_us",
                                      kind="latency"),
    "batch": _metrics.histogram("gen_tpot_batch_us", kind="latency"),
}
#: the classes' sum, filled at the same flushes
_ITL_ALL = _metrics.histogram("gen_itl_us", kind="latency")
_TPOT_ALL = _metrics.histogram("gen_tpot_us", kind="latency")
_SEQS_DONE = _metrics.counter("seq_completed")
_SEQS_MIGRATED = _metrics.counter("seq_migrated")


def _env_on() -> bool:
    from tpurpc_torch.utils.config import _env

    return (_env("TPURPC_ODYSSEY") or "1").lower() not in (
        "0", "off", "false")


def configure() -> None:
    """Recompute the gate from ``TPURPC_ODYSSEY`` (honoring :func:`force`)."""
    global ACTIVE
    ACTIVE = _forced if _forced is not None else _env_on()


def force(on: Optional[bool]) -> None:
    """Pin the plane on/off; ``None`` returns to the environment."""
    global _forced
    _forced = on
    configure()


def enabled() -> bool:
    return ACTIVE


def sanitize_account(raw) -> str:
    """The account-key grammar (module docstring)."""
    if raw is None:
        return DEFAULT_ACCOUNT
    if isinstance(raw, (bytes, bytearray, memoryview)):
        raw = bytes(raw).decode("utf-8", "replace")
    s = str(raw)[:64]
    if not s:
        return DEFAULT_ACCOUNT
    return "".join(c if (c.isalnum() or c in "._:-") else "_" for c in s)


# -- the ledger ---------------------------------------------------------------

class SeqLedger:
    """One sequence's lifetime record. Mutated by the scheduler's loop
    thread, the submitting thread (creation) and a migration thread after
    detach; the phases never overlap, so field updates are plain stores and
    only the registry takes the module lock."""

    __slots__ = (
        "sid", "name", "account", "slo", "trace", "prompt_len", "state",
        "tokens", "steps", "step_us", "prefill_us", "kv_byte_s",
        "swap_byte_s", "shipped_bytes", "preempts", "swaps", "migrations",
        "adopted", "t_submit_ns", "t_first_ns", "t_done_ns", "outcome",
        "block_bytes", "_arena_bytes", "_host_bytes", "_mark_ns",
        "_last_tok_ns", "_win_t0_ns", "_itl_hist", "_itl_roll",
        "_itl_pend",
    )

    def __init__(self, name: str, sid: int, account: str, slo: str,
                 trace, prompt_len: int, block_bytes: int,
                 shipped_bytes: int, adopted: bool):
        self.sid = sid
        self.name = name
        self.account = account
        self.slo = slo
        self.trace = trace
        self.prompt_len = prompt_len
        self.state = "waiting"
        self.tokens = 0
        self.steps = 0
        self.step_us = 0.0
        self.prefill_us = 0.0
        self.kv_byte_s = 0.0
        self.swap_byte_s = 0.0
        self.shipped_bytes = shipped_bytes
        self.preempts = 0
        self.swaps = 0
        self.migrations = 0
        self.adopted = adopted
        self.t_submit_ns = time.monotonic_ns()
        self.t_first_ns = 0
        self.t_done_ns = 0
        self.outcome = ""
        self.block_bytes = block_bytes
        self._arena_bytes = 0
        self._host_bytes = 0
        self._mark_ns = self.t_submit_ns
        self._last_tok_ns = 0
        self._win_t0_ns = 0
        # per-token references resolved once per sequence; ITL samples
        # gather in _itl_pend and flush to the histogram in batches
        self._itl_hist = _ITL[slo]
        self._itl_roll = _itl_roll[slo]
        self._itl_pend: List[int] = []

    # -- residency integration ------------------------------------------------

    def _charge(self, now_ns: int) -> None:
        """Integrate byte-seconds held since the last mark. Every
        transition charges before it flips the residency fields, so each
        interval is charged exactly once."""
        dt = now_ns - self._mark_ns
        if dt <= 0:
            return
        if self._arena_bytes:
            self.kv_byte_s += self._arena_bytes * dt / 1e9
        if self._host_bytes:
            self.swap_byte_s += self._host_bytes * dt / 1e9
        self._mark_ns = now_ns

    def _projected(self, now_ns: int):
        """(kv_byte_s, swap_byte_s) as of ``now_ns`` without mutating: the
        live /debug/seq view."""
        dt = max(0, now_ns - self._mark_ns)
        return (self.kv_byte_s + self._arena_bytes * dt / 1e9,
                self.swap_byte_s + self._host_bytes * dt / 1e9)

    def to_dict(self, now_ns: Optional[int] = None) -> dict:
        now = now_ns if now_ns is not None else time.monotonic_ns()
        kv_bs, swap_bs = self._projected(now)
        end = self.t_done_ns or now
        d = {
            "sid": self.sid, "sched": self.name, "account": self.account,
            "slo": self.slo, "state": self.state,
            "prompt_len": self.prompt_len, "tokens": self.tokens,
            "steps": self.steps,
            "step_us": round(self.step_us, 1),
            "prefill_us": round(self.prefill_us, 1),
            "kv_byte_s": round(kv_bs, 3),
            "swap_byte_s": round(swap_bs, 3),
            "shipped_bytes": self.shipped_bytes,
            "preempts": self.preempts, "swaps": self.swaps,
            "migrations": self.migrations,
            "dur_s": round((end - self.t_submit_ns) / 1e9, 3),
        }
        if self.t_first_ns:
            d["ttft_us"] = (self.t_first_ns - self.t_submit_ns) // 1000
        if self.tokens >= 2 and self._last_tok_ns > self.t_first_ns:
            d["tpot_us"] = round((self._last_tok_ns - self.t_first_ns)
                                 / 1e3 / (self.tokens - 1), 1)
        if self.outcome:
            d["outcome"] = self.outcome
        if self.trace is not None:
            d["trace_id"] = f"{self.trace.trace_id:016x}"
        return d


# -- registry -----------------------------------------------------------------

_lock = threading.Lock()
_live: Dict[tuple, SeqLedger] = {}
_done: "deque[SeqLedger]" = deque(maxlen=_DONE_CAP)
#: account -> totals of COMPLETED sequences (live ones fold in at read time)
_accounts: Dict[str, Dict[str, float]] = {}
#: device-step time seen / attributed (the >=95% attribution check)
_step_us_total = [0.0]
_step_us_attrib = [0.0]

_itl_roll: Dict[str, "deque[int]"] = {
    "interactive": deque(maxlen=_ROLL_CAP),
    "batch": deque(maxlen=_ROLL_CAP),
}
_ttft_roll: Dict[str, "deque[int]"] = {
    "interactive": deque(maxlen=_ROLL_CAP),
    "batch": deque(maxlen=_ROLL_CAP),
}

_ACCOUNT_FIELDS = ("seqs", "tokens", "step_us", "prefill_us", "kv_byte_s",
                   "swap_byte_s", "shipped_bytes", "preempts", "swaps",
                   "migrations", "sheds", "failed")


def _account_bucket(account: str) -> Dict[str, float]:
    b = _accounts.get(account)
    if b is None:
        b = _accounts[account] = {k: 0 for k in _ACCOUNT_FIELDS}
    return b


# -- scheduler-facing hooks ---------------------------------------------------
#
# Every hook tolerates ``led is None`` (the off-switch: the scheduler makes
# no ledger while ACTIVE is false, and every later site passes the None).

def seq_submit(name: str, sid: int, account: str, slo: str, trace,
               prompt_len: int, block_bytes: int = 0,
               shipped_bytes: int = 0,
               adopted: bool = False) -> SeqLedger:
    led = SeqLedger(name, sid, account, slo, trace, prompt_len,
                    block_bytes, shipped_bytes, adopted)
    with _lock:
        _live[(name, sid)] = led
    return led


def seq_join(led: Optional[SeqLedger], resumed: bool = False) -> None:
    """The boundary admitted the sequence into the running batch: close
    the admit/park wait with a journey span, open a decode window."""
    if led is None:
        return
    now = time.monotonic_ns()
    t0 = led._mark_ns \
        if led.state in ("waiting", "swapped", "preempted") else now
    name = "seq-resume" \
        if (resumed or led.state in ("swapped", "preempted")) \
        else "seq-admit"
    _record(led, name, t0, now - t0)
    led._charge(now)
    led.state = "running"
    led._win_t0_ns = now


def seq_prefill(led: Optional[SeqLedger], dur_ns: int, share: int,
                kv_bytes: int = 0) -> None:
    """One batched prefill landed this sequence's entries: charge its
    1/share of the batch's device time, start arena residency."""
    if led is None:
        return
    now = time.monotonic_ns()
    led._charge(now)
    led.prefill_us += dur_ns / 1e3 / max(1, share)
    if kv_bytes:
        led._arena_bytes = kv_bytes
    _record(led, "seq-prefill", now - dur_ns, dur_ns)


def seq_first_token(led: Optional[SeqLedger], ttft_us: int,
                    now_ns: int = 0) -> None:
    if led is None:
        return
    now = now_ns or time.monotonic_ns()
    led.tokens += 1
    led.t_first_ns = now
    led._last_tok_ns = now
    _ttft_roll[led.slo].append(ttft_us)


def seq_token(led: Optional[SeqLedger], now_ns: int = 0) -> None:
    """The per-token record: inter-token latency at the stream edge. The
    scheduler passes its step-end stamp as ``now_ns``, so a whole batch's
    tokens share one clock read."""
    if led is None:
        return
    now = now_ns or time.monotonic_ns()
    last = led._last_tok_ns
    led._last_tok_ns = now
    led.tokens += 1
    if last and now > last:
        # one list append per token; the histogram (one lock per flush)
        # and the rolling window fill in batches of 64
        pend = led._itl_pend
        pend.append((now - last) // 1000)
        if len(pend) >= 64:
            _itl_flush(led)


def _itl_flush(led: "SeqLedger") -> None:
    pend = led._itl_pend
    led._itl_hist.record_many(pend)
    _ITL_ALL.record_many(pend)
    led._itl_roll.extend(pend)
    del pend[:]


def seq_step(running, dt_ns: int, now_ns: Optional[int] = None) -> None:
    """One device step over ``running`` took ``dt_ns``: charge each member
    its share and integrate its arena residency. Duck-typed over the
    scheduler's sequences (``.led``, ``.kv``), so this module never imports
    the scheduler."""
    nb = len(running)
    if nb == 0:
        return
    now = now_ns if now_ns is not None else time.monotonic_ns()
    dt_us = dt_ns / 1e3
    share = dt_us / nb
    _step_us_total[0] += dt_us
    attrib = 0.0
    for s in running:
        led = s.led
        if led is None:
            continue
        led.steps += 1
        led.step_us += share
        attrib += share
        # residency integrates only for rows that hold bytes (paged mode)
        kv = s.kv
        if kv is not None and led.block_bytes:
            led._arena_bytes = len(kv.blocks) * led.block_bytes
            led._charge(now)
        elif led._host_bytes:
            led._charge(now)
    _step_us_attrib[0] += attrib


def seq_swap(led: Optional[SeqLedger], direction: int, nbytes: int,
             dur_ns: int) -> None:
    """Residency flip: ``direction`` 0 = out to host (``nbytes`` = the
    host image), 1 = in from host (``nbytes`` = arena bytes held again)."""
    if led is None:
        return
    now = time.monotonic_ns()
    led._charge(now)
    led.swaps += 1
    if direction == 0:
        led._arena_bytes = 0
        led._host_bytes = nbytes
        led.state = "swapped"
        _record(led, "seq-swap-out", now - dur_ns, dur_ns)
    else:
        led._host_bytes = 0
        led._arena_bytes = nbytes
        _record(led, "seq-swap-in", now - dur_ns, dur_ns)


def seq_preempt(led: Optional[SeqLedger]) -> None:
    if led is None:
        return
    now = time.monotonic_ns()
    led.preempts += 1
    if led._win_t0_ns:
        _record(led, "seq-decode", led._win_t0_ns, now - led._win_t0_ns,
                tokens=led.tokens)
        led._win_t0_ns = 0
    led._charge(now)
    led.state = "preempted"


def seq_detached(led: Optional[SeqLedger], entries: int) -> None:
    """The boundary handed the sequence out (the migration sender's half):
    the ledger stays live until :func:`seq_migrated` / :func:`seq_done`
    settles it."""
    if led is None:
        return
    now = time.monotonic_ns()
    if led._win_t0_ns:
        _record(led, "seq-decode", led._win_t0_ns, now - led._win_t0_ns,
                tokens=led.tokens)
        led._win_t0_ns = 0
    led._charge(now)
    led.state = "detached"


def seq_migrated(led: Optional[SeqLedger], shipped_bytes: int,
                 t0_ns: int) -> None:
    """The migration completed on the peer: the source's final settle.
    ``t0_ns`` brackets the ship (detach -> the peer's CompleteKv)."""
    if led is None:
        return
    led.shipped_bytes += shipped_bytes
    led.migrations += 1
    _SEQS_MIGRATED.inc()
    now = time.monotonic_ns()
    _record(led, "seq-migrate", t0_ns, now - t0_ns,
            shipped_bytes=shipped_bytes)
    seq_done(led, "migrated")


def seq_done(led: Optional[SeqLedger], outcome: str) -> None:
    """Terminal settle: integrate, close the decode window, record TPOT,
    fold into the account rollup, move live -> done, and take the journey's
    tail-commit decision."""
    if led is None or led.outcome:
        return
    now = time.monotonic_ns()
    if led._win_t0_ns:
        _record(led, "seq-decode", led._win_t0_ns, now - led._win_t0_ns,
                tokens=led.tokens)
        led._win_t0_ns = 0
    led._charge(now)
    led._arena_bytes = 0
    led._host_bytes = 0
    led.outcome = outcome if outcome in _OUTCOMES else "failed"
    led.t_done_ns = now
    led.state = "done"
    if led._itl_pend:
        _itl_flush(led)
    if led.tokens >= 2 and led._last_tok_ns > led.t_first_ns:
        tpot = int((led._last_tok_ns - led.t_first_ns)
                   / 1e3 / (led.tokens - 1))
        _TPOT[led.slo].record(tpot)
        _TPOT_ALL.record(tpot)
    _SEQS_DONE.inc()
    with _lock:
        _live.pop((led.name, led.sid), None)
        _done.append(led)
        b = _account_bucket(led.account)
        b["seqs"] += 1
        b["tokens"] += led.tokens
        b["step_us"] += led.step_us
        b["prefill_us"] += led.prefill_us
        b["kv_byte_s"] += led.kv_byte_s
        b["swap_byte_s"] += led.swap_byte_s
        b["shipped_bytes"] += led.shipped_bytes
        b["preempts"] += led.preempts
        b["swaps"] += led.swaps
        b["migrations"] += led.migrations
        if led.outcome == "shed":
            b["sheds"] += 1
        elif led.outcome == "failed":
            b["failed"] += 1
    _journey_settle(led)


# -- journey spans ------------------------------------------------------------

def _record(led: SeqLedger, name: str, t0_ns: int, dur_ns: int,
            **attrs) -> None:
    ctx = led.trace
    if ctx is None:
        return
    _tracing.record(name, ctx, t0_ns, dur_ns, sid=led.sid,
                    account=led.account, **attrs)


def _journey_settle(led: SeqLedger) -> None:
    """A provisional journey commits when the sequence was shed, refused,
    failed or migrated, was preempted or swapped, or was slow by the
    ordinary tail bar; a healthy fast retire ages out untouched."""
    ctx = led.trace
    if ctx is None or not getattr(ctx, "provisional", False):
        return
    if (led.outcome in ("shed", "refused", "failed", "migrated")
            or led.preempts or led.swaps or led.migrations):
        _tracing.tail_commit(ctx.trace_id)
        return
    _tracing.tail_decide(ctx, led.t_done_ns - led.t_submit_ns)


# -- rolling token-latency windows (the SLO substrate) ------------------------

def _roll_p(roll, q: float) -> Optional[float]:
    vals = sorted(roll)
    if not vals:
        return None
    return float(vals[min(len(vals) - 1, max(0, int(len(vals) * q) - 1))])


def itl_p99_us(slo: str = "interactive") -> Optional[float]:
    return _roll_p(list(_itl_roll.get(slo, ())), 0.99)


def ttft_p99_us(slo: str = "interactive") -> Optional[float]:
    return _roll_p(list(_ttft_roll.get(slo, ())), 0.99)


def rolling_series() -> Dict[str, float]:
    """Series for the tsdb sampler: ``gen_itl_p99_us{class}`` /
    ``gen_ttft_p99_us{class}`` from the bounded rolling windows."""
    out: Dict[str, float] = {}
    for klass, roll in _itl_roll.items():
        p = _roll_p(list(roll), 0.99)
        if p is not None:
            out["gen_itl_p99_us{" + klass + "}"] = p
    for klass, roll in _ttft_roll.items():
        p = _roll_p(list(roll), 0.99)
        if p is not None:
            out["gen_ttft_p99_us{" + klass + "}"] = p
    return out


# -- export -------------------------------------------------------------------

def accounts_snapshot() -> Dict[str, Dict[str, float]]:
    """Account rollup with the live sequences folded in at read time."""
    now = time.monotonic_ns()
    with _lock:
        out = {a: dict(b) for a, b in _accounts.items()}
        live = list(_live.values())
    for led in live:
        b = out.setdefault(led.account, {k: 0 for k in _ACCOUNT_FIELDS})
        kv_bs, swap_bs = led._projected(now)
        b["seqs"] += 1
        b["tokens"] += led.tokens
        b["step_us"] += led.step_us
        b["prefill_us"] += led.prefill_us
        b["kv_byte_s"] += kv_bs
        b["swap_byte_s"] += swap_bs
        b["shipped_bytes"] += led.shipped_bytes
        b["preempts"] += led.preempts
        b["swaps"] += led.swaps
        b["migrations"] += led.migrations
    for b in out.values():
        for k in ("step_us", "prefill_us", "kv_byte_s", "swap_byte_s"):
            b[k] = round(b[k], 3)
    return out


def _hist_doc(h) -> dict:
    s = h.snapshot()
    return {"p50_us": s["p50"], "p99_us": s["p99"], "count": s["count"]}


def seq_doc(params: Optional[dict] = None) -> dict:
    """The ``GET /debug/seq`` body: live ledgers, the recent-completed
    ring, the account rollup, the step-time attribution check and the
    token-latency summaries. ``?account=`` filters the sequence lists;
    ``?n=`` bounds them (default 32 live / 32 recent)."""
    if not ACTIVE:
        return {"enabled": False, "reason": "TPURPC_ODYSSEY=0"}
    params = params or {}
    want = params.get("account") or None
    try:
        n = max(1, int(params.get("n") or 32))
    except ValueError:
        n = 32
    now = time.monotonic_ns()
    with _lock:
        live = list(_live.values())
        done = list(_done)
    if want:
        live = [led for led in live if led.account == want]
        done = [led for led in done if led.account == want]
    live.sort(key=lambda led: led.step_us, reverse=True)
    total = _step_us_total[0]
    attrib = _step_us_attrib[0]
    return {
        "enabled": True,
        "live": [led.to_dict(now) for led in live[:n]],
        "live_total": len(live),
        "recent": [led.to_dict(now) for led in done[-n:]][::-1],
        "accounts": accounts_snapshot(),
        "step_us_total": round(total, 1),
        "step_us_attributed": round(attrib, 1),
        "attributed_pct": round(attrib / total * 100, 2) if total else None,
        "itl": {k: _hist_doc(h) for k, h in _ITL.items()},
        "tpot": {k: _hist_doc(h) for k, h in _TPOT.items()},
        "itl_p99_rolling_us": {k: _roll_p(list(r), 0.99)
                               for k, r in _itl_roll.items()},
        "ttft_p99_rolling_us": {k: _roll_p(list(r), 0.99)
                                for k, r in _ttft_roll.items()},
    }


def merge_seq_docs(docs: Dict[str, dict], label: str = "member") -> dict:
    """The pure shard/fleet merge: per-source docs keyed by shard id or
    member target -> one doc with tagged sequence lists and summed
    account/attribution totals."""
    live: List[dict] = []
    recent: List[dict] = []
    accounts: Dict[str, Dict[str, float]] = {}
    total = attrib = 0.0
    enabled = False
    for src in sorted(docs):
        doc = docs[src] or {}
        if not doc.get("enabled"):
            continue
        enabled = True
        for row in doc.get("live", ()):
            live.append(dict(row, **{label: src}))
        for row in doc.get("recent", ()):
            recent.append(dict(row, **{label: src}))
        for acct, b in (doc.get("accounts") or {}).items():
            agg = accounts.setdefault(acct, {k: 0 for k in _ACCOUNT_FIELDS})
            for k in _ACCOUNT_FIELDS:
                agg[k] = round(agg[k] + (b.get(k) or 0), 3)
        total += float(doc.get("step_us_total") or 0.0)
        attrib += float(doc.get("step_us_attributed") or 0.0)
    live.sort(key=lambda r: r.get("step_us", 0), reverse=True)
    return {
        "enabled": enabled,
        "sources": sorted(docs),
        "live": live,
        "recent": recent,
        "accounts": accounts,
        "step_us_total": round(total, 1),
        "step_us_attributed": round(attrib, 1),
        "attributed_pct": round(attrib / total * 100, 2) if total else None,
    }


# -- the cross-process journey ------------------------------------------------

def _rebase_us(t_mono_ns: int, anchor: Optional[dict],
               epoch_wall_ns: int) -> float:
    """One monotonic stamp -> microseconds since ``epoch_wall_ns`` on the
    shared wall clock, through the exporting process's anchor."""
    if anchor:
        wall = t_mono_ns - int(anchor["mono_ns"]) + int(anchor["wall_ns"])
    else:
        wall = t_mono_ns  # no anchor: raw, and flagged
    return (wall - epoch_wall_ns) / 1e3


def _lanes(target: str, doc: dict) -> List[tuple]:
    """One member's /traces doc as ``(label, anchor, events)`` lanes: a
    shard-merged doc (``clock_anchors``) gives one lane per worker."""
    anchors = doc.get("clock_anchors")
    if anchors is not None:
        by_shard: Dict[int, List[dict]] = {}
        for e in doc.get("traceEvents", ()):
            by_shard.setdefault(int(e.get("pid", 0)), []).append(e)
        shards = sorted(set(by_shard) | {int(k) for k in anchors})
        return [(f"{target} shard {k}", anchors.get(str(k)),
                 by_shard.get(k, [])) for k in shards]
    return [(target, doc.get("clock_anchor"),
             list(doc.get("traceEvents", ())))]


def journey(targets: List[str], trace_id: "int | str") -> dict:
    """One sequence's cross-process journey as a Perfetto chrome trace:
    fetch ``/traces?trace_id=`` from every named process (serving ports:
    the scrape plane answers) and rebase each lane onto the earliest
    anchor's wall clock. Each process is one named lane; a member without
    an anchor is listed in ``otherData.unanchored``, never silently
    misaligned."""
    import json as _json
    import urllib.request

    if isinstance(trace_id, int):
        trace_id = f"{trace_id:016x}"
    lanes: List[tuple] = []
    members: List[str] = []
    for t in targets:
        try:
            with urllib.request.urlopen(
                    f"http://{t}/traces?trace_id={trace_id}",
                    timeout=5) as resp:
                doc = _json.loads(resp.read())
        except Exception:
            continue
        members.append(t)
        lanes.extend(_lanes(t, doc))
    anchors = [a for _l, a, _e in lanes if a]
    epoch = min(int(a["wall_ns"]) for a in anchors) if anchors else 0
    out_events: List[dict] = []
    unanchored: List[str] = []
    for pid, (label, anchor, events) in enumerate(lanes, 1):
        if not anchor:
            unanchored.append(label)
        out_events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": label}})
        for e in events:
            if e.get("ph") == "M" and e.get("name") == "process_name":
                continue
            e = dict(e, pid=pid)
            if e.get("ph") != "M":  # metadata rows carry no timestamp
                e["ts"] = _rebase_us(int(float(e.get("ts", 0.0)) * 1e3),
                                     anchor, epoch)
            out_events.append(e)
    # anchors are read at export time, so spans recorded before the
    # earliest export rebase negative: shift so the earliest is t=0
    stamps = [e["ts"] for e in out_events if "ts" in e]
    t_min = min(stamps) if stamps else 0.0
    for e in out_events:
        if "ts" in e:
            e["ts"] = round(e["ts"] - t_min, 3)
    return {
        "traceEvents": out_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "tpurpc_torch.obs.odyssey",
            "members": members,
            "lanes": len(lanes),
            "epoch_wall_ns": epoch + int(t_min * 1e3),
            "unanchored": unanchored,
        },
        "trace_id": trace_id,
    }


# -- lifecycle ----------------------------------------------------------------

def reset() -> None:
    """Test isolation: forget every ledger, rollup and rolling window."""
    global _forced
    with _lock:
        _live.clear()
        _done.clear()
        _accounts.clear()
    _step_us_total[0] = 0.0
    _step_us_attrib[0] = 0.0
    for r in _itl_roll.values():
        r.clear()
    for r in _ttft_roll.values():
        r.clear()
    _forced = None
    configure()


configure()
