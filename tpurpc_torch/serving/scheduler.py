"""The continuous-batching decode scheduler.

A copy of ``tpurpc/serving/scheduler.py`` (the same flight edges, metric
names, ledgers and ``/healthz`` lines).

:class:`DecodeScheduler` re-batches between decode steps. One loop thread
owns the running batch and walks a two-phase cycle:

``boundary`` (membership changes happen here and only here)
    retire finished sequences, drop those whose client left, preempt
    batch-class sequences when interactive work waits and the batch is
    full, then admit waiting prefills under a per-step token budget: a new
    request joins the running batch without the batch draining, and its
    first token (the prefill's sample) streams at once.
``step``
    one batched ``model.step`` over every running sequence. The opaque
    states are stacked with ``torch.stack`` on the model's device (the
    reference's ``np.stack``), so a step adds no per-row host round trip:
    the model's one device-to-host copy of the batch's tokens is all that
    reaches the host.

The running batch is loop-private; the one shared edge is the waiting
queue, guarded by ``_lock`` and only ever waited on with a timeout.

Overload sheds class-aware and early: batch-class work sheds at
``batch_shed_depth`` (half the queue bar by default) or as soon as the
step-time EWMA exceeds ``step_slo_ms``; interactive work only at the full
bar. Rejections carry a pushback hint.

A batched ``prefill``/``step`` that raises is retried row by row, so a
poisoned sequence fails alone.

With ``kv=KvBlockManager`` and a model implementing the explicit-KV
contract the scheduler runs paged: per-sequence block tables, prefix-cache
prefill skips, preemption that swaps the victim's blocks to host, and
:meth:`detach` / :meth:`submit_adopted` for the migration plane.

Observability, under the reference's names: every sequence carries its
originating RPC's trace context and an accounting identity (``trace=`` /
``account=`` on ``submit`` and ``submit_adopted``), and the loop feeds the
:mod:`tpurpc_torch.obs.odyssey` hooks at lifecycle edges (a ledger at
submit, journey spans at join/preempt/swap/retire, the per-token ITL at the
stream edge, per-step cost shares at step end), all behind the one
``odyssey.ACTIVE`` gate. The flight edges ``SEQ_SUBMIT``, ``GEN_JOIN``,
``SEQ_FIRST_TOKEN``, ``GEN_STEP_BEGIN``/``END``, ``GEN_PREEMPT``,
``SEQ_DETACH``, ``GEN_LEAVE``, ``GEN_RETIRE`` and ``GEN_SHED`` (tag
``decode:<name>``) stay on whatever the gate says; the stall watchdog reads
an open ``GEN_STEP_BEGIN`` as its ``decode-step`` stage and the
``decode_running``/``decode_waiting`` fleet gauges as its evidence. Per
device step: ``decode_steps``, ``gen_tokens``, ``decode_step_us``,
``decode_batch``; per sequence: ``gen_ttft_us``, ``gen_shed{slo}``,
``gen_preempted``, ``gen_seq_failed``. The loop's functions are the
profiler's ``decode_step`` stage, and :func:`health_lines` gives
``/healthz`` one ``gen`` line per live scheduler.
"""

from __future__ import annotations

import itertools
import queue as _qmod
import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tpurpc_torch.analysis.locks import make_condition, make_event, make_lock
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import odyssey as _odyssey
from tpurpc_torch.obs import profiler as _profiler

__all__ = ["DecodeScheduler", "TokenStream", "ShedError", "DrainingError",
           "SLO_INTERACTIVE", "SLO_BATCH", "health_lines"]

#: everything the loop thread does (stacking, the batched model call,
#: membership bookkeeping) is the profiler's `decode_step` stage
_LENS_STAGES = {
    "_step_loop": "decode_step",
    "_boundary": "decode_step",
    "_admit": "decode_step",
    "_run_step": "decode_step",
    "_prefill_batch": "decode_step",
}
_profiler.register_stages(__file__, _LENS_STAGES)

SLO_INTERACTIVE = "interactive"
SLO_BATCH = "batch"
_SLO_CODE = {SLO_INTERACTIVE: 0, SLO_BATCH: 1}

#: one counter bump / histogram record per DEVICE STEP (amortized over the
#: batch); per-sequence records only at the join and retire edges
_STEPS = _metrics.counter("decode_steps")
_TOKENS = _metrics.counter("gen_tokens")
_STEP_US = _metrics.histogram("decode_step_us", kind="latency")
_STEP_BATCH = _metrics.histogram("decode_batch")
_TTFT_US = _metrics.histogram("gen_ttft_us", kind="latency")
_SHED = _metrics.labeled_counter("gen_shed", ("slo",))
_PREEMPTS = _metrics.counter("gen_preempted")
_SEQ_FAILED = _metrics.counter("gen_seq_failed")
#: scrape-time truth for the watchdog and /healthz: live batch occupancy
#: and queue depth, weakly held like every fleet gauge
_RUNNING_G = _metrics.fleet("decode_running", lambda s: s.running_depth())
_WAITING_G = _metrics.fleet("decode_waiting", lambda s: s.queue_depth())

#: live schedulers for /healthz's `gen` lines
_LIVE: "weakref.WeakSet[DecodeScheduler]" = weakref.WeakSet()


class ShedError(RuntimeError):
    """Request shed at submit; ``pushback_ms`` is the retry floor the
    transport forwards."""

    def __init__(self, reason: str, pushback_ms: int, slo: str):
        super().__init__(reason)
        self.pushback_ms = int(pushback_ms)
        self.slo = slo


class DrainingError(RuntimeError):
    """Refused because the scheduler (or its server) is draining:
    in-flight sequences finish, new prefills do not start."""


_DONE = object()


class _Seq:
    """One generation request inside the scheduler. ``q`` is its only
    egress (tokens, _DONE or an exception); ``cancelled`` is the leave
    flag, honored at the next step boundary; ``kv`` is the paged block
    table; ``trace``/``account``/``led`` are its journey context,
    accounting identity and cost ledger."""

    __slots__ = ("sid", "prompt", "prompt_len", "max_tokens", "slo",
                 "slo_code", "state", "last_token", "emitted", "q",
                 "cancelled", "t_submit_ns", "t_first_ns", "kv", "trace",
                 "account", "led")

    def __init__(self, sid: int, prompt: np.ndarray, max_tokens: int,
                 slo: str):
        self.sid = sid
        self.prompt = prompt
        self.prompt_len = int(prompt.shape[0])
        self.max_tokens = max_tokens
        self.slo = slo
        self.slo_code = _SLO_CODE[slo]
        self.state = None
        self.last_token = 0
        self.emitted = 0
        self.q: "_qmod.Queue" = _qmod.Queue()
        self.cancelled = False
        self.t_submit_ns = time.monotonic_ns()
        self.t_first_ns = 0
        self.kv = None
        self.trace = None
        self.account = _odyssey.DEFAULT_ACCOUNT
        self.led = None

    def resumable(self) -> bool:
        """Prefilled already: admission is free."""
        return self.state is not None or self.kv is not None


class TokenStream:
    """Caller-facing handle of one sequence: iterate tokens, or drive it
    with :meth:`next` (bounded waits). :meth:`cancel` is the leave
    signal."""

    #: a stream nobody feeds for this long raises instead of hanging
    MAX_IDLE_S = 60.0

    def __init__(self, seq: _Seq, sched: "DecodeScheduler"):
        self._seq = seq
        self._sched = sched

    @property
    def sid(self) -> int:
        return self._seq.sid

    @property
    def emitted(self) -> int:
        return self._seq.emitted

    def next(self, timeout: Optional[float] = None):
        """The next token (int), ``None`` on timeout; raises
        ``StopIteration`` when done, or the sequence's own error."""
        try:
            item = self._seq.q.get(timeout=timeout)
        except _qmod.Empty:
            return None
        if item is _DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def cancel(self) -> None:
        """Leave: the loop retires the sequence at the next boundary.
        Idempotent, any thread."""
        seq = self._seq
        if not seq.cancelled:
            seq.cancelled = True
            self._sched._wake()

    def __iter__(self):
        return self

    def __next__(self):
        tok = self.next(timeout=self.MAX_IDLE_S)
        if tok is None:
            raise TimeoutError(
                f"sequence {self._seq.sid}: no token in "
                f"{self.MAX_IDLE_S}s")
        return tok


class DecodeScheduler:
    """Continuous-batching scheduler around a step model.

    Knobs: ``max_batch`` (rows per step), ``prefill_budget`` (prompt
    tokens admitted per boundary; the first prefill is exempt),
    ``max_waiting`` (the interactive shed bar), ``batch_shed_depth`` (the
    batch-class bar, default half), ``step_slo_ms`` (batch work sheds
    while the step-time EWMA is above it) and ``draining_fn`` (usually
    ``lambda: server.draining``).
    """

    def __init__(self, model, *, max_batch: int = 8,
                 prefill_budget: int = 128, max_waiting: int = 32,
                 batch_shed_depth: Optional[int] = None,
                 step_slo_ms: Optional[float] = None,
                 base_pushback_ms: int = 25, max_pushback_ms: int = 1000,
                 idle_wait_s: float = 0.05,
                 draining_fn: Optional[Callable[[], bool]] = None,
                 kv=None, name: str = "gen"):
        self.model = model
        self.kv = kv
        self._paged = kv is not None
        if self._paged and not hasattr(model, "prefill_paged"):
            raise ValueError(
                "kv= given but the model implements no explicit-KV "
                "contract (prefill_paged/step_paged; see "
                "tpurpc_torch.torchshim.generate)")
        self.max_batch = max(1, int(max_batch))
        self.prefill_budget = max(1, int(prefill_budget))
        self.max_waiting = max(1, int(max_waiting))
        self.batch_shed_depth = (int(batch_shed_depth)
                                 if batch_shed_depth is not None
                                 else max(1, self.max_waiting // 2))
        self.step_slo_ms = step_slo_ms
        self.base_pushback_ms = int(base_pushback_ms)
        self.max_pushback_ms = int(max_pushback_ms)
        self.idle_wait_s = idle_wait_s
        self._draining_fn = draining_fn
        self.name = name
        self._lock = make_lock("DecodeScheduler._lock")
        self._kick = make_condition("DecodeScheduler._kick", self._lock)
        self._waiting: "deque[_Seq]" = deque()
        self._closed = False
        self._draining = False
        self._running: List[_Seq] = []   # loop-private
        #: paged mode: preempted sequences whose KV is swapped to host
        self._swapped: List[_Seq] = []
        #: sid -> (event, box): migration threads asking for a sequence
        self._detach_req: Dict[int, tuple] = {}
        self._sids = itertools.count(1)
        #: arena bytes per block (0 in opaque mode): the ledger's KV
        #: byte-second integrand
        self._kv_block_bytes = int(getattr(kv, "block_bytes", 0) or 0) \
            if kv is not None else 0
        self._tag = _flight.tag_for(f"decode:{name}")
        self._step_roll: "deque[float]" = deque(maxlen=64)  # step ms
        self._step_ewma_ms = 0.0
        self.steps = 0
        self.tokens_out = 0
        self.rows_stepped = 0
        self.shed_total = 0
        self.preempted_total = 0
        self.last_shed_ns = 0
        _RUNNING_G.track(self)
        _WAITING_G.track(self)
        _LIVE.add(self)
        self._thread = threading.Thread(target=self._step_loop, daemon=True,
                                        name=f"tpurpc-decode-{name}")
        self._thread.start()

    # -- submit side ----------------------------------------------------------

    def submit(self, prompt, *, max_tokens: int = 32,
               slo: str = SLO_INTERACTIVE, trace=None,
               account: Optional[str] = None) -> TokenStream:
        """Queue one generation request; returns its :class:`TokenStream`.
        Raises :class:`ShedError`, :class:`DrainingError`, or
        ``RuntimeError`` (closed). ``trace``/``account`` are the
        originating RPC's :class:`~tpurpc_torch.obs.tracing.TraceContext`
        and accounting identity (the transport face passes the ambient
        context and the ``tpurpc-account`` metadata key)."""
        if slo not in _SLO_CODE:
            raise ValueError(f"unknown slo class {slo!r} "
                             f"(want {sorted(_SLO_CODE)})")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        seq = _Seq(next(self._sids), prompt, max(1, int(max_tokens)), slo)
        self._enqueue(seq, trace, account, "new prefills are refused")
        return TokenStream(seq, self)

    def submit_adopted(self, kv_handle, prompt, *, last_token: int,
                       emitted: int, max_tokens: int,
                       slo: str = SLO_INTERACTIVE, trace=None,
                       account: Optional[str] = None,
                       shipped_bytes: int = 0) -> TokenStream:
        """Graft a sequence whose KV was computed elsewhere (a prefill
        handoff or an inbound migration): it joins as a free resume and its
        next token continues the stream where the sender left it. The
        scheduler owns the table afterwards. ``trace``/``account``/
        ``shipped_bytes`` continue the sender's journey and ledger across
        the process split."""
        if not self._paged:
            raise RuntimeError("submit_adopted needs a paged scheduler "
                               "(kv=)")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        seq = _Seq(next(self._sids), prompt, max(1, int(max_tokens)), slo)
        seq.kv = kv_handle
        seq.last_token = int(last_token)
        seq.emitted = int(emitted)
        self._enqueue(seq, trace, account, "adoption refused",
                      shipped_bytes=int(shipped_bytes), adopted=True)
        return TokenStream(seq, self)

    def _enqueue(self, seq: _Seq, trace, account: Optional[str],
                 refused: str, shipped_bytes: int = 0,
                 adopted: bool = False) -> None:
        seq.trace = trace
        seq.account = _odyssey.sanitize_account(account)
        if _odyssey.ACTIVE:
            seq.led = _odyssey.seq_submit(
                self.name, seq.sid, seq.account, seq.slo, trace,
                seq.prompt_len, self._kv_block_bytes,
                shipped_bytes=shipped_bytes, adopted=adopted)
        try:
            with self._lock:
                if self._closed:
                    raise RuntimeError("scheduler closed")
                if self._draining or (self._draining_fn is not None
                                      and self._draining_fn()):
                    raise DrainingError(f"scheduler draining: {refused}")
                reason, pushback = self._shed_decision_locked(seq.slo)
                if reason is not None:
                    self.shed_total += 1
                    self.last_shed_ns = time.monotonic_ns()
                    slo_code = seq.slo_code
                    _flight.emit(_flight.GEN_SHED, self._tag, slo_code,
                                 pushback)
                    _SHED.labels(seq.slo).inc()
                    raise ShedError(reason, pushback, seq.slo)
                sid = seq.sid
                plen = seq.prompt_len
                _flight.emit(_flight.SEQ_SUBMIT, self._tag, sid, plen)
                self._waiting.append(seq)
                self._kick.notify_all()
        except ShedError:
            _odyssey.seq_done(seq.led, "shed")
            raise
        except BaseException:
            _odyssey.seq_done(seq.led, "refused")
            raise

    def detach(self, sid: int, timeout: float = 5.0):
        """Remove a live sequence (running, swapped or waiting-resumable)
        with its KV intact: the migration sender's half. Waits up to
        ``timeout`` for the next boundary; returns the internal sequence
        object, or None. The caller owns its table afterwards."""
        ev = make_event("DecodeScheduler.detach")
        box: List[_Seq] = []
        with self._lock:
            if self._closed:
                return None
            self._detach_req[sid] = (ev, box)
            self._kick.notify_all()
        ev.wait(timeout)
        with self._lock:
            self._detach_req.pop(sid, None)
        return box[0] if box else None

    # -- load signals ---------------------------------------------------------

    def swapped_depth(self) -> int:
        return len(self._swapped)

    def load_depth(self) -> int:
        """Waiting AND swapped work: the load signal."""
        return len(self._waiting) + len(self._swapped)

    def live_sids(self) -> List[int]:
        """Sids running, swapped or waiting-resumable: the migration
        worklist."""
        out = [s.sid for s in list(self._running)]
        out.extend(s.sid for s in list(self._swapped))
        out.extend(s.sid for s in list(self._waiting) if s.resumable())
        return out

    def _shed_decision_locked(self, slo: str):
        """(reason, pushback_ms) when this submit must shed, else
        (None, 0)."""
        depth = len(self._waiting)
        if depth >= self.max_waiting:
            return ("queue full "
                    f"({depth}/{self.max_waiting} waiting)",
                    self._pushback(depth - self.max_waiting + 1))
        if slo == SLO_BATCH:
            if depth >= self.batch_shed_depth:
                return ("batch-class queue bar "
                        f"({depth}/{self.batch_shed_depth} waiting)",
                        self._pushback(depth - self.batch_shed_depth + 1))
            if (self.step_slo_ms is not None and depth > 0
                    and self._step_ewma_ms > self.step_slo_ms):
                return ("step time over SLO "
                        f"({self._step_ewma_ms:.1f}ms > "
                        f"{self.step_slo_ms}ms)",
                        self._pushback(2))
        return None, 0

    def _pushback(self, excess: int) -> int:
        return min(self.max_pushback_ms,
                   self.base_pushback_ms * max(1, excess))

    def _wake(self) -> None:
        with self._lock:
            self._kick.notify_all()

    # -- lifecycle ------------------------------------------------------------

    def drain(self) -> None:
        """Refuse new submits; in-flight sequences finish."""
        with self._lock:
            self._draining = True

    def close(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._closed = True
            self._kick.notify_all()
        self._thread.join(timeout=timeout)
        # leave /healthz now: the loop thread's target is a cycle back to
        # self, so waiting for the cyclic GC would keep a dead line there
        _LIVE.discard(self)

    # -- shared-state reads ---------------------------------------------------

    def queue_depth(self) -> int:
        return len(self._waiting)

    def running_depth(self) -> int:
        return len(self._running)

    def step_time_ms(self) -> float:
        return self._step_ewma_ms

    def step_p99_ms(self) -> Optional[float]:
        """Rolling p99 of recent step times (the admission gate's latency
        signal), or None before 8 steps."""
        roll = list(self._step_roll)
        if len(roll) < 8:
            return None
        roll.sort()
        return roll[max(0, int(len(roll) * 0.99) - 1)]

    def state_str(self) -> str:
        if self._draining or (self._draining_fn is not None
                              and self._draining_fn()):
            return "draining"
        if (self.last_shed_ns
                and time.monotonic_ns() - self.last_shed_ns < 5_000_000_000):
            return "shedding"
        return "ok"

    # -- the loop thread ------------------------------------------------------

    def _step_loop(self) -> None:
        while True:
            if not self._boundary():
                return
            if self._running:
                self._run_step()

    def _boundary(self) -> bool:
        """One step boundary: retire leaves, preempt, admit (with
        prefill). False when closed. Every wait here is bounded."""
        kept: List[_Seq] = []
        for s in self._running:
            if s.cancelled:
                sid = s.sid
                emitted = s.emitted
                _flight.emit(_flight.GEN_LEAVE, self._tag, sid, emitted)
                self._release_kv(s, cache=True)
                _odyssey.seq_done(s.led, "left")
                s.q.put(_DONE)
            else:
                kept.append(s)
        self._running = kept
        if self._swapped:
            self._swapped = [s for s in self._swapped
                             if not self._drop_if_cancelled(s)]
        preempt: List[_Seq] = []
        with self._lock:
            if self._closed:
                stranded = (list(self._running) + list(self._waiting)
                            + list(self._swapped))
                self._waiting.clear()
                self._running = []
                self._swapped = []
                for _sid, (ev, _box) in self._detach_req.items():
                    ev.set()
                self._detach_req.clear()
                err = RuntimeError("scheduler closed")
                for s in stranded:
                    self._release_kv(s, cache=False)
                    _odyssey.seq_done(s.led, "failed")
                    s.q.put(err)
                return False
            if self._detach_req:
                self._serve_detach_locked()
            draining = self._draining or (self._draining_fn is not None
                                          and self._draining_fn())
            admit, keep, drop, preempt = self._admit(draining)
            self._waiting.clear()
            self._waiting.extend(keep)
            if (not self._running and not admit and not drop
                    and not preempt):
                self._kick.wait(timeout=self.idle_wait_s)
                return True
        # paged preemption outside the lock: swap_out copies block bytes
        for s in preempt:
            t0 = time.monotonic_ns()
            self.kv.swap_out(s.kv)
            if s.led is not None:
                host = s.kv.host
                _odyssey.seq_swap(s.led, 0,
                                  len(host) if host is not None else 0,
                                  time.monotonic_ns() - t0)
            self._swapped.append(s)
        for s, outcome in drop:
            sid = s.sid
            emitted = s.emitted
            if isinstance(outcome, BaseException):
                _flight.emit(_flight.GEN_RETIRE, self._tag, sid, emitted)
                self._release_kv(s, cache=False)
                _odyssey.seq_done(
                    s.led, "refused" if isinstance(outcome, DrainingError)
                    else "failed")
                s.q.put(outcome)
            else:
                _flight.emit(_flight.GEN_LEAVE, self._tag, sid, emitted)
                self._release_kv(s, cache=True)
                _odyssey.seq_done(s.led, "left")
                s.q.put(_DONE)
        if admit:
            self._prefill_batch(admit)
        return True

    def _drop_if_cancelled(self, s: _Seq) -> bool:
        if not s.cancelled:
            return False
        sid = s.sid
        emitted = s.emitted
        _flight.emit(_flight.GEN_LEAVE, self._tag, sid, emitted)
        self._release_kv(s, cache=False)
        _odyssey.seq_done(s.led, "left")
        s.q.put(_DONE)
        return True

    def _serve_detach_locked(self) -> None:
        """Hand requested sequences to waiting migration threads (under
        ``_lock`` on the loop thread, the only mutator of its lists)."""
        for sid in list(self._detach_req):
            ev, box = self._detach_req[sid]
            found = None
            for pool in (self._running, self._swapped):
                for s in pool:
                    if s.sid == sid:
                        found = s
                        pool.remove(s)
                        break
                if found is not None:
                    break
            if found is None:
                for s in list(self._waiting):
                    if s.sid == sid and s.resumable():
                        found = s
                        self._waiting.remove(s)
                        break
            if found is not None:
                kv = found.kv
                entries = kv.length if kv is not None else 0
                _flight.emit(_flight.SEQ_DETACH, self._tag, sid, entries)
                _odyssey.seq_detached(found.led, entries)
                box.append(found)
                ev.set()
                del self._detach_req[sid]

    def _release_kv(self, s: _Seq, cache: bool) -> None:
        """Return a sequence's block table to the arena (no-op in opaque
        mode or when the table moved elsewhere)."""
        kv = s.kv
        if kv is None:
            return
        s.kv = None
        try:
            self.kv.free_blocks(kv, cache_prefix=cache)
        except Exception:
            pass  # releasing must never take the loop down

    def _admit(self, draining: bool):
        """Decide the boundary's joins (under ``_lock``, pure with respect
        to the waiting queue). Interactive first; preemption makes room for
        it; prefill rides the token budget; resumes are free. Returns
        ``(admit, keep, drop, preempt)``."""
        admit: List[_Seq] = []
        drop: List[tuple] = []
        preempt: List[_Seq] = []
        live: List[_Seq] = []
        for s in self._waiting:
            if s.cancelled:
                drop.append((s, None))
            else:
                live.append(s)
        if not live and not self._swapped:
            return admit, live, drop, preempt
        want_i = sum(1 for s in live if s.slo == SLO_INTERACTIVE)
        if want_i and len(self._running) >= self.max_batch:
            for s in reversed(list(self._running)):
                if want_i <= 0:
                    break
                if s.slo == SLO_BATCH:
                    self._running.remove(s)
                    sid = s.sid
                    slo_code = s.slo_code
                    _flight.emit(_flight.GEN_PREEMPT, self._tag, sid,
                                 slo_code)
                    _odyssey.seq_preempt(s.led)
                    _PREEMPTS.inc()
                    self.preempted_total += 1
                    if self._paged:
                        preempt.append(s)
                    else:
                        live.insert(0, s)
                    want_i -= 1
        slots = self.max_batch - len(self._running)
        budget = self.prefill_budget
        prefills = 0
        keep: List[_Seq] = []
        for klass in (SLO_INTERACTIVE, SLO_BATCH):
            for s in live:
                if s.slo != klass:
                    continue
                if slots <= 0:
                    keep.append(s)
                    continue
                if s.resumable():
                    admit.append(s)
                    slots -= 1
                    continue
                if draining:
                    drop.append((s, DrainingError(
                        "scheduler draining: prefill refused")))
                    continue
                cost = s.prompt_len
                if cost <= budget or prefills == 0:
                    admit.append(s)
                    slots -= 1
                    budget -= cost
                    prefills += 1
                else:
                    keep.append(s)
        # swapped sequences come back when room remains after the queue
        while slots > 0 and self._swapped and not preempt:
            admit.append(self._swapped.pop(0))
            slots -= 1
        keep.sort(key=lambda s: s.sid)
        return admit, keep, drop, preempt

    def _prefill_batch(self, admit: List[_Seq]) -> None:
        """Join the admitted sequences: resumes re-enter directly (a
        swapped table swaps back in first), fresh prompts prefill as ONE
        batched call (row-isolated on failure)."""
        fresh = [s for s in admit if not s.resumable()]
        for s in admit:
            if not s.resumable():
                continue
            if s.kv is not None and s.kv.swapped:
                t0 = time.monotonic_ns()
                try:
                    self.kv.swap_in(s.kv)
                except Exception:
                    self._swapped.append(s)  # arena full: stay parked
                    continue
                if s.led is not None:
                    _odyssey.seq_swap(
                        s.led, 1,
                        len(s.kv.blocks) * self._kv_block_bytes,
                        time.monotonic_ns() - t0)
            sid = s.sid
            _flight.emit(_flight.GEN_JOIN, self._tag, sid, 0)
            _odyssey.seq_join(s.led, resumed=True)
            self._running.append(s)
        if not fresh:
            return
        if self._paged:
            self._prefill_paged(fresh)
            return
        t0_pf = time.monotonic_ns()
        try:
            states, tokens = self.model.prefill([s.prompt for s in fresh])
            results = [(states[i], int(tokens[i]))
                       for i in range(len(fresh))]
        except Exception:
            results = []
            for s in fresh:
                try:
                    st, tok = self.model.prefill([s.prompt])
                    results.append((st[0], int(tok[0])))
                except Exception as exc:
                    results.append(exc)
        dt_pf = time.monotonic_ns() - t0_pf
        emitted = 0
        for s, res in zip(fresh, results):
            sid = s.sid
            plen = s.prompt_len
            if isinstance(res, Exception):
                _SEQ_FAILED.inc()
                _flight.emit(_flight.GEN_RETIRE, self._tag, sid, 0)
                _odyssey.seq_done(s.led, "failed")
                s.q.put(res)
                continue
            s.state, first = res
            _flight.emit(_flight.GEN_JOIN, self._tag, sid, plen)
            _odyssey.seq_join(s.led)
            _odyssey.seq_prefill(s.led, dt_pf, len(fresh))
            self._emit_token(s, first)
            emitted += 1
            if s.emitted < s.max_tokens and not self._hit_eos(first):
                self._running.append(s)
            else:
                self._retire(s)
        # prefill's sampled token counts like any other emitted token
        self.tokens_out += emitted
        _TOKENS.inc(emitted)

    def _prefill_paged(self, fresh: List[_Seq]) -> None:
        """The explicit-KV prefill: allocate each row's table (prefix cache
        consulted), one batched ``prefill_paged``, row-isolated retry with
        truncate-undo on failure."""
        ready: List[_Seq] = []
        for s in fresh:
            try:
                # the sequence adopts the table in the same statement;
                # every later path releases it through _release_kv
                s.kv, _hit = self.kv.alloc_for_prompt(  # tpr: allow(kv)
                    s.sid, s.prompt)
                ready.append(s)
            except Exception as exc:
                _SEQ_FAILED.inc()
                sid = s.sid
                _flight.emit(_flight.GEN_RETIRE, self._tag, sid, 0)
                _odyssey.seq_done(s.led, "failed")
                s.q.put(exc)
        if not ready:
            return
        lengths = [s.kv.length for s in ready]
        t0_pf = time.monotonic_ns()
        try:
            toks = self.model.prefill_paged([s.prompt for s in ready],
                                            [s.kv for s in ready])
            results = [int(toks[i]) for i in range(len(ready))]
        except Exception:
            results = []
            for s, n0 in zip(ready, lengths):
                s.kv.truncate(n0)
                try:
                    t = self.model.prefill_paged([s.prompt], [s.kv])
                    results.append(int(t[0]))
                except Exception as exc:
                    s.kv.truncate(n0)
                    results.append(exc)
        dt_pf = time.monotonic_ns() - t0_pf
        emitted = 0
        for s, res in zip(ready, results):
            sid = s.sid
            plen = s.prompt_len
            if isinstance(res, Exception):
                _SEQ_FAILED.inc()
                _flight.emit(_flight.GEN_RETIRE, self._tag, sid, 0)
                self._release_kv(s, cache=False)
                _odyssey.seq_done(s.led, "failed")
                s.q.put(res)
                continue
            _flight.emit(_flight.GEN_JOIN, self._tag, sid, plen)
            _odyssey.seq_join(s.led)
            _odyssey.seq_prefill(
                s.led, dt_pf, len(ready),
                kv_bytes=len(s.kv.blocks) * self._kv_block_bytes)
            self._emit_token(s, res)
            emitted += 1
            if s.emitted < s.max_tokens and not self._hit_eos(res):
                self._running.append(s)
            else:
                self._retire(s)
        self.tokens_out += emitted
        _TOKENS.inc(emitted)

    def _run_step(self) -> None:
        """One batched decode step over the running batch; delivery and
        retirement inline (loop-private state)."""
        running = self._running
        nb = len(running)
        waiting_n = len(self._waiting)
        _flight.emit(_flight.GEN_STEP_BEGIN, self._tag, nb, waiting_n)
        t0 = time.monotonic_ns()
        tokens = np.asarray([s.last_token for s in running], dtype=np.int32)
        if self._paged:
            lengths = [s.kv.length for s in running]
            try:
                toks = self.model.step_paged([s.kv for s in running],
                                             tokens)
                results = [(None, int(toks[i])) for i in range(nb)]
            except Exception:
                # poisoned batch: undo partial appends, retry row by row
                results = []
                for s, n0 in zip(running, lengths):
                    s.kv.truncate(n0)
                    try:
                        t = self.model.step_paged(
                            [s.kv], np.asarray([s.last_token], np.int32))
                        results.append((None, int(t[0])))
                    except Exception as exc:
                        s.kv.truncate(n0)
                        results.append(exc)
        else:
            states = torch.stack([s.state for s in running])
            try:
                new_states, new_tokens = self.model.step(states, tokens)
                results = [(new_states[i], int(new_tokens[i]))
                           for i in range(nb)]
            except Exception:
                # poisoned batch: retry row by row so it fails alone
                results = []
                for s in running:
                    try:
                        st, tok = self.model.step(
                            s.state[None],
                            np.asarray([s.last_token], dtype=np.int32))
                        results.append((st[0], int(tok[0])))
                    except Exception as exc:
                        results.append(exc)
        t_end = time.monotonic_ns()
        dt_ns = t_end - t0
        self._note_step_time(dt_ns)
        if _odyssey.ACTIVE:
            # cost attribution: each row owns 1/nb of this device step, and
            # its arena residency integrates against the same clock
            _odyssey.seq_step(running, dt_ns, t_end)
        emitted = 0
        kept: List[_Seq] = []
        for s, res in zip(running, results):
            if isinstance(res, Exception):
                _SEQ_FAILED.inc()
                sid = s.sid
                n = s.emitted
                _flight.emit(_flight.GEN_RETIRE, self._tag, sid, n)
                self._release_kv(s, cache=False)
                _odyssey.seq_done(s.led, "failed")
                s.q.put(res)
                continue
            st, tok = res
            if not self._paged:
                s.state = st
            self._emit_token(s, tok, t_end)
            emitted += 1
            if s.emitted >= s.max_tokens or self._hit_eos(tok):
                self._retire(s)
            else:
                kept.append(s)
        self._running = kept
        self.steps += 1
        self.rows_stepped += nb
        self.tokens_out += emitted
        _STEPS.inc()
        _TOKENS.inc(emitted)
        _STEP_BATCH.record(nb)
        _STEP_US.record(dt_ns // 1000)
        _flight.emit(_flight.GEN_STEP_END, self._tag, nb, emitted)

    # -- loop helpers ---------------------------------------------------------

    def _note_step_time(self, dt_ns: int) -> None:
        ms = dt_ns / 1e6
        self._step_roll.append(ms)
        a = 0.2
        self._step_ewma_ms = ms if self._step_ewma_ms == 0.0 else (
            (1 - a) * self._step_ewma_ms + a * ms)

    def _emit_token(self, s: _Seq, tok: int, now_ns: int = 0) -> None:
        s.last_token = tok
        s.emitted += 1
        if s.t_first_ns == 0:
            s.t_first_ns = now_ns or time.monotonic_ns()
            ttft_us = (s.t_first_ns - s.t_submit_ns) // 1000
            _TTFT_US.record(ttft_us)
            sid = s.sid
            _flight.emit(_flight.SEQ_FIRST_TOKEN, self._tag, sid, ttft_us)
            _odyssey.seq_first_token(s.led, ttft_us, s.t_first_ns)
        else:
            # the stream edge: the one per-token odyssey site (the step's
            # shared end stamp stands in for a clock read)
            _odyssey.seq_token(s.led, now_ns)
        s.q.put(tok)

    def _hit_eos(self, tok: int) -> bool:
        eos = getattr(self.model, "eos", None)
        return eos is not None and tok == eos

    def _retire(self, s: _Seq) -> None:
        sid = s.sid
        n = s.emitted
        _flight.emit(_flight.GEN_RETIRE, self._tag, sid, n)
        # natural finish: the prompt's block-aligned prefix is donated to
        # the prefix cache before the table frees
        self._release_kv(s, cache=True)
        _odyssey.seq_done(s.led, "retire")
        s.q.put(_DONE)


def health_lines() -> List[str]:
    """One ``gen`` line per live scheduler for /healthz: the shed and queue
    state an operator (or a balancer) reads during overload without the
    metrics plane."""
    out = []
    for s in list(_LIVE):
        try:
            if s._closed:
                continue
            out.append(
                f"gen {s.name}: state={s.state_str()} "
                f"running={s.running_depth()} waiting={s.queue_depth()} "
                f"swapped={s.swapped_depth()} steps={s.steps} "
                f"shed={s.shed_total} preempted={s.preempted_total}")
        except Exception:
            continue
    return sorted(out)
