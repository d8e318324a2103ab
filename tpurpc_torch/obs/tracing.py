"""Per-RPC span timelines with cross-process trace-context propagation.

A copy of ``tpurpc/obs/tracing.py``: the same header, wire encoding,
gates and environment. One RPC, one ``trace_id``; each recorded interval
is a span (``client-send``, ``wire``, ``dispatch``, ``respond``, ...)
carrying ``(trace_id, span_id, parent_id, name, t0, dur)``. The context
travels in call metadata under :data:`HEADER` (``"%016x-%08x-%d"``, 45
bytes with its key on the port's framed wire), so both packages read each
other's.

Near-free when off: the ONE module global :data:`LIVE` gates every
instrumented site. Head sampling is ``TPURPC_TRACE_SAMPLE=<rate 0..1>``
(default 0) or :func:`force` / :func:`configure`. Finished spans land in a
bounded ring (``TPURPC_TRACE_BUFFER``, default 4096), exported as a span
list, a tree (:func:`span_tree`) or Chrome ``trace_event`` JSON
(:func:`chrome_trace`).

**Tail capture** (default on; ``TPURPC_TRACE_TAIL=0`` opts out): every RPC
the sampler declined still gets a PROVISIONAL context (header flag ``2``)
whose spans wait in a bounded side buffer; :func:`tail_decide` commits
them iff the call was slow (over ``TPURPC_TRACE_TAIL_MS``, default 250, or
the method's rolling-p99 multiple from the stall watchdog), errored, or
was flagged by the watchdog (:func:`tail_flag`). So a sample rate of 0
still yields a span tree for every pathological call.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "HEADER", "ACTIVE", "LIVE", "TraceContext", "configure", "force",
    "tail", "maybe_sample", "current", "adopt", "use", "span", "begin",
    "finish", "record", "tail_decide", "tail_flag", "tail_pending",
    "spans", "span_tree", "chrome_trace", "clock_anchor", "reset",
]

#: metadata key the context rides in (text — works across the h2 plane's
#: ascii metadata and the native plane's char* arrays alike)
HEADER = "tpurpc-trace"

#: head-sampling gate (back-compat): True iff the sampler can fire
ACTIVE = False
#: the ONE fast gate instrumented sites load: sampling OR tail capture live
LIVE = False

_rate = 0.0
_forced: Optional[bool] = None
_tail: Optional[bool] = None  # None = env default (on)
_lock = threading.Lock()
#: cached per-call gates, recomputed by configure()/force()/tail() — the
#: env reads behind them cost microseconds and must never sit on the
#: per-RPC path (measured: _env twice per call ≈ 8 µs on a 60 µs RPC)
_TAIL_LIVE = False
_TAIL_STATIC_NS = 250_000_000


def _tail_default() -> bool:
    from tpurpc_torch.utils.config import _env

    return (_env("TPURPC_TRACE_TAIL") or "1").lower() not in (
        "0", "off", "false")


def _tail_on() -> bool:
    return _tail if _tail is not None else _tail_default()


def _buffer_cap() -> int:
    from tpurpc_torch.utils.config import _env

    raw = _env("TPURPC_TRACE_BUFFER") or ""
    try:
        return max(64, int(raw)) if raw else 4096
    except ValueError:
        return 4096


_spans: "deque" = deque(maxlen=_buffer_cap())
_tls = threading.local()
#: span-id allocator: sequential, not random — ids only need to be unique
#: within the bounded span buffer, and ``next()`` on a count is both
#: GIL-atomic and ~5x cheaper than getrandbits per span (the trace path
#: runs per sampled RPC; trace_ids stay random 64-bit).
_span_ids = itertools.count(1)


def _next_span_id() -> int:
    return next(_span_ids) & 0xFFFFFFFF


class TraceContext:
    """(trace_id, span_id, sampled, provisional) — what propagates.

    ``provisional`` marks a tail-capture context: spans route to the
    pending side buffer until :func:`tail_decide` commits or ages them out.
    On the wire the flag field carries ``2`` (old peers read it as
    "sampled", which merely over-records one call on a mixed fleet)."""

    __slots__ = ("trace_id", "span_id", "sampled", "provisional")

    def __init__(self, trace_id: int, span_id: int, sampled: bool = True,
                 provisional: bool = False):
        self.trace_id = trace_id & (1 << 64) - 1
        self.span_id = span_id & (1 << 32) - 1
        self.sampled = sampled
        self.provisional = provisional

    def encode(self) -> str:
        fl = 2 if self.provisional else int(self.sampled)
        return f"{self.trace_id:016x}-{self.span_id:08x}-{fl}"

    @staticmethod
    def decode(value) -> "Optional[TraceContext]":
        try:
            if isinstance(value, (bytes, bytearray, memoryview)):
                value = bytes(value).decode("ascii")
            t, s, fl = value.split("-")
            return TraceContext(int(t, 16), int(s, 16), fl != "0",
                                provisional=fl == "2")
        except (ValueError, AttributeError):
            return None  # malformed context: untraced, never an error

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _next_span_id(), self.sampled,
                            provisional=self.provisional)

    def __repr__(self) -> str:
        return f"<TraceContext {self.encode()}>"


def adopt(value) -> "Optional[TraceContext]":
    """Decode a wire context AND register tail-capture state: a provisional
    context arriving from a peer opens this process's pending buffer for
    the trace, so server-side spans join the same tail decision. The
    server planes use this instead of bare ``decode``."""
    ctx = TraceContext.decode(value)
    if ctx is not None and ctx.provisional:
        _tail_register(ctx.trace_id)
    return ctx


# -- sampling ----------------------------------------------------------------

def _recompute_gates() -> None:
    global ACTIVE, LIVE, _TAIL_LIVE, _TAIL_STATIC_NS
    ACTIVE = _forced if _forced is not None else _rate > 0.0
    _TAIL_LIVE = _forced is not False and _tail_on()
    LIVE = ACTIVE or _TAIL_LIVE
    from tpurpc_torch.utils.config import _env

    raw = _env("TPURPC_TRACE_TAIL_MS") or ""
    try:
        _TAIL_STATIC_NS = int(float(raw) * 1e6) if raw else int(
            _TAIL_MS_DEFAULT * 1e6)
    except ValueError:
        _TAIL_STATIC_NS = int(_TAIL_MS_DEFAULT * 1e6)


def configure(rate: Optional[float] = None) -> None:
    """Set the sampling rate (None = re-read ``TPURPC_TRACE_SAMPLE``)."""
    global _rate
    if rate is None:
        from tpurpc_torch.utils.config import _env

        raw = _env("TPURPC_TRACE_SAMPLE") or "0"
        try:
            rate = float(raw)
        except ValueError:
            rate = 0.0
    with _lock:
        _rate = min(1.0, max(0.0, rate))
        _recompute_gates()


def force(on: Optional[bool]) -> None:
    """Tests/bench: True samples every call, False disables everything
    (tail capture included — the bench's true-off leg), None returns
    control to the configured rate."""
    global _forced
    with _lock:
        _forced = on
        _recompute_gates()


def tail(on: Optional[bool]) -> None:
    """Enable/disable tail capture (None = re-read ``TPURPC_TRACE_TAIL``,
    whose default is ON — the blackbox contract)."""
    global _tail
    with _lock:
        _tail = on
        _recompute_gates()


def maybe_sample() -> Optional[TraceContext]:
    """Root decision for a new outgoing RPC: the ambient context if one is
    installed; a fresh COMMITTED root when the head sampler fires; a fresh
    PROVISIONAL root when tail capture is on (spans buffered, committed
    only if the call turns out pathological); else None."""
    if not LIVE:
        return None
    cur = getattr(_tls, "ctx", None)
    if cur is not None:
        return cur
    if ACTIVE and (_forced or random.random() < _rate):
        return TraceContext(random.getrandbits(64), _next_span_id())
    if _TAIL_LIVE:
        ctx = TraceContext(random.getrandbits(64), _next_span_id(),
                           provisional=True)
        _tail_register(ctx.trace_id)
        return ctx
    return None


# -- ambient context ---------------------------------------------------------

def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None) if LIVE else None


class use:
    """``with use(ctx):`` — install ``ctx`` as this thread's ambient trace
    context. A slotted class, not a generator contextmanager: this sits on
    the per-sampled-RPC path and the generator protocol costs ~3x."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


# -- recording ---------------------------------------------------------------
#
# A finished span is a plain 8-tuple — one allocation, no attribute churn:
#   (trace_id, span_id, parent_id, name, t0_ns, dur_ns, tid, attrs|None)
# The tuple shape is private; export (:func:`spans`) rebuilds dicts.
#
# Routing: spans of a PROVISIONAL trace go to its bounded pending list;
# spans of a committed (or never-registered, i.e. head-sampled) trace go
# straight to the main ring. One dict.get per span decides.

#: tail-capture side buffer: trace_id -> list of span tuples, or
#: _COMMITTED once tail_decide/tail_flag promoted the trace (late spans
#: then land in the main ring directly). Uncommitted traces simply AGE OUT
#: by insertion-order eviction — a "drop" needs no bookkeeping and can
#: never race a peer's commit.
_COMMITTED: list = []  # sentinel (identity compare)
_pending: "Dict[int, list]" = {}
_plock = threading.Lock()
_PENDING_TRACES = 512
_PENDING_SPANS = 96


def _tail_register(trace_id: int) -> None:
    if trace_id in _pending:
        return
    with _plock:
        if trace_id in _pending:
            return
        while len(_pending) >= _PENDING_TRACES:
            _pending.pop(next(iter(_pending)), None)  # evict oldest
        _pending[trace_id] = []


def _route_append(trace_id: int, tup: tuple) -> None:
    lst = _pending.get(trace_id)
    if lst is None or lst is _COMMITTED:
        _spans.append(tup)
    elif len(lst) < _PENDING_SPANS:
        lst.append(tup)


def record(name: str, ctx: Optional[TraceContext], t0_ns: int, dur_ns: int,
           **attrs) -> None:
    """Store one externally-timed span (the batcher stamps its own
    enqueue/dispatch/retire times)."""
    if ctx is None or not ctx.sampled:
        return
    _route_append(ctx.trace_id,
                  (ctx.trace_id, _next_span_id(), ctx.span_id, name, t0_ns,
                   max(0, dur_ns), threading.get_ident() & 0xFFFF,
                   attrs or None))


def begin(name: str, ctx: Optional[TraceContext]) -> Optional[list]:
    """Open-ended span for intervals that end on ANOTHER thread (the
    pipelined client's wire span ends on the reader). Pair with
    :func:`finish`."""
    if ctx is None or not ctx.sampled:
        return None
    return [ctx.trace_id, _next_span_id(), ctx.span_id, name,
            time.monotonic_ns(), -1, threading.get_ident() & 0xFFFF, None]


def finish(sp: Optional[list], **attrs) -> None:
    if sp is None:
        return
    sp[5] = time.monotonic_ns() - sp[4]
    if attrs:
        sp[7] = attrs
    _route_append(sp[0], tuple(sp))


class _NullSpan:
    """Shared stateless no-op context manager for the untraced path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()
#: shared reusable no-op context manager — instrumentation sites use it
#: instead of allocating a contextlib.nullcontext() per untraced call
NULL_CM = _NULL


class _SpanCtx:
    __slots__ = ("_name", "_ctx", "_attrs", "_t0")

    def __init__(self, name, ctx, attrs):
        self._name = name
        self._ctx = ctx
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.monotonic_ns()
        return self._ctx

    def __exit__(self, *exc):
        ctx = self._ctx
        _route_append(ctx.trace_id,
                      (ctx.trace_id, _next_span_id(), ctx.span_id,
                       self._name, self._t0,
                       time.monotonic_ns() - self._t0,
                       threading.get_ident() & 0xFFFF, self._attrs))
        return False


def span(name: str, ctx: Optional[TraceContext] = None, **attrs):
    """``with span("infer"):`` — records when the (ambient or given)
    context is sampled; a shared no-op otherwise. Spans parent to ``ctx``
    itself (no ambient reinstall: body code that captures
    :func:`current` sees the call's context, and the per-span TLS churn
    stays off the sampled hot path)."""
    if not LIVE:
        return _NULL
    ctx = ctx if ctx is not None else current()
    if ctx is None or not ctx.sampled:
        return _NULL
    return _SpanCtx(name, ctx, attrs or None)


# -- tail-capture decisions ---------------------------------------------------

_TAIL_MS_DEFAULT = 250.0


def _tail_threshold_ns(method: Optional[str]) -> int:
    """The slow bar: the static ``TPURPC_TRACE_TAIL_MS`` floor (cached —
    re-read on configure()/tail()), tightened by the method's rolling-p99
    multiple when the stall watchdog has one (so a 2 ms method's 50 ms
    outlier is captured even far under the static bar)."""
    static_ns = _TAIL_STATIC_NS
    if method is not None:
        try:
            from tpurpc_torch.obs import watchdog as _wd

            p99_mult = _wd.get().slow_threshold_ns(method)
            if p99_mult is not None:
                return min(static_ns, p99_mult)
        except Exception:
            pass
    return static_ns


def tail_commit(trace_id: int) -> None:
    """Promote a provisional trace's buffered spans into the main ring;
    later spans for the trace land there directly."""
    with _plock:
        lst = _pending.get(trace_id)
        if lst is _COMMITTED:
            return
        if lst:
            _spans.extend(lst)
        if trace_id not in _pending:
            while len(_pending) >= _PENDING_TRACES:
                _pending.pop(next(iter(_pending)), None)
        _pending[trace_id] = _COMMITTED


#: watchdog face: flag a wedged call's trace for capture while it is STILL
#: in flight — the spans recorded so far surface immediately on /traces
tail_flag = tail_commit


def tail_decide(ctx: Optional[TraceContext], dur_ns: int,
                error: bool = False, method: Optional[str] = None) -> bool:
    """The tail-sampling decision, called where an RPC completes: commit
    the provisional trace iff the call errored or was slow (static
    threshold or method-p99 multiple). Returns True when the trace is
    committed (callers may then record post-hoc spans). No-op for
    non-provisional contexts — head-sampled spans are already in the
    ring."""
    if ctx is None or not getattr(ctx, "provisional", False):
        return False
    if _pending.get(ctx.trace_id) is _COMMITTED:
        return True
    if error or dur_ns >= _tail_threshold_ns(method):
        tail_commit(ctx.trace_id)
        return True
    return False


def tail_pending(trace_id: Optional[int] = None) -> int:
    """Observability of the buffer itself (tests, /debug): the number of
    pending (uncommitted) traces, or one trace's buffered span count."""
    if trace_id is None:
        return sum(1 for v in _pending.values() if v is not _COMMITTED)
    lst = _pending.get(trace_id)
    return len(lst) if isinstance(lst, list) and lst is not _COMMITTED else 0


# -- export ------------------------------------------------------------------

def spans(trace_id: "Optional[int | str]" = None) -> List[Dict]:
    """Finished spans (oldest first), optionally filtered by trace id
    (int or 16-hex-digit string)."""
    if isinstance(trace_id, str):
        trace_id = int(trace_id, 16)
    out = []
    for (tid64, sid, pid, name, t0, dur, tid, attrs) in list(_spans):
        if trace_id is not None and tid64 != trace_id:
            continue
        d = {"trace_id": f"{tid64:016x}", "span_id": sid, "parent_id": pid,
             "name": name, "t0_ns": t0, "dur_ns": dur, "tid": tid}
        if attrs:
            d["attrs"] = attrs
        out.append(d)
    out.sort(key=lambda d: d["t0_ns"])
    return out


def span_tree(trace_id: "int | str") -> Dict:
    """One trace as a nested tree: ``{"trace_id", "spans": [roots]}``,
    each node ``{"name", "t0_ns", "dur_ns", "children": [...]}`` —
    the plain-dict export the acceptance tests assert on."""
    flat = spans(trace_id)
    by_id = {}
    for d in flat:
        by_id[d["span_id"]] = dict(d, children=[])
    roots = []
    for d in flat:
        node = by_id[d["span_id"]]
        parent = by_id.get(d["parent_id"])
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    tid = flat[0]["trace_id"] if flat else (
        f"{int(trace_id, 16):016x}" if isinstance(trace_id, str)
        else f"{trace_id:016x}")
    return {"trace_id": tid, "spans": roots}


def clock_anchor() -> Dict:
    """This process's monotonic↔wallclock anchor.

    Span/flight timestamps are ``time.monotonic_ns`` — correct for
    durations, but each process has its OWN monotonic epoch, so traces
    exported by different processes (shard workers, fleet members) cannot
    be merged by raw ``ts``. The anchor is one simultaneous reading of both
    clocks: a collector rebases any monotonic stamp from this process onto
    the shared wall clock as ``wall = t_mono - mono_ns + wall_ns``. The
    wall read is bracketed by two monotonic reads and paired with their
    midpoint, bounding the skew to half the bracket width."""
    import os

    m0 = time.monotonic_ns()
    wall = time.time_ns()  # the anchor IS absolute (time_ns, not time())
    m1 = time.monotonic_ns()
    return {"pid": os.getpid(), "mono_ns": (m0 + m1) // 2, "wall_ns": wall,
            "uncertainty_ns": m1 - m0}


def chrome_trace(trace_id: "Optional[int | str]" = None) -> Dict:
    """Chrome ``trace_event`` JSON (perfetto / chrome://tracing): complete
    ("X") events with microsecond timestamps, one row per recording
    thread, plus the ``process_name``/``thread_name`` metadata ("M")
    events — without them perfetto renders bare pid/tid numbers instead of
    named lanes. Span attrs pass through as ``args``.

    The top-level ``clock_anchor`` (chrome-trace tolerates extra keys) is
    this process's monotonic↔wall pairing, which aligns traces exported by
    different processes onto one wall-clock axis (see
    :func:`clock_anchor`)."""
    events: List[Dict] = [{
        "ph": "M", "name": "process_name", "pid": 1, "tid": 0,
        "args": {"name": "tpurpc"},
    }]
    named_tids = set()
    for d in spans(trace_id):
        tid = d["tid"]
        if tid not in named_tids:
            named_tids.add(tid)
            events.append({
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                "args": {"name": f"tpurpc-thread-{tid:#x}"},
            })
        events.append({
            "ph": "X",
            "name": d["name"],
            "cat": "tpurpc",
            "ts": d["t0_ns"] / 1e3,
            "dur": max(d["dur_ns"], 0) / 1e3,
            "pid": 1,
            "tid": tid,
            "args": dict(d.get("attrs") or {},
                         trace_id=d["trace_id"],
                         span_id=d["span_id"]),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "clock_anchor": clock_anchor()}


def reset() -> None:
    _spans.clear()
    with _plock:
        _pending.clear()


configure()
