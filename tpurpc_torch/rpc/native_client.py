"""Python binding over the native C client: the latency fast path.

The port's copy of the reference's ``rpc/native_client.py``. The default
channel is pure Python (LB trees, retries, interceptors, h2 interop); this
module is the thin ctypes alternative for latency-critical clients: the
blocking call path runs inside the port's native library
(``tpurpc_torch/core/_native.py`` builds it from ``tpurpc_torch/native/``
at first use; one GIL release per call, no Python-level framing), and it
honors ``GRPC_PLATFORM_TYPE``: with ``RDMA_BP|BPEV|EVENT`` the native
channel bootstraps the shm ring data plane (``ring_transport.h``).

    from tpurpc_torch.rpc.native_client import NativeChannel
    with NativeChannel("127.0.0.1", port) as ch:
        echo = ch.unary_unary("/pkg.Svc/Echo")
        reply = echo(b"payload", timeout=5.0)

Scope: unary and streaming calls, deadlines, status mapping, ping,
``.future()`` over the completion queue (``_CqDriver``) or, on
inline-read channels, a bounded worker window (``_InlineWindow``), and the
process-wide rendezvous ledger (:func:`rdv_counters`). Not here (use the
default Channel): LB policies, retries, interceptors, TLS, h2 wire compat.
A reply comes back as ``bytes`` (a copy out of the C buffer), which
``torch.frombuffer`` reads without another copy.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Callable, Iterable, Optional

from tpurpc_torch.core import _native
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.rpc.status import RpcError, StatusCode

_LIB = None
_LIB_LOCK = threading.Lock()


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        # the ring loader's path and first-use build; this handle is a
        # CDLL, so its calls release the GIL
        path = _native._lib_path()
        if not os.path.exists(path):
            _native._try_build(path)
        lib = ctypes.CDLL(path)
        lib.tpr_channel_create.restype = ctypes.c_void_p
        lib.tpr_channel_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                           ctypes.c_int]
        if hasattr(lib, "tpr_channel_create2"):  # absent in pre-round-4 .so
            lib.tpr_channel_create2.restype = ctypes.c_void_p
            lib.tpr_channel_create2.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.tpr_channel_destroy.argtypes = [ctypes.c_void_p]
        lib.tpr_channel_ping.restype = ctypes.c_int64
        lib.tpr_channel_ping.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tpr_unary_call.restype = ctypes.c_int
        lib.tpr_unary_call.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        if hasattr(lib, "tpr_unary_call_ex"):  # absent in pre-round-5 .so
            lib.tpr_unary_call_ex.restype = ctypes.c_int
            lib.tpr_unary_call_ex.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
        lib.tpr_call_start.restype = ctypes.c_void_p
        lib.tpr_call_start.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_size_t, ctypes.c_int]
        lib.tpr_call_send.restype = ctypes.c_int
        lib.tpr_call_send.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_size_t, ctypes.c_int]
        lib.tpr_call_writes_done.restype = ctypes.c_int
        lib.tpr_call_writes_done.argtypes = [ctypes.c_void_p]
        lib.tpr_call_recv.restype = ctypes.c_int
        lib.tpr_call_recv.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.tpr_call_finish.restype = ctypes.c_int
        lib.tpr_call_finish.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_size_t]
        lib.tpr_call_cancel.argtypes = [ctypes.c_void_p]
        lib.tpr_call_destroy.argtypes = [ctypes.c_void_p]
        lib.tpr_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        # completion-queue async surface (futures fast path)
        lib.tpr_cq_create.restype = ctypes.c_void_p
        lib.tpr_cq_create.argtypes = []
        lib.tpr_cq_next.restype = ctypes.c_int
        lib.tpr_cq_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(_TprEvent), ctypes.c_int]
        lib.tpr_cq_shutdown.argtypes = [ctypes.c_void_p]
        lib.tpr_cq_destroy.argtypes = [ctypes.c_void_p]
        lib.tpr_unary_call_cq.restype = ctypes.c_void_p
        lib.tpr_unary_call_cq.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        # zero-copy send lease (the reference's SendZerocopy shape): gather
        # segments serialize DIRECTLY into the transport ring — the staging
        # join and the ctypes from_buffer_copy both disappear. Optional: a
        # pre-round-5 .so has no lease entry points.
        try:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.tpr_call_send_reserve2.restype = ctypes.c_int
            lib.tpr_call_send_reserve2.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t)]
            lib.tpr_call_send_commit.restype = ctypes.c_int
            lib.tpr_call_send_commit.argtypes = [ctypes.c_void_p]
            lib.tpr_call_send_abort.restype = ctypes.c_int
            lib.tpr_call_send_abort.argtypes = [ctypes.c_void_p]
            lib._tpr_has_lease = True
        except AttributeError:  # pre-round-6 .so: no fragment-aware lease
            lib._tpr_has_lease = False
        # rendezvous/ctrl-ring ledger (absent in a pre-ironclad .so)
        if hasattr(lib, "tpr_rdv_counters"):
            lib.tpr_rdv_counters.restype = None
            lib.tpr_rdv_counters.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
            lib.tpr_rdv_counters_reset.restype = None
            lib.tpr_rdv_counters_reset.argtypes = []
        _LIB = lib
        return lib


#: native rdv ledger slot names, in the library's CounterIdx ABI order
#: (native/src/tpr_rdv.h) — index position IS the contract
RDV_COUNTER_NAMES = (
    "rdv_sent", "rdv_recv", "rdv_fallback", "rdv_bytes_sent",
    "rdv_bytes_recv", "rdv_refused", "ctrl_posts", "ctrl_kicks",
    "ctrl_records", "ctrl_frames", "host_copy_bytes", "pregrants")


def rdv_counters() -> Optional[dict]:
    """Process-wide native rendezvous/ctrl-ring ledger as a name→count
    dict, or None when the loaded .so predates the rendezvous plane."""
    lib = _load()
    if not hasattr(lib, "tpr_rdv_counters"):
        return None
    buf = (ctypes.c_uint64 * len(RDV_COUNTER_NAMES))()
    lib.tpr_rdv_counters(buf, len(RDV_COUNTER_NAMES))
    return dict(zip(RDV_COUNTER_NAMES, buf))


def rdv_counters_reset() -> bool:
    """Zero the native rdv ledger (test/bench isolation). False when the
    loaded .so has no rendezvous plane."""
    lib = _load()
    if not hasattr(lib, "tpr_rdv_counters_reset"):
        return False
    lib.tpr_rdv_counters_reset()
    return True


class _TprEvent(ctypes.Structure):
    """Mirror of tpr_event (tpurpc_torch/native/include/tpurpc/client.h)."""

    _fields_ = [("type", ctypes.c_int),
                ("tag", ctypes.c_void_p),
                ("ok", ctypes.c_int),
                ("data", ctypes.POINTER(ctypes.c_uint8)),
                ("len", ctypes.c_size_t),
                ("status", ctypes.c_int),
                ("details", ctypes.c_char * 256)]


_EV_FINISH = 2  # TPR_EV_FINISH


def _u8(data) -> "ctypes.Array":
    # serializers may emit a gather list of segments (the tensor codec
    # does); the C API takes one buffer, so join — one copy, same price
    # the TLS path pays
    if isinstance(data, (list, tuple)):
        data = b"".join(data)
    view = memoryview(data).cast("B")
    return (ctypes.c_uint8 * len(view)).from_buffer_copy(view)


def _u8_zc(data) -> "tuple":
    """(pointer-arg, nbytes) for a synchronous C call, zero-copy where the
    buffer allows it: ``bytes`` pass their own internal buffer via a
    ``c_char_p`` cast (immutable + referenced by the caller's local for
    the whole call, so the pointer stays valid with the GIL released).
    The ``from_buffer_copy`` staging array was a WHOLE EXTRA PASS over
    every bulk payload — measured ~0.3 ms per 4 MiB message, the single
    biggest native-vs-python plane gap. Non-bytes fall back to the
    staging copy. Only safe for entry points that consume the buffer
    before returning (send/unary paths do: the rdv memcpy or the ring
    write happens inside the call)."""
    if isinstance(data, (list, tuple)):
        data = b"".join(data)
    if isinstance(data, bytes):
        return (ctypes.cast(ctypes.c_char_p(data),
                            ctypes.POINTER(ctypes.c_uint8)), len(data))
    buf = _u8(data)
    return buf, len(buf)


def _timeout_ms(timeout: Optional[float]) -> int:
    if timeout is None:
        return 0
    return max(1, int(timeout * 1000))


def _take_buf(lib, pptr, plen) -> bytes:
    try:
        return ctypes.string_at(pptr, plen.value) if plen.value else b""
    finally:
        if pptr:
            lib.tpr_buf_free(pptr)


class NativeCall:
    """A streaming call handle (thin ClientCall analog)."""

    def __init__(self, lib, call, on_close: Optional[Callable] = None):
        self._lib = lib
        self._call = call
        self._lock = threading.Lock()
        self._on_close = on_close  # NativeChannel op release (exactly once)

    #: lease path cut-in: below this a join+send is as cheap as the
    #: reserve/commit round trips, and control-plane messages stay on the
    #: battle-tested classic path
    _LEASE_MIN = 64 * 1024
    #: one ring message per frame — kMaxFramePayload (framing_common.h)
    _LEASE_FRAME = 1 << 20

    def write(self, data, end_stream: bool = False) -> None:
        if (getattr(self._lib, "_tpr_has_lease", False)
                and isinstance(data, (list, tuple))):
            segs = [v for v in (memoryview(s).cast("B") for s in data)
                    if len(v)]
            total = sum(len(v) for v in segs)
            if total >= self._LEASE_MIN and self._write_lease(
                    segs, total, end_stream):
                return
        buf, blen = _u8_zc(data)  # `data` local keeps the buffer alive
        if self._lib.tpr_call_send(self._call, buf, blen,
                                   1 if end_stream else 0) != 0:
            raise RpcError(StatusCode.UNAVAILABLE, "send failed")

    def _write_lease(self, segs, total: int, end_stream: bool) -> bool:
        """Gather ``segs`` straight into the transport ring via the
        zero-copy send lease (tpr_call_send_reserve/commit): one
        frame-sized reserve per ≤1 MiB chunk, segments copied in place
        with memoryview slice assignment, commit publishes. Returns False
        with NO bytes sent when the channel has no ring (first reserve
        fails — the classic path handles it); raises on a mid-message
        failure (the channel died; nothing can be un-sent)."""
        lib = self._lib
        p1 = ctypes.POINTER(ctypes.c_uint8)()
        l1 = ctypes.c_size_t()
        p2 = ctypes.POINTER(ctypes.c_uint8)()
        l2 = ctypes.c_size_t()
        sent = 0
        si = 0  # segment cursor
        so = 0  # offset within segs[si]
        # tpurpc-blackbox: the lease lifecycle in the flight ring — an
        # unmatched reserve in the tail is the watchdog's smoking gun for
        # a wedged ring write lock (the round-5 bug class, now observable)
        ftag = _flight.tag_for("nclease")
        while sent < total:
            n = min(total - sent, self._LEASE_FRAME)
            last = sent + n == total
            # non-final fragments carry MORE so the peer reassembles ONE
            # message; END_STREAM only ever rides the final fragment
            flags = (1 if end_stream else 0) if last else 2
            if lib.tpr_call_send_reserve2(
                    self._call, n, flags,
                    ctypes.byref(p1), ctypes.byref(l1),
                    ctypes.byref(p2), ctypes.byref(l2)) != 0:
                if sent == 0:
                    return False  # no ring under this channel: classic path
                raise RpcError(StatusCode.UNAVAILABLE, "send failed")
            try:
                _flight.emit(_flight.LEASE_RESERVE, ftag, n)
                # ≤2 wrap-split ring spans; fill from the segment stream
                for ptr, ln in ((p1, l1.value), (p2, l2.value)):
                    if not ln:
                        continue
                    dst = memoryview(ctypes.cast(
                        ptr, ctypes.POINTER(ctypes.c_uint8 * ln)).contents
                    ).cast("B")
                    off = 0
                    while off < ln:
                        seg = segs[si]
                        take = min(len(seg) - so, ln - off)
                        dst[off:off + take] = seg[so:so + take]
                        off += take
                        so += take
                        if so == len(seg):
                            si += 1
                            so = 0
            except BaseException:
                lib.tpr_call_send_abort(self._call)  # release write_mu
                _flight.emit(_flight.LEASE_ABORT, ftag, n)
                raise
            if lib.tpr_call_send_commit(self._call) != 0:
                _flight.emit(_flight.LEASE_ABORT, ftag, n)
                raise RpcError(StatusCode.UNAVAILABLE, "send failed")
            _flight.emit(_flight.LEASE_COMMIT, ftag, n)
            sent += n
        return True

    def writes_done(self) -> None:
        self._lib.tpr_call_writes_done(self._call)

    def read(self) -> Optional[bytes]:
        """Next response message, or None at end of stream/error
        (finish() distinguishes)."""
        pptr = ctypes.POINTER(ctypes.c_uint8)()
        plen = ctypes.c_size_t()
        r = self._lib.tpr_call_recv(self._call,
                                    ctypes.byref(pptr), ctypes.byref(plen))
        if r != 1:
            return None
        return _take_buf(self._lib, pptr, plen)

    def finish(self):
        details = ctypes.create_string_buffer(1024)
        code = self._lib.tpr_call_finish(self._call, details, 1024)
        return (StatusCode(code) if code in StatusCode._value2member_map_
                else StatusCode.UNKNOWN), details.value.decode(
                    "utf-8", "replace")

    def cancel(self) -> None:
        self._lib.tpr_call_cancel(self._call)

    def close(self) -> None:
        cb = None
        with self._lock:
            if self._call:
                self._lib.tpr_call_destroy(self._call)
                self._call = None
                cb, self._on_close = self._on_close, None
        if cb is not None:
            cb()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _CqDriver:
    """One completion queue + puller thread per channel: resolves
    ``unary.future()`` calls from tagged TPR_EV_FINISH completions — the
    grpcio ``.future()`` shape over the native CQ async API, so a Python
    client can keep many unary calls in flight on one connection."""

    def __init__(self, lib):
        import concurrent.futures  # stdlib Future is the contract

        self._lib = lib
        self._Future = concurrent.futures.Future
        self._cq = lib.tpr_cq_create()
        self._lock = threading.Lock()
        # tag -> entry {fut, call, des, done}; `call` is filled right after
        # tpr_unary_call_cq returns — the completion can race that store,
        # so whoever sees both `done` and `call` performs the destroy.
        self._pending: dict = {}
        self._next_tag = 1
        self._thread = threading.Thread(target=self._pull, daemon=True,
                                        name="tpurpc-native-cq")
        self._thread.start()

    def submit(self, ch, method_b: bytes, raw, timeout,
               deserializer) -> "concurrent.futures.Future":
        # before registering: a bad serializer output must not leak a
        # pending entry (close would stall); zero-copy — tpr_unary_call_cq
        # consumes the request buffer before it returns
        buf, blen = _u8_zc(raw)
        fut = self._Future()
        with self._lock:
            tag = self._next_tag
            self._next_tag += 1
            entry = {"fut": fut, "call": None, "des": deserializer,
                     "done": False}
            self._pending[tag] = entry
        call = self._lib.tpr_unary_call_cq(ch, method_b, buf, blen,
                                           _timeout_ms(timeout), self._cq,
                                           ctypes.c_void_p(tag))
        if not call:
            with self._lock:
                self._pending.pop(tag, None)
            exc = RpcError(StatusCode.UNAVAILABLE,
                           "call refused (channel dead or draining)")
            exc._tpurpc_preexec = True  # admission refusal: nothing sent
            raise exc
        destroy = None
        with self._lock:
            entry["call"] = call
            if entry["done"]:  # completion won the race; we own the destroy
                destroy = call
                self._pending.pop(tag, None)
        if destroy:
            self._lib.tpr_call_destroy(destroy)
        return fut

    def _pull(self):
        ev = _TprEvent()
        while True:
            rc = self._lib.tpr_cq_next(self._cq, ctypes.byref(ev), 1000)
            if rc == -1:
                return  # shut down and drained
            if rc != 1 or ev.type != _EV_FINISH:
                continue
            tag = ev.tag or 0
            body = b""
            if ev.data:
                body = ctypes.string_at(ev.data, ev.len) if ev.len else b""
                self._lib.tpr_buf_free(ev.data)
            destroy = None
            with self._lock:
                entry = self._pending.get(tag)
                if entry is None:
                    continue
                entry["done"] = True
                if entry["call"]:
                    destroy = entry["call"]
                    self._pending.pop(tag, None)
                # else: submit() still holds the race; it destroys
            if destroy:
                self._lib.tpr_call_destroy(destroy)
            fut, des = entry["fut"], entry["des"]
            if not fut.set_running_or_notify_cancel():
                continue  # user cancelled the Future; drop the result
            if ev.status == 0:
                try:
                    fut.set_result(des(body) if des else body)
                except Exception as exc:  # deserializer raised
                    fut.set_exception(exc)
            else:
                code = (StatusCode(ev.status)
                        if ev.status in StatusCode._value2member_map_
                        else StatusCode.UNKNOWN)
                fut.set_exception(RpcError(
                    code, ev.details.decode("utf-8", "replace")))

    def close(self, cancel_inflight: bool = True) -> bool:
        """Cancel in-flight calls, drain their completions, stop the
        puller, free the queue. Must run BEFORE tpr_channel_destroy —
        destroying a call touches its channel.

        Returns True iff teardown was CLEAN: every pending call drained
        (so its tpr_call_destroy already ran) and the puller thread
        exited. On False the caller must NOT destroy the channel — a
        starved puller (e.g. a slow user deserializer runs on this
        thread for sync .future() calls) may still call
        tpr_call_destroy on calls whose channel would then be freed."""
        if cancel_inflight:
            # Cancel UNDER the lock: the puller pops an entry (and later
            # destroys its call) while holding it, so a call still present
            # in _pending here cannot concurrently be freed under us.
            with self._lock:
                for e in self._pending.values():
                    if e["call"] and not e["done"]:
                        self._lib.tpr_call_cancel(e["call"])
        deadline = time.monotonic() + 10.0
        drained = False
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending:
                    drained = True
                    break
            time.sleep(0.01)
        self._lib.tpr_cq_shutdown(self._cq)
        self._thread.join(timeout=10.0)
        if not self._thread.is_alive():
            if not drained:
                # tpr_cq_next keeps draining queued events after shutdown,
                # so a slow (but finite) deserializer may have finished the
                # backlog between the drain-wait timeout and the join —
                # re-check rather than return the stale snapshot (which
                # would leak the channel for nothing).
                with self._lock:
                    drained = not self._pending
            self._lib.tpr_cq_destroy(self._cq)
            return drained
        # else: leak the cq — a wedged puller beats a use-after-free
        return False


class _InlineWindow:
    """Bounded multi-in-flight window for INLINE-READ channels, where the
    CQ async surface refuses (``tpr_unary_call_cq`` needs the reader
    thread). ``depth`` persistent daemon workers issue the blocking C calls
    — the native loop multiplexes concurrent streams on one connection
    (each blocking caller pumps or parks on the channel's cv), so this is
    genuine wire pipelining, not thread-per-call churn: the worker set is
    fixed and the depth+1'th submit blocks (window backpressure)."""

    def __init__(self, depth: int):
        import concurrent.futures
        import queue as _queue

        self._Future = concurrent.futures.Future
        self._jobs: "_queue.Queue" = _queue.Queue()
        self._depth = max(1, depth)
        self._window = threading.BoundedSemaphore(self._depth)
        self._workers = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"tpurpc-native-inline-{i}")
            for i in range(self._depth)]
        for w in self._workers:
            w.start()

    def submit(self, call_fn, request, timeout):
        self._window.acquire()  # backpressure: at most depth in flight
        fut = self._Future()
        self._jobs.put((call_fn, request, timeout, fut))
        return fut

    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            call_fn, request, timeout, fut = job
            try:
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(call_fn(request, timeout))
                except BaseException as exc:
                    fut.set_exception(exc)
            finally:
                self._window.release()

    def close(self) -> None:
        for _ in self._workers:
            self._jobs.put(None)


class NativeChannel:
    """ctypes channel over the native client loop (see module docstring)."""

    def __init__(self, host: str, port: int, connect_timeout: float = 10.0,
                 inline_read: bool = False, pipeline_depth: int = 16):
        self._lib = _load()
        self._cq_driver: Optional[_CqDriver] = None
        self._cq_lock = threading.Lock()
        self._cq_cond = threading.Condition(self._cq_lock)
        #: in-flight bound for .future() calls on inline-read channels
        #: (reader-thread channels bound in the C CQ instead)
        self._pipeline_depth = max(1, pipeline_depth)
        self._inline_window: Optional[_InlineWindow] = None
        #: native entries currently holding the raw channel pointer inside
        #: libtpurpc (blocking unary calls, pings, live NativeCall handles).
        #: close() must not tpr_channel_destroy until this drains — a call
        #: completing on another thread touches ch->streams in
        #: tpr_call_destroy (ASan-caught use-after-free, round 4).
        self._ops = 0
        # inline_read: the per-channel inline-read discipline (blocking
        # callers pump the ring; no reader thread — the lowest-latency
        # mode). The CQ async API (.future()) refuses on such channels.
        # inline_read=False takes tpr_channel_create, which OWNS the
        # TPURPC_NATIVE_INLINE_READ env default — one copy of that rule,
        # in C; the explicit flag needs create2 (older .so: fall back to
        # the env-defaulted entry rather than crash on version skew).
        if inline_read and hasattr(self._lib, "tpr_channel_create2"):
            self._ch = self._lib.tpr_channel_create2(
                host.encode(), int(port), _timeout_ms(connect_timeout), 1)
            #: what was ACTUALLY requested of the C loop (observability:
            #: bench artifacts record the discipline; the old-.so fallback
            #: below reports False even when inline was asked for)
            self.inline_read = True
        else:
            self._ch = self._lib.tpr_channel_create(
                host.encode(), int(port), _timeout_ms(connect_timeout))
            self.inline_read = False
        if not self._ch:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"native connect to {host}:{port} failed")

    def _driver(self) -> _CqDriver:
        with self._cq_lock:
            if not self._ch:  # close() swaps _ch under this same lock, so a
                # late future() can't resurrect a CQ puller nothing will close
                exc = RpcError(StatusCode.UNAVAILABLE, "channel closed")
                exc._tpurpc_preexec = True
                raise exc
            if self._cq_driver is None:
                self._cq_driver = _CqDriver(self._lib)
            return self._cq_driver

    def _window(self) -> _InlineWindow:
        with self._cq_lock:
            if not self._ch:
                exc = RpcError(StatusCode.UNAVAILABLE, "channel closed")
                exc._tpurpc_preexec = True
                raise exc
            if self._inline_window is None:
                self._inline_window = _InlineWindow(self._pipeline_depth)
            return self._inline_window

    def _op_begin(self):
        """Claim the channel pointer for a native entry. The claim (not a
        bare pointer read) is what lets close() prove no other thread is
        inside the C loop before freeing the channel."""
        with self._cq_lock:
            if not self._ch:
                exc = RpcError(StatusCode.UNAVAILABLE, "channel closed")
                exc._tpurpc_preexec = True  # nothing entered the C loop
                raise exc
            self._ops += 1
            return self._ch

    def _op_end(self) -> None:
        with self._cq_cond:
            self._ops -= 1
            if self._ops == 0:
                self._cq_cond.notify_all()

    def _handle(self):
        """The live native handle; raises (instead of passing a freed/NULL
        pointer into C and segfaulting) once close() ran. For entries that
        BLOCK inside the C loop use _op_begin/_op_end instead, so close()
        can wait them out."""
        ch = self._ch
        if not ch:
            raise RpcError(StatusCode.UNAVAILABLE, "channel closed")
        return ch

    # -- surface -------------------------------------------------------------

    def ping(self, timeout: float = 5.0) -> float:
        ch = self._op_begin()
        try:
            us = self._lib.tpr_channel_ping(ch, _timeout_ms(timeout))
        finally:
            self._op_end()
        if us < 0:
            raise RpcError(StatusCode.UNAVAILABLE, "ping failed")
        return us / 1e6

    def unary_unary(self, method: str,
                    request_serializer: Optional[Callable] = None,
                    response_deserializer: Optional[Callable] = None):
        mb = method.encode()
        lib = self._lib

        have_ex = hasattr(lib, "tpr_unary_call_ex")

        def call(request, timeout: Optional[float] = None):
            raw = (request_serializer(request) if request_serializer
                   else request)
            buf, blen = _u8_zc(raw)  # synchronous call: `buf` holds a ref
            pptr = ctypes.POINTER(ctypes.c_uint8)()
            plen = ctypes.c_size_t()
            details = ctypes.create_string_buffer(1024)
            preexec = ctypes.c_int(0)
            ch = self._op_begin()  # a closed channel raises; close() waits
            try:
                if have_ex:
                    code = lib.tpr_unary_call_ex(
                        ch, mb, buf, blen,
                        ctypes.byref(pptr), ctypes.byref(plen),
                        details, 1024, _timeout_ms(timeout),
                        ctypes.byref(preexec))
                else:
                    code = lib.tpr_unary_call(
                        ch, mb, buf, blen,
                        ctypes.byref(pptr), ctypes.byref(plen),
                        details, 1024, _timeout_ms(timeout))
            finally:
                self._op_end()
            if code != 0:
                text = details.value.decode("utf-8", "replace")
                exc = RpcError(
                    StatusCode(code) if code in StatusCode._value2member_map_
                    else StatusCode.UNKNOWN, text)
                # Machine-readable replay-safety verdict from the C loop
                # (tpr_unary_call_ex): True iff the failure provably
                # happened before the request fully left this process, so
                # replaying it can never double-execute a handler. Channel
                # consumers gate fallback on this attribute, never on the
                # human-readable details wording. Legacy shim: a
                # pre-round-5 .so has no preexec out-param, so its known
                # pre-exec wordings (tpr_unary_call's three early returns)
                # are the only signal left.
                exc._tpurpc_preexec = bool(preexec.value) if have_ex else any(
                    s in text for s in ("channel dead", "send failed"))
                raise exc
            body = _take_buf(lib, pptr, plen)
            return (response_deserializer(body) if response_deserializer
                    else body)

        def future(request, timeout: Optional[float] = None):
            """grpcio's ``.future()`` shape: returns a concurrent.futures
            .Future resolving to the response (or raising RpcError), with
            the call pipelined through the channel's completion queue —
            many can be in flight at once on one connection. On
            INLINE-READ channels (no reader thread, so no CQ) the same
            multi-in-flight contract rides a bounded worker window over
            the blocking entry: the C loop multiplexes the concurrent
            streams on the one connection either way."""
            if self.inline_read:
                return self._window().submit(call, request, timeout)
            raw = (request_serializer(request) if request_serializer
                   else request)
            drv = self._driver()
            ch = self._op_begin()  # guard the submit window; the call's
            try:                   # lifetime after that is the CQ puller's
                return drv.submit(ch, mb, raw, timeout,
                                  response_deserializer)
            finally:
                self._op_end()

        call.future = future
        return call

    def start_call(self, method: str, timeout: Optional[float] = None,
                   metadata=None) -> NativeCall:
        """Start a streaming call. ``metadata`` is an optional list of
        ``(key, value)`` text pairs shipped through ``tpr_call_start``'s
        flat ``k,v,k,v`` array — the seam the tpurpc-scope trace context
        (``tpurpc-trace``) rides on the native plane."""
        md_arr, n_md = None, 0
        if metadata:
            flat = []
            for k, v in metadata:
                flat.append(str(k).encode())
                flat.append(v if isinstance(v, bytes) else str(v).encode())
            md_arr = (ctypes.c_char_p * len(flat))(*flat)
            n_md = len(metadata)
        ch = self._op_begin()  # held for the NativeCall's whole lifetime:
        try:                   # its tpr_call_* entries all touch the channel
            c = self._lib.tpr_call_start(ch, method.encode(), md_arr,
                                         n_md, _timeout_ms(timeout))
            if not c:
                raise RpcError(StatusCode.UNAVAILABLE, "call start failed")
            return NativeCall(self._lib, c, on_close=self._op_end)
        except BaseException:
            self._op_end()
            raise

    def stream_stream(self, method: str):
        """Bidi helper with the Channel-compatible iterator shape."""

        def call(request_iterator: Iterable, timeout: Optional[float] = None):
            nc = self.start_call(method, timeout)
            app_exc: list = []

            def run():
                try:
                    for item in request_iterator:
                        nc.write(item)
                    nc.writes_done()
                except RpcError:
                    pass  # reader surfaces the status
                except BaseException as exc:  # the app's iterator raised:
                    # half-close never happens — cancel so the reader (and
                    # the server's handler) unblock, and surface the error
                    app_exc.append(exc)
                    nc.cancel()

            t = threading.Thread(target=run, daemon=True)
            t.start()
            try:
                while True:
                    msg = nc.read()
                    if msg is None:
                        break
                    yield msg
            finally:
                if t.is_alive():
                    # early consumer exit with requests still flowing: RST
                    # first (the server drops the stream, backpressure
                    # releases, the blocked write fails fast), THEN join —
                    # destroying the call under a live writer thread is a
                    # native use-after-free
                    nc.cancel()
                t.join()
                code, details = nc.finish()
                nc.close()
                if app_exc:
                    raise app_exc[0]
                if code is not StatusCode.OK:
                    raise RpcError(code, details)

        return call

    def close(self) -> None:
        with self._cq_cond:
            ch, self._ch = self._ch, None
            drv, self._cq_driver = self._cq_driver, None
            win, self._inline_window = self._inline_window, None
            # Wait out native entries still holding the raw pointer
            # (blocking unary calls / pings / live NativeCall handles on
            # other threads): destroying under them is the ASan-caught
            # use-after-free. _ch is already None, so no NEW entry can
            # begin while we wait.
            deadline = time.monotonic() + 10.0
            while self._ops > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cq_cond.wait(remaining)
            ops_drained = self._ops == 0
        if win is not None:
            win.close()  # idle workers exit; busy ones were waited out above
        if ch:
            # CQ teardown first: destroying a call touches its channel, so
            # every future's call must be destroyed before the channel is.
            # If the CQ puller could not prove a clean drain (wedged/starved
            # puller still holding live calls), leak the channel too — the
            # same leak-beats-use-after-free policy the cq itself uses.
            if drv is not None and not drv.close():
                return
            if not ops_drained:
                return  # leak: an entry is still inside the C loop
            self._lib.tpr_channel_destroy(ch)

    def __del__(self):
        # safety net: a dropped channel must not leak the native reader
        # thread + fd (+ shm ring on ring platforms)
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
