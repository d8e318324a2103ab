"""Native server data plane for the Python :class:`tpurpc_torch.rpc.Server`.

The port's copy of the reference's ``rpc/native_server.py``. Eligible ring
connections accepted by the Python server are handed, raw fd, to the port
library's shared-poller server (``tpr_server_adopt_fd``,
``tpurpc_torch/native/src/tpurpc_server.cc``), which runs the framing, ring
pumping and per-stream demux in C and calls back into the registered
Python handlers through ctypes trampolines. The Python data plane
(``rpc/server.py``) keeps serving everything else: TCP and h2
connections, TLS, device-ring (``TPU``) connections, servers with
interceptors or connection-management knobs.

Handler mapping:

- ``inline=True`` unary handlers → the native callback API (runs on the
  poller thread: the handler's must-not-block contract).
- Everything else → the native handler API: a native thread per call runs
  the Python behavior, which may block.

A request message is adopted zero-copy (:func:`_take`): a writable view
over the C buffer, freed (or, for a rendezvous delivery, settled back to
its landing region) once the last Python reference to it dies. A handler
that takes a tensor decoded over it to the card must finish that copy
(a pageable ``.to(device)``, or pinned staging with an event wait) before
it drops the tensor.

Context surface: :class:`NativeServerContext` implements the
grpcio-compatible subset the adopted path can honor (invocation metadata,
deadline, initial/trailing metadata, abort/set_code/set_details,
is_active). TLS-derived surfaces never appear here: adoption is gated to
plaintext listeners. Each adopted call registers with the stall watchdog
and makes the tail-capture decision as the Python plane does; the
``native_server`` trace flag logs adoptions.
"""

from __future__ import annotations

import ctypes
import os
import socket
import threading
import weakref
from typing import Optional

from tpurpc_torch.obs import tracing as _tracing
from tpurpc_torch.obs import watchdog as _watchdog
from tpurpc_torch.rpc.native_client import _u8_zc
from tpurpc_torch.rpc.status import AbortError, StatusCode, deserialize
from tpurpc_torch.utils.trace import TraceFlag

trace_nsrv = TraceFlag("native_server")

_MSG_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                           ctypes.c_void_p)
_HANDLER_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p)

_bound = False
_bind_lock = threading.Lock()


def _lib():
    """The shared library's CDLL with the server symbols' signatures bound
    (the client loader owns the handle; signatures are set once)."""
    from tpurpc_torch.rpc.native_client import _load

    lib = _load()
    global _bound
    with _bind_lock:
        if _bound:
            return lib
        lib.tpr_server_create.restype = ctypes.c_void_p
        lib.tpr_server_create.argtypes = [ctypes.c_int]
        lib.tpr_server_port.argtypes = [ctypes.c_void_p]
        lib.tpr_server_port.restype = ctypes.c_int
        lib.tpr_server_register.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            _HANDLER_FN, ctypes.c_void_p]
        lib.tpr_server_register_callback.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, _MSG_CB, ctypes.c_void_p]
        lib.tpr_server_register_default.argtypes = [ctypes.c_void_p,
                                                   _HANDLER_FN,
                                                   ctypes.c_void_p]
        lib.tpr_server_start.argtypes = [ctypes.c_void_p]
        lib.tpr_server_start.restype = ctypes.c_int
        lib.tpr_server_adopt_fd.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_uint8),
                                            ctypes.c_size_t]
        lib.tpr_server_adopt_fd.restype = ctypes.c_int
        lib.tpr_server_destroy.argtypes = [ctypes.c_void_p]
        lib.tpr_srv_recv.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.tpr_srv_recv.restype = ctypes.c_int
        lib.tpr_srv_send.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.c_size_t]
        lib.tpr_srv_send.restype = ctypes.c_int
        lib.tpr_srv_method.argtypes = [ctypes.c_void_p]
        lib.tpr_srv_method.restype = ctypes.c_char_p
        lib.tpr_srv_deadline_us.argtypes = [ctypes.c_void_p]
        lib.tpr_srv_deadline_us.restype = ctypes.c_int64
        lib.tpr_srv_set_details.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tpr_srv_metadata_count.argtypes = [ctypes.c_void_p]
        lib.tpr_srv_metadata_count.restype = ctypes.c_size_t
        lib.tpr_srv_metadata_get.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p)]
        lib.tpr_srv_metadata_get.restype = ctypes.c_int
        lib.tpr_srv_send_initial_md.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p,
                                                ctypes.c_char_p]
        lib.tpr_srv_add_trailing_md.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p,
                                                ctypes.c_char_p]
        lib.tpr_srv_cancelled.argtypes = [ctypes.c_void_p]
        lib.tpr_srv_cancelled.restype = ctypes.c_int
        lib.tpr_srv_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _bound = True
    return lib


_INT64_MAX = 2**63 - 1


class NativeServerContext:
    """grpcio-compatible context over a native ``tpr_server_call``."""

    def __init__(self, lib, call):
        self._lib = lib
        self._call = call
        self._trailing = ()
        self._code: Optional[StatusCode] = None
        self._details = ""
        self._initial_sent = False

    def invocation_metadata(self):
        lib, call = self._lib, self._call
        out = []
        key = ctypes.c_char_p()
        val = ctypes.c_char_p()
        for i in range(lib.tpr_srv_metadata_count(call)):
            if lib.tpr_srv_metadata_get(call, i, ctypes.byref(key),
                                        ctypes.byref(val)) == 0:
                out.append((key.value.decode("utf-8", "replace"),
                            val.value.decode("utf-8", "replace")))
        return out

    def peer(self) -> str:
        return "ring:native"  # adopted conns are local ring transports

    def auth_context(self) -> dict:
        return {}  # adoption is plaintext-only by eligibility

    def deadline_remaining(self) -> Optional[float]:
        us = self._lib.tpr_srv_deadline_us(self._call)
        if us >= _INT64_MAX:
            return None
        return us / 1e6

    time_remaining = deadline_remaining

    def is_active(self) -> bool:
        return not self._lib.tpr_srv_cancelled(self._call)

    def cancel(self) -> None:
        pass  # server-side local cancel: the native loop reaps at finish

    def set_trailing_metadata(self, metadata) -> None:
        self._trailing = metadata
        for k, v in metadata:
            if isinstance(v, bytes):
                v = v.decode("utf-8", "replace")
            self._lib.tpr_srv_add_trailing_md(self._call, str(k).encode(),
                                              str(v).encode())

    def set_code(self, code: StatusCode) -> None:
        self._code = code

    def set_details(self, details: str) -> None:
        self._details = details
        self._lib.tpr_srv_set_details(self._call, details.encode())

    def abort(self, code: StatusCode, details: str = ""):
        if code is StatusCode.OK:
            raise ValueError("abort with OK is invalid")
        raise AbortError(code, details)

    def send_initial_metadata(self, metadata) -> None:
        if self._initial_sent:
            raise RuntimeError("initial metadata already sent")
        self._initial_sent = True
        for k, v in metadata:
            if isinstance(v, bytes):
                v = v.decode("utf-8", "replace")
            self._lib.tpr_srv_send_initial_md(self._call, str(k).encode(),
                                              str(v).encode())

    # internal ---------------------------------------------------------------

    def _finish_code(self, default_ok: bool = True) -> int:
        if self._code is not None:
            return int(self._code.value)
        return 0 if default_ok else 13


def _take(lib, pptr, plen) -> memoryview:
    """Adopt the C plane's message buffer ZERO-COPY.

    Returns a writable memoryview directly over the malloc'd buffer
    ``tpr_srv_recv`` handed us; a finalizer frees it when the last Python
    reference (the view, or numpy arrays decoded over it) dies. The old
    ``ctypes.string_at`` here was one whole extra pass over every received
    message, and its read-only ``bytes`` result would force a copy on
    the way into a tensor. ``alias_ok``
    deserializers (the tensor codec) decode straight over this view;
    everyone else gets grpcio-contract ``bytes`` via ``deserialize``.
    """
    n = plen.value
    if not n:
        if pptr:
            lib.tpr_srv_buf_free(pptr)
        return memoryview(b"")
    addr = ctypes.cast(pptr, ctypes.c_void_p).value
    raw = (ctypes.c_uint8 * n).from_address(addr)
    # a fresh pointer object: the caller's pptr is reused per recv loop
    owned = ctypes.cast(ctypes.c_void_p(addr),
                        ctypes.POINTER(ctypes.c_uint8))
    weakref.finalize(raw, lib.tpr_srv_buf_free, owned)
    return memoryview(raw).cast("B")


class NativeDataplane:
    """One ``tpr_server`` carrying adopted connections for a Python Server."""

    def __init__(self, py_server):
        self._lib = _lib()
        self._py_server = py_server
        # The native server's own listener is an implementation detail (it
        # binds an ephemeral loopback port nobody is told about); adopted
        # fds are the only traffic source.
        self._srv = self._lib.tpr_server_create(0)
        if not self._srv:
            raise OSError("tpr_server_create failed")
        self._refs = []  # CFUNCTYPE objects must outlive the server
        # inline unary handlers get the poller-thread reactor path; every
        # OTHER call resolves DYNAMICALLY through the default trampoline —
        # which covers grpcio generic handlers and late registrations the
        # same way the Python plane's per-call _lookup does
        for path, handler in dict(py_server._methods).items():
            if handler.kind == "unary_unary" and handler.inline:
                self._register_inline(path, handler)
        self._register_default()
        if self._lib.tpr_server_start(self._srv) != 0:
            self._lib.tpr_server_destroy(self._srv)
            raise OSError("tpr_server_start failed")
        self._closed = False
        self._lock = threading.Lock()
        #: connections the C loop took over (the count a caller checks to
        #: know its ring traffic rides this plane)
        self.adopted = 0

    # -- handler trampolines -------------------------------------------------

    def _register_inline(self, path: str, handler) -> None:
        # poller-thread reactor path (the handler's existing
        # must-not-block contract, RpcMethodHandler.inline)
        lib = self._lib

        def msg_cb(call, data, length, _ud, _h=handler):
            try:
                body = ctypes.string_at(data, length) if length else b""
                ctx = NativeServerContext(lib, call)
                try:
                    resp = _h.behavior(_h.request_deserializer(body), ctx)
                except AbortError as exc:
                    lib.tpr_srv_set_details(call, exc.details.encode())
                    return int(exc.code.value)
                raw = _h.response_serializer(resp)
                # zero-copy for bytes (tpr_srv_send consumes the buffer
                # before returning: rdv memcpy or framed ring write inline)
                buf, blen = _u8_zc(raw)
                lib.tpr_srv_send(call, buf, blen)
                return ctx._finish_code()  # 0 unless set_code()
            except Exception as exc:  # handler raised: INTERNAL
                try:
                    lib.tpr_srv_set_details(call, repr(exc).encode())
                except Exception:
                    pass
                return 13

        cb = _MSG_CB(msg_cb)
        self._refs.append(cb)
        lib.tpr_server_register_callback(self._srv, path.encode(), cb, None)

    def _register_default(self) -> None:
        lib = self._lib

        def handler_fn(call, _ud):
            try:
                ctx = NativeServerContext(lib, call)
                path = lib.tpr_srv_method(call).decode("utf-8", "replace")
                # the Python plane's dynamic resolution (exact methods,
                # grpcio generic handlers, late registrations)
                _h = self._py_server._lookup(path, ctx.invocation_metadata())
                if _h is None:
                    lib.tpr_srv_set_details(
                        call, f"unknown method {path}".encode())
                    return 12  # UNIMPLEMENTED

                def requests():
                    pptr = ctypes.POINTER(ctypes.c_uint8)()
                    plen = ctypes.c_size_t()
                    while True:
                        r = lib.tpr_srv_recv(call, ctypes.byref(pptr),
                                             ctypes.byref(plen))
                        if r != 1:
                            return
                        yield deserialize(_h.request_deserializer,
                                          _take(lib, pptr, plen))

                def send(resp) -> int:
                    raw = _h.response_serializer(resp)
                    # zero-copy for bytes: tpr_srv_send consumes the
                    # buffer (rdv memcpy or framed write) before returning
                    buf, blen = _u8_zc(raw)
                    return lib.tpr_srv_send(call, buf, blen)

                # the trace context a sampled
                # caller shipped through tpr_call_start's metadata — same
                # wire key as the Python plane, installed as this handler
                # thread's ambient so handler spans (and the batcher's
                # batch-wait/infer) attribute to the caller's trace_id.
                tctx = None
                if _tracing.LIVE:
                    for _k, _v in ctx.invocation_metadata():
                        if _k == _tracing.HEADER:
                            # adopt (not bare decode): a tail-provisional
                            # caller opens this process's pending buffer so
                            # handler spans join the same tail decision
                            tctx = _tracing.adopt(_v)
                            break
                # the native plane registers with the stall watchdog and
                # makes the tail-capture decision like the Python plane
                import time as _time

                wd_tok = _watchdog.call_started(
                    path, tctx.trace_id if tctx is not None else 0)
                t0 = _time.monotonic_ns()
                rc = 13
                try:
                    try:
                        with _tracing.use(tctx) if tctx is not None \
                                else _tracing.NULL_CM:
                            if _h.kind == "unary_unary":
                                req = next(requests(), None)
                                if req is None:
                                    return 13  # half-close with no message
                                with _tracing.span("handler", tctx):
                                    resp = _h.behavior(req, ctx)
                                if send(resp) != 0:
                                    return 14  # UNAVAILABLE: conn died
                            elif _h.kind == "unary_stream":
                                req = next(requests(), None)
                                if req is None:
                                    return 13
                                for resp in _h.behavior(req, ctx):
                                    if send(resp) != 0:
                                        return 14
                            elif _h.kind == "stream_unary":
                                if send(_h.behavior(requests(), ctx)) != 0:
                                    return 14
                            else:  # stream_stream
                                for resp in _h.behavior(requests(), ctx):
                                    if send(resp) != 0:
                                        return 14
                    except AbortError as exc:
                        lib.tpr_srv_set_details(call, exc.details.encode())
                        rc = int(exc.code.value)
                        return rc
                    rc = ctx._finish_code()
                    return rc
                finally:
                    _watchdog.call_finished(wd_tok, error=rc != 0)
                    _tracing.tail_decide(tctx, _time.monotonic_ns() - t0,
                                         error=rc != 0, method=path)
            except Exception as exc:  # handler raised: INTERNAL
                try:
                    lib.tpr_srv_set_details(call, repr(exc).encode())
                except Exception:
                    pass
                return 13

        fn = _HANDLER_FN(handler_fn)
        self._refs.append(fn)
        lib.tpr_server_register_default(self._srv, fn, None)

    # -- adoption ------------------------------------------------------------

    def adopt(self, sock: socket.socket) -> bool:
        """Take ownership of an accepted socket; True means the caller
        must forget it. The _closed check happens under the same lock
        close() takes, so tpr_server_adopt_fd cannot race destroy; its
        defensive failure branch still CONSUMES the socket (detach already
        ran — handing a dead fd back for the Python path to serve would
        be worse than dropping one connection; the client re-dials)."""
        with self._lock:
            if self._closed:
                return False  # socket untouched: Python path serves it
            fd = sock.detach()
            if self._lib.tpr_server_adopt_fd(self._srv, fd, None, 0) != 0:
                os.close(fd)
                return True  # consumed-and-dropped; never serve a dead fd
            self.adopted += 1
            trace_nsrv.log("adopted fd %d onto the native data plane", fd)
            return True

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # NOTE: destroy blocks until handler threads drain; Python handlers
        # blocked in tpr_srv_recv are woken by the per-conn teardown.
        self._lib.tpr_server_destroy(self._srv)


def adoption_eligible(py_server) -> bool:
    """Whether THIS server's accepted ring connections may ride the native
    data plane. Conservative: every feature the native loop cannot honor
    keeps the whole server on the Python plane."""
    mode = os.environ.get("TPURPC_NATIVE_SERVER", "auto").lower()
    if mode in ("0", "off", "false"):
        return False
    if getattr(py_server, "_native_dataplane_opt", None) is False:
        return False  # Server(native_dataplane=False): bulk-optimized
    from tpurpc_torch.utils.config import get_config

    cfg = get_config()
    if not (cfg.platform.is_ring and cfg.platform.name != "TPU"
            and cfg.ring_domain == "shm"):
        return False  # the native loop speaks shm rings (+ its own TCP)
    if py_server.interceptors:
        return False  # interceptor wrapping happens in the Python plane
    # (generic handlers are FINE: the default trampoline resolves methods
    # through the server's own _lookup per call, grpcio-style)
    if cfg.max_connection_age_ms > 0 or cfg.keepalive_time_ms > 0 \
            or cfg.client_idle_timeout_ms > 0:
        return False  # connection management lives in the Python plane
    try:
        return _lib() is not None
    except Exception:
        return False
