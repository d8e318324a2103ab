"""Server: listener → per-connection demux → handler dispatch on a pool.

A trimmed copy of ``tpurpc/rpc/server.py`` (no native plane, which comes
with the C core; no plain-HTTP scrape answer on the serving port, and no
history or alerting planes started at ``start()``, which come with ROADMAP
A4 (c)). One port serves both wire protocols: the
first 8 bytes of a connection route the native framing's magic to
:class:`_ServerConnection` and the HTTP/2 preface to
``tpurpc_torch/wire/grpc_h2.py``, so stock gRPC clients call the same
handlers. It keeps the overload
:class:`AdmissionGate`, the server-wide :meth:`Server.drain` with its drain
hooks and its health-service flip, and what a fleet needs: the per-response
load report (:meth:`Server.set_load_provider`, :data:`LOAD_KEY`), listeners
that share a port (``add_insecure_port(..., reuseport=True)``) and
:meth:`Server.adopt_socket` for connections accepted elsewhere.
``ServerContext`` keeps the grpcio surface the tensor service uses, including
``device_ring`` and ``auth_context``; handlers use grpcio's four-shape
taxonomy. ``add_secure_port`` serves TLS (and mTLS) on every platform: the
handshake precedes the protocol sniff. Each server registers with
channelz (``rpc/channelz.py``) and counts its calls there. Each connection
carries a rendezvous link (``core/rendezvous.py``): bulk request payloads
land in this side's landing pool and bulk responses go into the client's;
its control ops ride the connection's descriptor rings
(``core/ctrlring.py``) once the client's hello advertised one. A request
MESSAGE sent ``FLAG_COMPRESSED`` is gunzipped at reassembly (the receive
limit binds the inflated size: RESOURCE_EXHAUSTED past it, INTERNAL for a
stream that does not gunzip), and the stream's replies mirror the flag.
Unary responses that complete close together on one connection leave in
one gathered writev (``FrameWriter(coalesce=True)``).

The connection lifecycle: server keepalive (a quiet client is PINGed and
reaped when nothing, not even the PONG, arrives in time) and max connection
age (GOAWAY, then a one-second linger before the close), both on the timer
wheel (``utils/timers.py``) with every endpoint write off the wheel's
thread (``run_blocking``); ``inline=True`` unary handlers, which run on the
connection's reader thread when the request completes; the admission
gate's connection-level face consulted by the listener before any
handshake (:meth:`Server._accept_pushback`); and :func:`inproc_channel`, a
channel wired to the server over a passthru endpoint pair.

The call plane's observability (``tpurpc_torch/obs``, the reference's
names): a caller's ``tpurpc-trace`` context is adopted (and stripped from
the handler's metadata) with the ``dispatch`` and ``respond`` spans and the
server's tail decision; each handler registers with the stall watchdog,
whose rolling p99 is the admission gate's default latency signal and the
load report's p99; ``srv_call_us``, ``srv_calls{method,code}`` and
``srv_admission_rejected``; the flight events ``ADMIT_REJECT``, the inline
path's ``DEADLINE_EXPIRED``, ``DRAIN_BEGIN`` and ``DRAIN_END``; the
profiler's ``dispatch`` stage over the handler frames; the
``srv_handler`` profile span while ``TPURPC_PROFILING`` is on; and the
``server`` trace flag's log lines (``GRPC_TRACE=server``).
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from tpurpc_torch.core import ctrlring as _ctrl
from tpurpc_torch.core import rendezvous as _rdv
from tpurpc_torch.core.endpoint import (Endpoint, EndpointError,
                                        EndpointListener, create_endpoint,
                                        device_ring_of)
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _obs_metrics
from tpurpc_torch.obs import profiler as _obs_profiler
from tpurpc_torch.obs import tracing as _tracing
from tpurpc_torch.obs import watchdog as _watchdog
from tpurpc_torch.rpc import frame as fr
from tpurpc_torch.rpc.status import (AbortError, Deserializer, Metadata,
                                     Serializer, StatusCode,
                                     deserialize as _deserialize,
                                     identity_codec as _identity)
from tpurpc_torch.utils import stats as _stats
from tpurpc_torch.utils import timers as _timers
from tpurpc_torch.utils.config import get_config
from tpurpc_torch.utils.trace import TraceFlag

_log = logging.getLogger("tpurpc_torch.server")
trace_server = TraceFlag("server")

#: the sampling profiler's frame markers: handler dispatch on either
#: execution path is the ``dispatch`` stage
_LENS_STAGES = {
    "_run_handler": "dispatch",
    "_run_handler_inner": "dispatch",
    "_run_inline": "dispatch",
}
_obs_profiler.register_stages(__file__, _LENS_STAGES)

#: handler latency (one perf_counter pair and one histogram record a call)
_SRV_CALL_US = _obs_metrics.histogram("srv_call_us", kind="latency")
#: per-method, per-status-code RED counters
_SRV_CALLS = _obs_metrics.labeled_counter("srv_calls", ("method", "code"))
#: admission sheds, and the interned flight tags of the emission sites
_SRV_SHED = _obs_metrics.counter("srv_admission_rejected")
_SRV_INLINE_TAG = _flight.tag_for("srv-inline")
_SRV_ADMIT_TAG = _flight.tag_for("srv-admission")
_SRV_DRAIN_TAG = _flight.tag_for("srv-drain")

#: trailing-metadata key carrying the ORCA-style per-response load report
#: (``"<inflight>,<queue_depth>,<p99_ms>"`` — see Server._load_md); the
#: client channel strips it and feeds the ``least_loaded`` LB policy
LOAD_KEY = "tpurpc-load"
#: trailing-metadata key on admission rejections: how long the client
#: should back off before retrying (milliseconds)
PUSHBACK_KEY = "tpurpc-pushback-ms"


def _extract_trace(metadata) -> "Optional[_tracing.TraceContext]":
    """The ``tpurpc-trace`` context a client attached (sampled or
    tail-provisional), stripped from ``metadata`` IN PLACE: the context is
    transport-internal and must not reach handlers (with tail capture on,
    every call carries it)."""
    if not _tracing.LIVE:
        return None
    for i, (key, value) in enumerate(metadata):
        if key == _tracing.HEADER:
            del metadata[i]
            return _tracing.adopt(value)
    return None


class AdmissionGate:
    """Server-side overload admission control at stream admission, before
    any handler work. Below ``soft_limit`` admitted-but-unfinished RPCs
    everything is admitted, at ``max_inflight`` nothing is; between the
    two, admission requires ``latency_ms_fn()`` (a workload's latency
    signal: a decode server hands in its step-time p99) to be under
    ``latency_slo_ms``. A rejection is UNAVAILABLE with
    :data:`PUSHBACK_KEY` trailing metadata that grows with the excess."""

    def __init__(self, max_inflight: int, *,
                 soft_limit: Optional[int] = None,
                 latency_slo_ms: Optional[float] = None,
                 latency_ms_fn: "Optional[Callable[[], Optional[float]]]"
                 = None,
                 base_pushback_ms: int = 25,
                 max_pushback_ms: int = 1000):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = int(max_inflight)
        self.soft_limit = (int(soft_limit) if soft_limit is not None
                           else max(1, (self.max_inflight * 3) // 4))
        if not 1 <= self.soft_limit <= self.max_inflight:
            raise ValueError("need 1 <= soft_limit <= max_inflight")
        self.latency_slo_ms = latency_slo_ms
        self.latency_ms_fn = latency_ms_fn
        self.base_pushback_ms = int(base_pushback_ms)
        self.max_pushback_ms = int(max_pushback_ms)
        self._inflight = 0
        self._lock = threading.Lock()
        self.rejected = 0

    def _latency_ms(self) -> Optional[float]:
        """``latency_ms_fn()`` when given, else the stall watchdog's worst
        rolling p99 (None, not slow, until a method has history)."""
        if self.latency_ms_fn is not None:
            try:
                return self.latency_ms_fn()
            except Exception:
                return None  # a broken probe never blocks admission
        p99 = _watchdog.get().rolling_p99_ns()
        return None if p99 is None else p99 / 1e6

    def try_admit(self) -> Optional[int]:
        """None = admitted (the caller owes a :meth:`release`); an int =
        rejected, with that many milliseconds of retry pushback."""
        with self._lock:
            n = self._inflight
            if n < self.soft_limit:
                self._inflight = n + 1
                return None
            slow = False
            if n < self.max_inflight:
                if self.latency_slo_ms is not None:
                    lat = self._latency_ms()
                    slow = lat is not None and lat > self.latency_slo_ms
                if not slow:
                    self._inflight = n + 1
                    return None
            self.rejected += 1
            excess = max(1, n - self.soft_limit + 1)
            return min(self.max_pushback_ms,
                       self.base_pushback_ms * excess)

    def release(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def connection_pushback_ms(self) -> Optional[int]:
        """The accept path's pressure probe: sheds new connections only at
        hard saturation (``max_inflight`` in flight); between the limits
        existing clients keep reconnecting and the per-RPC gate sheds. A
        pure probe: it admits nothing, so no :meth:`release` is owed."""
        with self._lock:
            n = self._inflight
            if n < self.max_inflight:
                return None
            excess = max(1, n - self.soft_limit + 1)
            return min(self.max_pushback_ms,
                       self.base_pushback_ms * excess)

    @classmethod
    def from_env(cls) -> "Optional[AdmissionGate]":
        """The gate ``TPURPC_ADMISSION_MAX_INFLIGHT`` (and optionally
        ``TPURPC_ADMISSION_SLO_MS``) configures, or None when unset:
        admission control is opt-in."""
        raw = os.environ.get("TPURPC_ADMISSION_MAX_INFLIGHT", "")
        if not raw:
            return None
        try:
            max_inflight = int(raw)
        except ValueError:
            return None
        if max_inflight < 1:
            return None
        slo = None
        raw_slo = os.environ.get("TPURPC_ADMISSION_SLO_MS", "")
        if raw_slo:
            try:
                slo = float(raw_slo)
            except ValueError:
                slo = None
        return cls(max_inflight, latency_slo_ms=slo)


class RpcMethodHandler:
    """One registered method: shape + behavior + codecs (grpcio taxonomy).

    ``inline=True`` (unary_unary only) runs the handler on the connection's
    reader thread when the request completes: no pool handoff. The handler
    must not block: it stalls every stream of its connection."""

    __slots__ = ("kind", "behavior", "request_deserializer",
                 "response_serializer", "inline")

    KINDS = ("unary_unary", "unary_stream", "stream_unary", "stream_stream")

    def __init__(self, kind: str, behavior: Callable,
                 request_deserializer: Deserializer = _identity,
                 response_serializer: Serializer = _identity,
                 inline: bool = False):
        if kind not in self.KINDS:
            raise ValueError(f"bad handler kind {kind}")
        if inline and kind != "unary_unary":
            raise ValueError("inline handlers are unary_unary only")
        self.inline = inline
        self.kind = kind
        self.behavior = behavior
        self.request_deserializer = request_deserializer
        self.response_serializer = response_serializer

    @property
    def request_streaming(self) -> bool:
        return self.kind.startswith("stream")

    @property
    def response_streaming(self) -> bool:
        return self.kind.endswith("stream")


def unary_unary_rpc_method_handler(behavior, request_deserializer=_identity,
                                   response_serializer=_identity,
                                   inline: bool = False):
    return RpcMethodHandler("unary_unary", behavior, request_deserializer,
                            response_serializer, inline=inline)


def unary_stream_rpc_method_handler(behavior, request_deserializer=_identity,
                                    response_serializer=_identity):
    return RpcMethodHandler("unary_stream", behavior, request_deserializer,
                            response_serializer)


def stream_unary_rpc_method_handler(behavior, request_deserializer=_identity,
                                    response_serializer=_identity):
    return RpcMethodHandler("stream_unary", behavior, request_deserializer,
                            response_serializer)


def stream_stream_rpc_method_handler(behavior, request_deserializer=_identity,
                                     response_serializer=_identity):
    return RpcMethodHandler("stream_stream", behavior, request_deserializer,
                            response_serializer)


def method_handlers_generic_handler(service: str,
                                    method_handlers: Dict[str, RpcMethodHandler]):
    """grpcio-shaped: ``{path: handler}`` for
    :meth:`Server.add_generic_rpc_handlers`."""
    return {f"/{service}/{name}": h for name, h in method_handlers.items()}


class _HandlerCallDetails:
    """grpc.HandlerCallDetails shape for GenericRpcHandler.service()."""

    __slots__ = ("method", "invocation_metadata")

    def __init__(self, method: str, invocation_metadata=()):
        self.method = method
        self.invocation_metadata = tuple(invocation_metadata or ())


class ServerContext:
    """Handed to every handler; grpcio-compatible surface."""

    def __init__(self, conn: "_ServerConnection", stream: "_ServerStream",
                 metadata: List[Tuple[str, "str | bytes"]],
                 deadline: Optional[float]):
        self._conn = conn
        self._stream = stream
        self._metadata = metadata
        self._deadline = deadline
        self._trailing: Metadata = ()
        self._initial_sent = False
        self._cancelled = threading.Event()
        self._code: Optional[StatusCode] = None
        self._details = ""
        self._auth_ctx: Optional[dict] = None

    def invocation_metadata(self) -> Metadata:
        return list(self._metadata)

    def peer(self) -> str:
        return self._conn.endpoint.peer

    def auth_context(self) -> dict:
        """grpcio's ServerContext.auth_context: {} on plaintext,
        ``transport_security_type`` alone on TLS without a client
        certificate, plus the peer's x509 names under mTLS. Read through the
        endpoint (a ring keeps the TLS socket as its pair's notify channel)
        and computed once per context: the certificate cannot change
        mid-call."""
        cached = self._auth_ctx
        if cached is not None:
            return cached
        cert = self._conn.endpoint.peer_cert()
        out: dict = {}
        if cert is not None:
            out["transport_security_type"] = [b"ssl"]
        if cert:
            # every SAN kind counts as identity (a URI carries SPIFFE ids)
            sans = [v.encode() if isinstance(v, str) else str(v).encode()
                    for _kind, v in cert.get("subjectAltName", ())]
            if sans:
                out["x509_subject_alternative_name"] = sans
            for rdn in cert.get("subject", ()):
                for key, val in rdn:
                    if key == "commonName":
                        out.setdefault("x509_common_name", []).append(
                            val.encode())
        self._auth_ctx = out
        return out

    def peer_identity_key(self) -> "Optional[str]":
        ac = self.auth_context()
        for key in ("x509_subject_alternative_name", "x509_common_name"):
            if key in ac:
                return key
        return None

    def peer_identities(self):
        key = self.peer_identity_key()
        return self.auth_context()[key] if key else None

    @property
    def device_ring(self):
        """The connection's device receive ring, or None off the TPU
        platform; tensor handlers registered with ``device=True`` decode
        through it."""
        return device_ring_of(self._conn.endpoint)

    def deadline_remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    time_remaining = deadline_remaining

    def is_active(self) -> bool:
        return not self._cancelled.is_set()

    def cancel(self) -> None:
        self._cancelled.set()

    def set_trailing_metadata(self, metadata: Metadata) -> None:
        self._trailing = metadata

    def set_code(self, code: StatusCode) -> None:
        self._code = code

    def set_details(self, details: str) -> None:
        self._details = details

    def abort(self, code: StatusCode, details: str = ""):
        if code is StatusCode.OK:
            raise ValueError("abort with OK is invalid")
        raise AbortError(code, details)

    def send_initial_metadata(self, metadata: Metadata) -> None:
        if self._initial_sent:
            raise RuntimeError("initial metadata already sent")
        self._initial_sent = True
        self._conn.writer.send(fr.HEADERS, 0, self._stream.stream_id,
                               fr.encode_metadata(list(metadata)))

    def _deadline_exceeded(self) -> bool:
        return self._deadline is not None and time.monotonic() >= self._deadline


class _ServerStream:
    """Inbound half of one RPC: request frames → handler-visible iterator."""

    _END = object()
    _OVERSIZED = object()
    _BAD_COMPRESSION = object()

    def __init__(self, stream_id: int, queue_depth: int = 64,
                 recv_limit: Optional[int] = None):
        self.stream_id = stream_id
        #: the admission gate this stream holds a slot of, if any
        self.gate: Optional[AdmissionGate] = None
        #: a health probe: admitted during drain and past the admission
        #: gate, and not counted by the drain's wait
        self.is_probe = False
        self.recv_limit = recv_limit
        self.requests: "queue.Queue[object]" = queue.Queue()
        self.assembly = fr.Assembly()
        self.half_closed = False
        #: a request arrived FLAG_COMPRESSED: mirror the encoding on the
        #: replies (the peer demonstrably speaks it)
        self.peer_compressed = False
        self.context: Optional[ServerContext] = None
        #: an inline call parked until its request completes, and the
        #: deadline watchdog of that wait
        self.inline_call = None
        self.inline_timer: Optional[_timers.TimerHandle] = None
        #: the status the trailers carried (``srv_calls``' code label)
        self.final_code: Optional[StatusCode] = None
        #: the caller's trace context and the HEADERS arrival stamp (the
        #: start of the "dispatch" span)
        self.trace_ctx: "Optional[_tracing.TraceContext]" = None
        self.trace_t0 = 0
        #: backpressure: at most queue_depth completed-but-unconsumed
        #: messages; the connection reader blocks on a credit, which stops
        #: draining the transport and stalls the sender
        self._credits = threading.BoundedSemaphore(max(1, queue_depth))

    def _acquire_credit(self) -> bool:
        """Block until a queue slot frees; False if the stream died."""
        while not self._credits.acquire(timeout=0.25):
            ctx = self.context
            if ctx is not None and not ctx.is_active():
                return False
        return True

    def _release_credit(self) -> None:
        try:
            self._credits.release()
        except ValueError:
            pass

    def commit_message(self, more: bool, end_stream: bool,
                       no_message: bool = False,
                       oversized: bool = False,
                       compressed: bool = False) -> None:
        if oversized and not more:
            self.assembly.oversized = False
            self.requests.put(self._OVERSIZED)
        elif not no_message and not more:
            if self._acquire_credit():
                body = self.assembly.take()
                if compressed:
                    self.peer_compressed = True
                    try:
                        # the limit binds the inflated size (bomb guard)
                        body = fr.decompress_message(body, self.recv_limit)
                    except fr.DecompressTooLarge:
                        self._release_credit()  # sentinels bypass credits
                        self.requests.put(self._OVERSIZED)
                        body = None
                    except fr.FrameError:
                        self._release_credit()
                        self.requests.put(self._BAD_COMPRESSION)
                        body = None
                if body is not None:
                    self.requests.put(body)
            else:
                self.assembly.take()  # stream dead: drop, free the bytes
        if end_stream:
            self.half_closed = True
            self.requests.put(self._END)

    def commit_external(self, body, end_stream: bool) -> None:
        """A rendezvous request payload, already whole in its landing
        region (the decode aliases it): the same per-stream credit as a
        framed commit."""
        if self._acquire_credit():
            self.requests.put(body)
        if end_stream:
            self.half_closed = True
            self.requests.put(self._END)

    def cancel(self) -> None:
        if self.context is not None:
            self.context.cancel()
        self.requests.put(self._END)

    def next_request(self, timeout: Optional[float] = None):
        """One queue item with its credit returned; queue.Empty on timeout."""
        item = self.requests.get(timeout=timeout)
        if (item is not self._END and item is not self._OVERSIZED
                and item is not self._BAD_COMPRESSION):
            self._release_credit()
        return item

    def request_iterator(self, deserializer: Deserializer,
                         context: ServerContext) -> Iterator[object]:
        while True:
            item = self.next_request()
            if item is self._END:
                return
            if item is self._OVERSIZED:
                raise AbortError(
                    StatusCode.RESOURCE_EXHAUSTED,
                    f"received message larger than max ({self.recv_limit} bytes)")
            if item is self._BAD_COMPRESSION:
                raise AbortError(StatusCode.INTERNAL,
                                 "compressed message failed to decompress")
            if not context.is_active():
                return
            msg = _deserialize(deserializer, item)
            item = None
            yield msg
            # the handler asked for the next message, so it is done with
            # this one: drop it before waiting, or a rendezvous body's
            # landing region stays pinned until the next message arrives
            msg = None


class _ServerSink(fr.MessageSink):
    """Routes request MESSAGE bytes into per-stream assembly buffers."""

    def __init__(self, conn: "_ServerConnection"):
        self._conn = conn
        self._discard = fr.Assembly()

    def buffer_for(self, stream_id: int) -> fr.Assembly:
        with self._conn._lock:
            st = self._conn._streams.get(stream_id)
        if st is None:
            self._discard.take()  # drop late bytes
            return self._discard
        return st.assembly

    def commit(self, stream_id: int, flags: int) -> None:
        with self._conn._lock:
            st = self._conn._streams.get(stream_id)
        if st is not None:
            st.commit_message(bool(flags & fr.FLAG_MORE),
                              bool(flags & fr.FLAG_END_STREAM),
                              bool(flags & fr.FLAG_NO_MESSAGE),
                              oversized=st.assembly.oversized,
                              compressed=bool(flags & fr.FLAG_COMPRESSED))
            if flags & fr.FLAG_END_STREAM:
                self._conn._inline_complete(st)


#: set while a thread runs an inline handler. An inline handler that
#: completes another request on the same thread (a passthru endpoint or a
#: loopback self-call can) must not nest dispatches: nested inline work
#: goes to the pool
_inline_tls = threading.local()


class _ServerConnection:
    def __init__(self, server: "Server", endpoint: Endpoint):
        self.server = server
        self.endpoint = endpoint
        # coalesce=True: unary responses completing close together on this
        # connection flush as one gathered writev
        self.writer = fr.FrameWriter(endpoint, coalesce=True)
        # the 8-byte preface was consumed by the server's sniff
        self.reader = fr.FrameReader(endpoint)
        self.reader.sink = _ServerSink(self)
        self.reader.sink.max_message_bytes = server.max_receive_message_length
        self._streams: Dict[int, _ServerStream] = {}
        self._lock = threading.Lock()
        self.alive = True
        self.draining = False  # GOAWAY sent; no new streams accepted
        self.streams_started = 0  # channelz SocketData counter
        self.last_frame = time.monotonic()  # any inbound frame refreshes
        self._linger_timer: Optional[_timers.TimerHandle] = None
        self._ka_handle: Optional[_timers.TimerHandle] = None
        self._age_timer: Optional[_timers.TimerHandle] = None
        # the rendezvous link, made before the reader starts so that the
        # client's hello never meets an unarmed link
        self.rdv = _rdv.link_for_endpoint(
            endpoint, "srv:" + getattr(endpoint, "peer", "?"),
            self._rdv_send_op, self._rdv_deliver,
            send_ops=self._rdv_send_ops)
        self.writer.rdv = self.rdv
        # the descriptor-ring control plane: our receive ring rides the
        # hello blob; the peer's arrives in its hello and moves this link's
        # control ops off frames
        self._frames_dispatched = 0
        self.ctrl: Optional[_ctrl.CtrlPlane] = None
        if self.rdv is not None and _ctrl.enabled():
            try:
                self.ctrl = _ctrl.CtrlPlane(
                    "srv:" + getattr(endpoint, "peer", "?"))
            except Exception:
                self.ctrl = None  # no shm: framed control forever
            if self.ctrl is not None:
                self.rdv.ctrl_post = self._rdv_ctrl_post
                self.rdv.ctrl_drain = self._ctrl_drain_nowait
                # control ops posted before a sink-routed MESSAGE deliver
                # first
                self.reader.pre_commit = self._ctrl_drain
        if self.rdv is not None:
            self.rdv.recv_limit = server.max_receive_message_length
            # a ring plane negotiated at the pair bootstrap (Address.caps)
            pair = getattr(endpoint, "pair", None)
            if pair is not None and "rdv" in pair.peer_caps:
                self.rdv.on_peer_hello()
            hello = _rdv.HELLO_PAYLOAD
            if self.ctrl is not None:
                hello += self.ctrl.hello_blob()
            try:
                self.writer.send(fr.PING, 0, 0, hello)
            except (EndpointError, OSError, fr.FrameError):
                pass  # connection dying; the read loop surfaces it
        self._thread = threading.Thread(target=self._read_loop, daemon=True,
                                        name="tpurpc-srv-reader")
        self._thread.start()
        self._start_age_timer()
        self._start_keepalive()

    def _start_keepalive(self) -> None:
        """Server keepalive (the client's ``keepalive_time_ms`` knob): PING
        a quiet client, and close the connection when nothing, not even
        the PONG, arrives within ``keepalive_timeout_ms``. A dead client
        would otherwise pin pooled pairs and rings for good."""
        cfg = get_config()
        if cfg.keepalive_time_ms <= 0:
            return
        interval = cfg.keepalive_time_ms / 1000.0
        timeout = max(0.001, cfg.keepalive_timeout_ms / 1000.0)
        state = {"ping_sent_at": None}  # monotonic stamp of the open PING

        def tick():
            if not self.alive:
                return
            with self._lock:
                busy = bool(self._streams)
            if busy:
                # in-flight streams: the reader may be stalled on a
                # stream's backpressure with the PONGs unread; a dead peer
                # mid-stream surfaces as a write error or EOF instead
                state["ping_sent_at"] = None
                self._ka_handle = _timers.schedule(min(interval, 1.0), tick)
                return
            ping_sent_at = state["ping_sent_at"]
            if ping_sent_at is not None and self.last_frame >= ping_sent_at:
                ping_sent_at = state["ping_sent_at"] = None  # answered
            quiet = time.monotonic() - self.last_frame
            if quiet < interval:
                state["ping_sent_at"] = None  # frames flowed: restart
                self._ka_handle = _timers.schedule(
                    min(interval - quiet, 1.0), tick)
                return
            if ping_sent_at is None:
                # stamp before the send: the reader may process the PONG
                # before a stamp taken after it
                state["ping_sent_at"] = time.monotonic()

                def send_ping():  # an endpoint write: never on the wheel
                    try:  # one PING per silence window
                        self.writer.send(fr.PING, 0, 0, b"srv-keepalive")
                    except (EndpointError, OSError, fr.FrameError):
                        self._shutdown()

                _timers.run_blocking(send_ping)
                self._ka_handle = _timers.schedule(min(timeout, 1.0), tick)
                return
            if time.monotonic() - ping_sent_at >= timeout:
                trace_server.log("keepalive: client silent %.1fs, closing",
                                 quiet)
                _timers.run_blocking(self._shutdown)
                return
            self._ka_handle = _timers.schedule(min(timeout, 1.0), tick)

        self._ka_handle = _timers.schedule(min(interval, 1.0), tick)

    def _start_age_timer(self) -> None:
        """Max connection age (``max_connection_age_ms``): past the age,
        GOAWAY the client, which stops opening streams here and dials
        fresh, then close once the in-flight streams drain."""
        age_ms = get_config().max_connection_age_ms
        if age_ms <= 0:
            return

        def expire():
            if self.goaway(b"max_connection_age"):
                self.linger_then_close()

        # the GOAWAY is an endpoint write (it can stall on a credit-wedged
        # transport): off the wheel's thread
        self._age_timer = _timers.schedule(
            age_ms / 1000.0, lambda: _timers.run_blocking(expire))

    def _read_loop(self) -> None:
        if self.rdv is not None:
            # a big send on this thread must never wait for a CLAIM that
            # this very thread would have to deliver: it frames instead
            self.rdv.disallowed_thread = threading.get_ident()
        try:
            while True:
                f = self._read_frame_ctrl()
                if f is None:
                    break
                self.last_frame = time.monotonic()  # the client is alive
                if f is not fr.CONSUMED:  # MESSAGEs are routed via the sink
                    self._dispatch(f)
                self._frames_dispatched += 1
        except (EndpointError, fr.FrameError, OSError) as exc:
            trace_server.log("server connection error: %s", exc)
        finally:
            self._shutdown()

    def _rdv_send_op(self, op: int, stream_id: int, payload: bytes) -> None:
        self.writer.send(fr.RDV_FRAME_OF_OP[op], 0, stream_id, payload)

    def _rdv_send_ops(self, ops) -> None:
        """The coalescer's flush: every queued control op in ONE gathered
        writev."""
        self.writer.send_many([(fr.RDV_FRAME_OF_OP[op], 0, sid, payload)
                               for op, sid, payload in ops])

    # -- descriptor-ring control plane ----------------------------------------

    def _rdv_ctrl_post(self, op: int, stream_id: int,
                       payload: bytes) -> bool:
        plane = self.ctrl
        if plane is None:
            return False
        return plane.post(op, stream_id, payload, self.writer.frames_sent,
                          self._ctrl_kick)

    def _ctrl_kick(self) -> None:
        try:
            self.writer.send(fr.CTRL_KICK, 0, 0, b"")
        except (EndpointError, OSError, fr.FrameError):
            pass  # connection dying; the read loop surfaces it

    def _frames_count(self) -> int:
        return self._frames_dispatched

    def _ctrl_drain(self, wait: bool = True) -> int:
        """Drain this side's ring. The reader waits out a sender thread's
        concurrent drain, so that every record the ring holds before a frame
        is delivered before that frame is dispatched."""
        plane, rdv = self.ctrl, self.rdv
        if plane is None or rdv is None:
            return 0
        n = plane.drain(rdv.on_op, self._frames_count, wait)
        if n:
            # ring records are client-liveness evidence as frames are
            self.last_frame = time.monotonic()
        return n

    def _ctrl_drain_nowait(self) -> int:
        """A sender thread's drain (standing-grant pickup): skips when the
        reader is draining."""
        return self._ctrl_drain(wait=False)

    def _read_frame_ctrl(self, timeout=None):
        plane = self.ctrl
        if plane is None or plane.rx is None:
            return self.reader.read_frame(timeout=timeout)
        return _ctrl.read_frame_polled(self.reader.read_frame,
                                       self._ctrl_drain, plane, timeout)

    def _rdv_deliver(self, stream_id: int, flags: int, body) -> None:
        """A completed rendezvous request payload: the stream's next
        message, aliasing its landing region (and, when it half-closes the
        stream, the inline claim the sink's commit makes)."""
        with self._lock:
            st = self._streams.get(stream_id)
        if st is None:
            return
        st.commit_external(body, bool(flags & fr.FLAG_END_STREAM))
        if flags & fr.FLAG_END_STREAM:
            self._inline_complete(st)

    def _dispatch(self, f: fr.Frame) -> None:
        if f.type == fr.PING:
            if (self.rdv is not None
                    and f.payload.startswith(_rdv.HELLO_PAYLOAD)):
                # the hello's tail is the peer's descriptor-ring blob
                self.rdv.on_peer_hello(f.payload)
                if self.ctrl is not None:
                    self.ctrl.on_hello(f.payload[len(_rdv.HELLO_PAYLOAD):])
            self.writer.send(fr.PONG, 0, 0, f.payload)
            return
        if f.type == fr.CTRL_KICK:
            return  # the wake was the delivery: the read loop drains
        if f.type in fr.RDV_OP_OF_FRAME:
            if self.rdv is not None:
                self.rdv.on_op(fr.RDV_OP_OF_FRAME[f.type], f.stream_id,
                               f.payload)
            return
        if f.type == fr.PONG:
            return
        if f.type == fr.GOAWAY:
            raise EndpointError("client sent GOAWAY")
        with self._lock:
            st = self._streams.get(f.stream_id)
        if f.type == fr.HEADERS:
            if st is not None:
                raise fr.FrameError(f"duplicate HEADERS for stream {f.stream_id}")
            self._start_stream(f)
            return
        if st is None:
            return  # frame for a finished/cancelled stream
        if f.type == fr.RST:
            st.cancel()
            self._finish_stream(st)
        else:
            raise fr.FrameError(f"unexpected frame {f!r}")

    def _start_stream(self, f: fr.Frame) -> None:
        path, timeout_us, metadata = fr.parse_headers(f.payload)
        st = _ServerStream(f.stream_id,
                           queue_depth=get_config().stream_queue_depth,
                           recv_limit=self.server.max_receive_message_length)
        # Health RPCs are admitted even while draining: the drain contract
        # is that the health service ANSWERS NOT_SERVING — a refused probe
        # reads as death, not as leaving rotation.
        st.is_probe = path.startswith("/grpc.health.")
        with self._lock:
            # the server's flag closes the adoption race: a connection
            # dialed into a draining server can dispatch HEADERS before it
            # is marked draining
            rejected = ((self.draining or self.server._draining)
                        and not st.is_probe)
            if not rejected:
                self._streams[f.stream_id] = st
                self.streams_started += 1
        if rejected:
            self.writer.send(fr.RST, fr.FLAG_REFUSED, f.stream_id,
                             fr.rst_payload(StatusCode.UNAVAILABLE,
                                            "connection draining"))
            return
        # health probes are exempt: an overloaded backend must keep
        # answering its LB's probes or shedding reads as death
        gate = self.server.admission
        if gate is not None and not st.is_probe:
            pushback_ms = gate.try_admit()
            if pushback_ms is not None:
                _SRV_SHED.inc()
                inflight_now = gate.inflight()
                _flight.emit(_flight.ADMIT_REJECT, _SRV_ADMIT_TAG,
                             inflight_now, pushback_ms)
                self._send_trailers(
                    st, StatusCode.UNAVAILABLE,
                    f"server overloaded: admission rejected "
                    f"({inflight_now} in flight); retry after "
                    f"{pushback_ms}ms",
                    [(PUSHBACK_KEY, str(pushback_ms))])
                self._finish_stream(st)
                return
            st.gate = gate  # released exactly once in _finish_stream
        deadline = (None if timeout_us is None
                    else time.monotonic() + timeout_us / 1e6)
        # a traced caller's context: the HEADERS-to-handler-start interval
        # becomes the "dispatch" span
        st.trace_ctx = _extract_trace(metadata)
        st.trace_t0 = time.monotonic_ns() if st.trace_ctx is not None else 0
        handler = self.server._lookup_intercepted(path, metadata)
        if handler is None:
            self._send_trailers(st, StatusCode.UNIMPLEMENTED,
                                f"unknown method {path}")
            self._finish_stream(st)
            return
        ctx = ServerContext(self, st, metadata, deadline)
        st.context = ctx
        if getattr(handler, "inline", False):
            # the reactor path: the sink's commit runs the handler on this
            # reader thread when the request completes. A declared deadline
            # gets a watchdog on the wheel: a client that never sends the
            # body would otherwise park the call (and, with _streams not
            # empty, the keepalive reaper) for good
            st.inline_call = (handler, ctx, path)
            if deadline is not None:
                st.inline_timer = _timers.schedule(
                    max(0.0, deadline - time.monotonic()),
                    lambda: _timers.run_blocking(
                        lambda: self._inline_deadline(st)))
            return
        self._submit(handler, st, ctx, path)

    def _submit(self, handler: RpcMethodHandler, st: _ServerStream,
                ctx: ServerContext, path: str) -> None:
        try:
            self.server._pool.submit(self._run_handler, handler, st, ctx, path)
        except RuntimeError:  # pool shut down: server is stopping
            self._send_trailers(st, StatusCode.UNAVAILABLE, "server shutting down")
            self._finish_stream(st)
            self.close()  # make the client redial instead of retrying here

    def _claim_inline(self, st: _ServerStream):
        """Take a parked inline call atomically: the request's completion
        and the deadline watchdog race for it, and exactly one runs."""
        with self._lock:
            ic, st.inline_call = st.inline_call, None
        if ic is not None and st.inline_timer is not None:
            st.inline_timer.cancel()
            st.inline_timer = None
        return ic

    def _inline_complete(self, st: _ServerStream) -> None:
        """The request of ``st`` completed: run its inline call, if any."""
        ic = self._claim_inline(st)
        if ic is not None:
            handler, ctx, path = ic
            self._run_inline(handler, st, ctx, path)

    def _run_inline(self, handler: RpcMethodHandler, st: _ServerStream,
                    ctx: ServerContext, path: str) -> None:
        """The first level runs on the calling (reader) thread; a nested
        inline completion goes to the pool (see ``_inline_tls``)."""
        if getattr(_inline_tls, "active", False):
            self._submit(handler, st, ctx, path)
            return
        _inline_tls.active = True
        try:
            self._run_handler(handler, st, ctx, path)
        finally:
            _inline_tls.active = False

    def _inline_deadline(self, st: _ServerStream) -> None:
        if self._claim_inline(st) is not None:
            _flight.emit(_flight.DEADLINE_EXPIRED, _SRV_INLINE_TAG,
                         st.stream_id)
            self._send_trailers(st, StatusCode.DEADLINE_EXCEEDED,
                                "deadline exceeded awaiting request")
            self._finish_stream(st)

    def _run_handler(self, handler: RpcMethodHandler, st: _ServerStream,
                     ctx: ServerContext, path: str) -> None:
        counters = self.server.call_counters
        counters.on_start()
        ok = False
        tctx = st.trace_ctx
        if tctx is not None and st.trace_t0:
            # HEADERS arrival to handler start: the queue/handoff interval
            _tracing.record("dispatch", tctx, st.trace_t0,
                            time.monotonic_ns() - st.trace_t0, method=path)
        # the stall watchdog sweeps in-flight handlers and names the stage
        # of any call past its method's rolling-p99 multiple
        wd_tok = _watchdog.call_started(
            path, tctx.trace_id if tctx is not None else 0)
        t0 = time.perf_counter_ns()
        t0_mono = time.monotonic_ns()
        try:
            with (_tracing.use(tctx) if tctx is not None
                  else _tracing.NULL_CM), _stats.profile("srv_handler"):
                ok = bool(self._run_handler_inner(handler, st, ctx, path))
        finally:
            counters.on_finish(ok)
            _SRV_CALL_US.record((time.perf_counter_ns() - t0) // 1000)
            code = (st.final_code if st.final_code is not None
                    else StatusCode.CANCELLED)
            _SRV_CALLS.labels(path, int(code)).inc()
            _watchdog.call_finished(wd_tok, error=not ok)
            # tail capture: commit the provisional span tree iff the call
            # was slow for its method or failed
            _tracing.tail_decide(tctx, time.monotonic_ns() - t0_mono,
                                 error=not ok, method=path)

    def _run_handler_inner(self, handler: RpcMethodHandler, st: _ServerStream,
                           ctx: ServerContext, path: str) -> bool:
        """Run one call to its trailers; True iff it ended OK."""
        try:
            if handler.request_streaming:
                request_in = st.request_iterator(handler.request_deserializer, ctx)
            else:
                try:
                    # honor the deadline while waiting for the request body
                    item = st.next_request(timeout=ctx.deadline_remaining())
                except queue.Empty:
                    self._send_trailers(st, StatusCode.DEADLINE_EXCEEDED,
                                        "deadline exceeded awaiting request")
                    return
                if item is _ServerStream._OVERSIZED:
                    self._send_trailers(
                        st, StatusCode.RESOURCE_EXHAUSTED,
                        f"received message larger than max ({st.recv_limit} bytes)")
                    return
                if item is _ServerStream._BAD_COMPRESSION:
                    self._send_trailers(
                        st, StatusCode.INTERNAL,
                        "compressed message failed to decompress")
                    return
                if item is _ServerStream._END or not ctx.is_active():
                    if ctx.is_active():
                        self._send_trailers(
                            st, StatusCode.INVALID_ARGUMENT,
                            "client half-closed before sending a request")
                    return
                request_in = _deserialize(handler.request_deserializer, item)

            result = handler.behavior(request_in, ctx)

            if handler.response_streaming:
                for response in result:
                    if not ctx.is_active():
                        return
                    if ctx._deadline_exceeded():
                        self._send_trailers(st, StatusCode.DEADLINE_EXCEEDED,
                                            "deadline exceeded", ctx._trailing)
                        return
                    # the mirror is read per send: a request-streaming
                    # handler sets peer_compressed only once its iterator
                    # consumed a compressed message
                    self.writer.send(
                        fr.MESSAGE,
                        fr.FLAG_COMPRESSED if st.peer_compressed else 0,
                        st.stream_id, handler.response_serializer(response))
                if ctx.is_active():
                    code = ctx._code if ctx._code is not None else StatusCode.OK
                    self._send_trailers(st, code, ctx._details, ctx._trailing)
                    return code is StatusCode.OK
            elif ctx.is_active():
                # unary response: MESSAGE + TRAILERS in one transport write
                code = ctx._code if ctx._code is not None else StatusCode.OK
                st.final_code = code
                try:
                    # serialization and the gathered write: "respond"
                    with (_tracing.span("respond", st.trace_ctx)
                          if st.trace_ctx is not None
                          else _tracing.NULL_CM):
                        self.writer.send_many([
                            (fr.MESSAGE,
                             fr.FLAG_COMPRESSED if st.peer_compressed
                             else 0,
                             st.stream_id,
                             handler.response_serializer(result)),
                            (fr.TRAILERS, fr.FLAG_END_STREAM, st.stream_id,
                             fr.trailers_payload(code, ctx._details,
                                                 list(ctx._trailing)
                                                 + self.server._load_md())),
                        ])
                except fr.FrameError:
                    self._send_trailers(st, StatusCode.INTERNAL,
                                        "trailing metadata too large")
                    return False
                return code is StatusCode.OK
        except AbortError as exc:
            self._send_trailers(st, exc.code, exc.details, ctx._trailing)
        except (EndpointError, OSError):
            pass  # connection already gone
        except Exception as exc:  # handler bug → UNKNOWN, like grpcio
            _log.exception("handler for %s raised", path)
            self._send_trailers(st, StatusCode.UNKNOWN,
                                f"Exception calling application: {exc}")
        finally:
            self._finish_stream(st)
        return False

    def _send_trailers(self, st: _ServerStream, code: StatusCode, details: str,
                       metadata: Metadata = ()) -> None:
        # every terminal response piggybacks the (cached) load report —
        # the least_loaded policy's per-response feed
        st.final_code = code
        md = list(metadata) + self.server._load_md()
        try:
            try:
                self.writer.send(fr.TRAILERS, fr.FLAG_END_STREAM, st.stream_id,
                                 fr.trailers_payload(code, details, md))
            except fr.FrameError:
                # user trailing metadata too large for one control frame
                self.writer.send(
                    fr.TRAILERS, fr.FLAG_END_STREAM, st.stream_id,
                    fr.trailers_payload(StatusCode.INTERNAL,
                                        "trailing metadata too large"))
        except (EndpointError, OSError):
            pass

    def _finish_stream(self, st: _ServerStream) -> None:
        with self._lock:
            self._streams.pop(st.stream_id, None)
            gate, st.gate = st.gate, None
            drained = self.draining and not self._streams and self.alive
        if gate is not None:
            gate.release()
        if drained:
            self.linger_then_close()

    #: after GOAWAY, wait this long before closing: a HEADERS frame already
    #: in flight from a client that has not read the GOAWAY yet is answered
    #: with a refusal instead of a dead connection
    GOAWAY_LINGER_S = 1.0

    def linger_then_close(self) -> None:
        with self._lock:
            if self._linger_timer is not None:
                return
            # close() shuts an endpoint: off the wheel thread
            self._linger_timer = _timers.schedule(
                self.GOAWAY_LINGER_S, lambda: _timers.run_blocking(self.close))

    def goaway(self, why: bytes) -> bool:
        """Mark the connection draining and tell the client; True when it
        had no stream in flight (the caller lingers, then closes)."""
        with self._lock:
            if not self.alive or self.draining:
                return False
            self.draining = True
            empty = not self._streams
        try:
            self.writer.send(fr.GOAWAY, 0, 0, why)
        except (EndpointError, OSError, fr.FrameError):
            return False  # connection already dying
        return empty

    def _shutdown(self) -> None:
        with self._lock:
            if not self.alive:
                return
            self.alive = False
            streams = list(self._streams.values())
            self._streams.clear()
        for h in (self._linger_timer, self._ka_handle, self._age_timer):
            if h is not None:
                h.cancel()  # wheel handles; the ticks also check alive
        if self.rdv is not None:
            # peer gone mid-rendezvous: claimed landing regions are released
            self.rdv.close()
        if self.ctrl is not None:
            # descriptor rings die with the connection (a straggler's late
            # slot store lands in the orphaned mapping: dead memory)
            self.ctrl.close()
        for st in streams:
            gate, st.gate = st.gate, None
            if gate is not None:
                gate.release()  # the connection died with it admitted
            st.cancel()
        try:
            self.endpoint.close()
        except Exception:
            pass
        self.server._forget(self)

    def close(self) -> None:
        try:
            self.endpoint.close()  # unblocks the reader thread
        except Exception:
            pass


class Server:
    """Thread-pooled RPC server over any Endpoint source."""

    def __init__(self, max_workers: int = 32, interceptors: Sequence = (),
                 max_receive_message_length: Optional[int] = None,
                 admission: Optional[AdmissionGate] = None):
        #: server interceptors (``tpurpc_torch.rpc.interceptors``), applied
        #: at every handler lookup on both wire planes
        self.interceptors = list(interceptors)
        #: overload admission gate: the one given, else the environment's
        #: (``TPURPC_ADMISSION_MAX_INFLIGHT``); None admits everything
        self.admission = (admission if admission is not None
                          else AdmissionGate.from_env())
        self._draining = False
        self._health_servicer = None  # set by HealthServicer.add_to_server
        self._load_reports = os.environ.get(
            "TPURPC_LOAD_REPORTS", "1").lower() not in ("0", "off", "false")
        self._load_extra: Optional[Callable[[], int]] = None
        self._load_cache: Tuple[float, Optional[list]] = (0.0, None)
        self._drain_hooks: List[Callable[[], None]] = []
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="tpurpc-handler")
        #: per-message receive bound (None = config default; -1 = unlimited)
        self.max_receive_message_length = get_config().resolve_recv_limit(
            max_receive_message_length)
        from tpurpc_torch.rpc import channelz as _channelz

        #: channelz ServerData counters (started/succeeded/failed)
        self.call_counters = _channelz.CallCounters()
        _channelz.register_server(self)
        self._methods: Dict[str, RpcMethodHandler] = {}
        self._generic_handlers: list = []
        self._listeners: List[EndpointListener] = []
        self.bound_ports: List[int] = []
        self._connections: List[_ServerConnection] = []
        self._lock = threading.Lock()
        self._stopping = False  # set under _lock before conns are torn down
        self._serving = threading.Event()
        self._stopped = threading.Event()

    def add_method(self, path: str, handler: RpcMethodHandler) -> None:
        self._methods[path] = handler

    @staticmethod
    def _adapt_foreign_handler(h) -> Optional[RpcMethodHandler]:
        """grpc.RpcMethodHandler (any object with grpcio's attribute set)
        → ours; None if it is not one."""
        if isinstance(h, RpcMethodHandler):
            return h
        try:
            kind = (("stream" if h.request_streaming else "unary") + "_"
                    + ("stream" if h.response_streaming else "unary"))
            behavior = getattr(h, kind)
        except AttributeError:
            return None
        if behavior is None:
            return None
        return RpcMethodHandler(kind, behavior,
                                h.request_deserializer or _identity,
                                h.response_serializer or _identity)

    def add_generic_handlers(self, handlers: Dict[str, RpcMethodHandler]) -> None:
        """Register ``{path: handler}`` at once."""
        self._methods.update(handlers)

    def add_generic_rpc_handlers(self, generic_handlers) -> None:
        """grpcio-shaped: a sequence of GenericRpcHandler objects whose
        ``.service(handler_call_details)`` resolves methods at call time,
        or ``{path: handler}`` mappings
        (:func:`method_handlers_generic_handler`)."""
        self._generic_handlers.extend(generic_handlers)

    def add_registered_method_handlers(self, service: str,
                                       method_handlers) -> None:
        """grpcio-shaped (grpcio >= 1.60, which generated modules call
        beside :meth:`add_generic_rpc_handlers`): eager registration of
        ``{name: handler}``, grpcio's handler objects adapted to ours."""
        for name, h in dict(method_handlers).items():
            adapted = self._adapt_foreign_handler(h)
            if adapted is not None:
                self._methods[f"/{service}/{name}"] = adapted

    def add_service(self, service: str,
                    method_handlers: Dict[str, RpcMethodHandler]) -> None:
        """Register ``{name: handler}`` under ``/service/name``."""
        self.add_generic_handlers(
            method_handlers_generic_handler(service, method_handlers))

    def _lookup_intercepted(self, path: str,
                            metadata=()) -> Optional[RpcMethodHandler]:
        """Handler lookup through the server interceptor chain."""
        handler = self._lookup(path, metadata)
        if not self.interceptors:
            return handler
        from tpurpc_torch.rpc.interceptors import apply_server_interceptors

        return apply_server_interceptors(handler, path, metadata,
                                         self.interceptors)

    def _lookup(self, path: str, metadata=()) -> Optional[RpcMethodHandler]:
        handler = self._methods.get(path)
        if handler is not None:
            return handler
        for gh in self._generic_handlers:
            getter = getattr(gh, "get", None)
            cacheable = getter is not None
            if cacheable:  # mapping-shaped: metadata-independent
                found = getter(path)
            else:
                try:
                    found = gh.service(_HandlerCallDetails(path, metadata))
                except Exception:
                    # a routing bug must not masquerade as UNIMPLEMENTED
                    _log.exception(
                        "generic handler %r raised resolving %s", gh, path)
                    continue
            if found is not None:
                adapted = self._adapt_foreign_handler(found)
                if adapted is not None and cacheable:
                    # .service() results are not cached: a generic handler
                    # may route on metadata per call
                    self._methods[path] = adapted
                return adapted
        return None

    def add_insecure_port(self, address: str, *,
                          reuseport: bool = False) -> int:
        """Bind now and return the real port (the port for ":0" is known
        before start); connections are accepted once the server starts.

        ``reuseport=True`` is the listener-sharding mode: shard workers bind
        the SAME port with ``SO_REUSEPORT`` and the kernel spreads accepts
        across them (see :class:`tpurpc_torch.rpc.shard.ShardedServer`)."""
        host, _, port = address.rpartition(":")
        return self._open_port(host or "0.0.0.0", int(port),
                               reuseport=reuseport)

    def add_secure_port(self, address: str, server_credentials) -> int:
        """A TLS port (grpcio-shaped): every connection handshakes before
        the protocol sniff, so native framing, a ring bootstrap and h2 all
        ride the encrypted stream; a plaintext client is closed at the
        handshake. Pass :func:`tpurpc_torch.rpc.credentials.
        ssl_server_credentials`'s result."""
        host, _, port = address.rpartition(":")
        return self._open_port(host or "0.0.0.0", int(port),
                               ssl_context=server_credentials._context)

    def _open_port(self, host: str, port: int, ssl_context=None,
                   reuseport: bool = False) -> int:
        listener = EndpointListener(host, port, self.serve_endpoint,
                                    ready=self._serving, reuseport=reuseport,
                                    ssl_context=ssl_context,
                                    admission=self._accept_pushback)
        self._listeners.append(listener)
        self.bound_ports.append(listener.port)
        return listener.port

    def _accept_pushback(self) -> "Optional[int]":
        """The admission gate's face on the accept path: the listener sheds
        new connections before any handshake work while the RPC plane is
        saturated."""
        gate = self.admission
        if gate is None:
            return None
        return gate.connection_pushback_ms()

    def adopt_socket(self, sock: socket.socket) -> None:
        """Serve a connection that was ACCEPTED ELSEWHERE (the shard
        supervisor's accept loop, delivered over SCM_RIGHTS) as this
        server's own listener would: the platform's endpoint factory (the
        device ring on ``TPU``), then the protocol sniff. Runs off the
        caller's thread: a ring bootstrap blocks, and the worker's control
        loop must not stall behind one silent client."""

        def _adopt():
            try:
                peer = sock.getpeername()
                host = peer[0] if isinstance(peer, tuple) else str(peer)
                ep = create_endpoint(sock, is_server=True,
                                     pool_key=f"peer:{host}")
            except Exception as exc:
                trace_server.log("handoff bootstrap failed: %s", exc)
                try:
                    sock.close()
                except OSError:
                    pass
                return
            self.serve_endpoint(ep)

        threading.Thread(target=_adopt, daemon=True,
                         name="tpurpc-handoff").start()

    def start(self) -> "Server":
        self._serving.set()
        return self

    def serve_endpoint(self, endpoint: Endpoint) -> None:
        """Adopt a connected endpoint; the preface is read on its own thread
        (the client may not have written a byte yet)."""
        threading.Thread(target=self._sniff_and_serve, args=(endpoint,),
                         daemon=True, name="tpurpc-sniff").start()

    def _sniff_and_serve(self, endpoint: Endpoint) -> None:
        """The first 8 bytes decide: the native magic routes to
        :class:`_ServerConnection`, ``PRI * HT`` (the h2 connection
        preface) to :class:`GrpcH2Connection`."""
        first = bytearray(8)
        got = 0
        try:
            while got < len(first):
                n = endpoint.read_into(memoryview(first)[got:], timeout=30)
                if n == 0:
                    endpoint.close()
                    return
                got += n
        except (EndpointError, TimeoutError):
            endpoint.close()
            return
        try:
            if bytes(first) == fr.MAGIC:
                conn = _ServerConnection(self, endpoint)
            elif bytes(first) == b"PRI * HT":
                from tpurpc_torch.wire.grpc_h2 import GrpcH2Connection

                conn = GrpcH2Connection(self, endpoint, preface_consumed=8)
            else:
                trace_server.log("unknown protocol preface %r; dropping",
                                 bytes(first))
                endpoint.close()
                return
        except (EndpointError, OSError) as exc:
            # the peer vanished mid-adoption (the h2 path writes SETTINGS
            # during construction): contained to this connection
            trace_server.log("peer gone during adoption: %s", exc)
            endpoint.close()
            return
        # registration is atomic against stop(): a connection adopted after
        # stop() closed the others would answer every call "shutting down"
        with self._lock:
            adopted = not self._stopping
            drain_new = self._draining
            if adopted:
                self._connections.append(conn)
        if not adopted:
            conn.close()
        elif drain_new:
            # a connection dialed into a draining server is told at once
            conn.goaway(b"server drain")
            conn.linger_then_close()

    def _forget(self, conn: _ServerConnection) -> None:
        with self._lock:
            try:
                self._connections.remove(conn)
            except ValueError:
                pass

    def stop(self, grace: Optional[float] = None) -> threading.Event:
        for listener in self._listeners:
            listener.close()
        self._listeners.clear()
        with self._lock:
            self._stopping = True
            conns = list(self._connections)
        if grace:
            # GOAWAY: clients stop opening streams; in-flight calls run on
            # through the grace window
            for conn in conns:
                if getattr(conn, "writer", None) is None:
                    conn.goaway(b"server shutdown")  # h2's own GOAWAY
                    continue
                with conn._lock:
                    conn.draining = True
                try:
                    conn.writer.send(fr.GOAWAY, 0, 0, b"server shutdown")
                except (EndpointError, OSError, fr.FrameError):
                    pass
            deadline = time.monotonic() + grace
            while time.monotonic() < deadline:
                with self._lock:
                    busy = any(c._streams for c in self._connections)
                if not busy:
                    break
                time.sleep(0.01)
        for conn in conns:
            conn.close()
        self._pool.shutdown(wait=False)
        self._stopped.set()
        return self._stopped

    def set_load_provider(self, fn: Optional[Callable[[], int]]) -> None:
        """Register an extra queue-depth signal for the load report —
        serve_torch wires the FanInBatcher's queue depth here, so the
        ``least_loaded`` policy sees requests parked BEHIND the transport
        (the batcher is where overload actually queues on a model server);
        generation serving wires ``DecodeScheduler.load_depth`` (waiting
        AND swapped)."""
        self._load_extra = fn

    def _load_md(self) -> list:
        """The ORCA-style piggyback: ``[(LOAD_KEY, "i,q,p99ms")]`` appended
        to every terminal response's trailing metadata, or ``[]`` when
        disabled (``TPURPC_LOAD_REPORTS=0``).

        Cached ~20 ms so the per-response cost is one monotonic read plus a
        list concat — load is a trend, not a fence, and the client-side
        EWMA smooths staleness anyway. Inflight comes from the admission
        gate's own counter when one is installed, else from
        :meth:`inflight_requests`. The p99 is the stall watchdog's worst
        rolling p99 (``0.0`` until a method has history)."""
        if not self._load_reports:
            return []
        now = time.monotonic()
        stamp, cached = self._load_cache
        if cached is not None and now - stamp < 0.02:
            return cached
        gate = self.admission
        inflight = (gate.inflight() if gate is not None
                    else self.inflight_requests())
        qdepth = 0
        extra = self._load_extra
        if extra is not None:
            try:
                qdepth = int(extra())
            except Exception:
                qdepth = 0
        p99_ms = 0.0
        p99 = _watchdog.get().rolling_p99_ns()
        if p99:
            p99_ms = p99 / 1e6
        md = [(LOAD_KEY, f"{inflight},{qdepth},{p99_ms:.1f}")]
        self._load_cache = (now, md)
        return md

    def add_drain_hook(self, fn: Callable[[], None]) -> None:
        """Register a callback the first :meth:`drain` runs after the
        GOAWAY round and before it waits out in-flight streams (stateful
        serving migrates live sequences here). Exceptions are swallowed: a
        failed hook degrades to a plain drain."""
        self._drain_hooks.append(fn)

    @property
    def draining(self) -> bool:
        """True between :meth:`drain` and :meth:`stop`."""
        return self._draining and not self._stopped.is_set()

    def drain(self, linger: float = 5.0) -> bool:
        """Server-wide graceful drain: an attached health servicer flips
        every service to NOT_SERVING, every connection gets a GOAWAY
        (streams that race it are refused, and connections opened during
        the drain are told at adoption; health probes are still answered),
        the drain hooks run, and in-flight streams finish within ``linger``
        seconds. The server stays up; call :meth:`stop` afterwards. True iff
        every in-flight stream other than a health probe finished in time.
        A second call just waits again."""
        with self._lock:
            first = not self._draining
            self._draining = True
            conns = list(self._connections)
        if first:
            _flight.emit(_flight.DRAIN_BEGIN, _SRV_DRAIN_TAG, len(conns))
            hs = self._health_servicer
            if hs is not None:
                from tpurpc_torch.rpc.health import ServingStatus

                hs.set_all(ServingStatus.NOT_SERVING)
            for conn in conns:
                if conn.goaway(b"server drain"):
                    conn.linger_then_close()
            for hook in list(self._drain_hooks):
                try:
                    hook()
                except Exception:
                    pass  # a failed hook degrades to a plain drain
        deadline = time.monotonic() + max(0.0, linger)
        while True:
            with self._lock:
                # health probes (Check and held-open Watch streams) are
                # admitted during drain and must not count against it
                remaining = sum(1 for c in self._connections
                                for st in list(c._streams.values())
                                if not st.is_probe)
            if remaining == 0 or time.monotonic() >= deadline:
                break
            time.sleep(0.01)
        if first:
            _flight.emit(_flight.DRAIN_END, _SRV_DRAIN_TAG, remaining)
        return remaining == 0

    def wait_for_termination(self, timeout: Optional[float] = None) -> bool:
        return self._stopped.wait(timeout)

    def inflight_requests(self) -> int:
        """Number of currently open inbound streams across connections —
        requests admitted (HEADERS seen) whose response hasn't finished.
        The FanInBatcher's depth-aware flush probe (serve_torch wiring):
        when its queue holds this many, no further arrival can happen until
        responses go out, so it flushes instead of waiting out max_delay_s.
        A snapshot, not a fence — callers must tolerate staleness."""
        with self._lock:
            conns = list(self._connections)
        return sum(len(c._streams) for c in conns)


def server(thread_pool=None, handlers=None, interceptors=None, options=None,
           maximum_concurrent_rpcs=None, compression=None, *,
           max_workers: int = 32) -> Server:
    """grpcio-shaped constructor: accepts the stock call
    ``grpc.server(ThreadPoolExecutor(max_workers=N), options=[...])``
    verbatim. A passed executor contributes its worker count (the Server
    keeps its own pool), handlers and interceptors register directly, the
    ``grpc.max_receive_message_length`` option maps onto the Server, and
    ``maximum_concurrent_rpcs`` and ``compression`` are accepted and
    advisory. A bare int first argument is ``max_workers``."""
    if isinstance(thread_pool, int):
        max_workers = thread_pool
    elif thread_pool is not None:
        workers = getattr(thread_pool, "_max_workers", None)
        if workers:
            max_workers = workers
    max_recv = None
    if options:
        max_recv = dict(options).get("grpc.max_receive_message_length")
    srv = Server(max_workers=max_workers, interceptors=interceptors or (),
                 max_receive_message_length=max_recv)
    if handlers:
        srv.add_generic_rpc_handlers(handlers)
    return srv


def inproc_channel(srv: Server):
    """A channel wired to ``srv`` in process: each dial is a passthru
    endpoint pair whose far end the server adopts (the in-process
    transport; no ring, so no device ring either)."""
    from tpurpc_torch.core.endpoint import passthru_endpoint_pair
    from tpurpc_torch.rpc.channel import Channel

    def factory():
        a, b = passthru_endpoint_pair()
        srv.serve_endpoint(b)
        return a

    return Channel(endpoint_factory=factory)


class _ServerModule(types.ModuleType):
    """This module, callable as grpcio's ``server()`` factory: with
    ``import tpurpc_torch.rpc as grpc``, ``grpc.server(...)`` calls
    :func:`server`, while ``from tpurpc_torch.rpc import server`` still gives
    the module (the reference's package rebinds the name to the function)."""

    def __call__(self, *args, **kwargs):
        return server(*args, **kwargs)


sys.modules[__name__].__class__ = _ServerModule
