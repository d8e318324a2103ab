"""gRPC-over-HTTP/2 server connection: stock gRPC clients reach port servers.

A copy of ``tpurpc/wire/grpc_h2.py``. A connection whose first bytes are the
h2 preface (sniffed in ``Server._sniff_and_serve``) lands here instead of the
native framing; the same registered ``RpcMethodHandler``s serve both
protocols.

Implements the gRPC HTTP/2 protocol mapping: POST /Service/Method,
``content-type: application/grpc``, 5-byte length-prefixed messages in DATA,
``grpc-timeout`` deadlines, trailers with ``grpc-status``/``grpc-message``
(percent-encoded), ``-bin`` metadata as unpadded base64, flow control both
directions, gzip/deflate request decoding, and the rendezvous link over the
gRPC wire (a peer that advertises ``SETTINGS_TPURPC_RDV`` moves bulk
messages one-sided; a stock peer never sees the extension frame).

Observability, under the reference's names: the ``h2-framing`` profiler
stage, the ``h2_server_connections`` and ``h2_server_send_window_bytes``
fleet gauges, the ``srv_calls{method,code}`` counter shared with the native
framing, ``H2_WINDOW_EXHAUSTED`` under ``h2srv:<peer>`` when a send is
about to block on peer credit, the ``h2_data_coalesce`` histogram, the
adoption of the ``tpurpc-trace`` header with the handler's ``dispatch``
span and tail decision, and the watchdog's ``call_started`` and
``call_finished``. Beyond the reference: :meth:`GrpcH2Connection.goaway`
names the last stream the connection took, and a stream that arrives after
it is refused (``RST_STREAM`` ``REFUSED_STREAM``, which a client may replay)
unless it is a health probe; the reference's GOAWAY names stream 0 and its
connection goes on serving. ``H2ServerContext`` has no ``device_ring``: a
``device=True`` tensor method served over h2 decodes on the host.
"""

from __future__ import annotations

import base64
import gzip
import logging
import queue
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from tpurpc_torch.core import rendezvous as _rdv
from tpurpc_torch.core.endpoint import Endpoint, EndpointError
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _obs_metrics
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.obs import tracing as _tracing
from tpurpc_torch.obs import watchdog as _watchdog
from tpurpc_torch.rpc.status import AbortError, Metadata, StatusCode
from tpurpc_torch.utils import stats as _stats
from tpurpc_torch.utils import timers as _timers
from tpurpc_torch.wire import h2
from tpurpc_torch.wire.hpack import HpackDecoder, HpackEncoder, HpackError

_log = logging.getLogger("tpurpc_torch.grpc_h2")

_GRPC_MSG_HDR = struct.Struct("!BI")

#: RFC 7540 §7: the stream was not processed and may be retried
REFUSED_STREAM = 0x7

#: the reference's trace-context header: transport-internal, never surfaced
#: to handlers (the port carries no tracing)
# message <-> frame translation on the server h2 plane is h2-framing work
_LENS_STAGES = {
    "send_message": "h2-framing",
    "_send_unary_fused": "h2-framing",
    "_on_data": "h2-framing",
    "_read_loop": "h2-framing",
}
_profiler.register_stages(__file__, _LENS_STAGES)

#: live h2 server connections and their send-side connection window, read
#: at scrape time only
_H2_SRV_CONNS = _obs_metrics.fleet("h2_server_connections")
_H2_SRV_WINDOW = _obs_metrics.fleet("h2_server_send_window_bytes",
                                    lambda c: c._conn_window._value)
#: per-method, per-status RED counters, shared with the native framing
_SRV_CALLS = _obs_metrics.labeled_counter("srv_calls", ("method", "code"))


def _frame_grpc_message(payload) -> bytearray:
    """gRPC length-prefix framing in ONE preallocated buffer.

    ``payload`` may be bytes-like or a serializer gather list; either way
    the 5-byte header + every segment lands with a single staging copy."""
    parts = payload if isinstance(payload, (list, tuple)) else (payload,)
    views = [memoryview(p).cast("B") for p in parts]
    total = sum(len(v) for v in views)
    data = bytearray(_GRPC_MSG_HDR.size + total)
    _GRPC_MSG_HDR.pack_into(data, 0, 0, total)
    pos = _GRPC_MSG_HDR.size
    for v in views:
        data[pos:pos + len(v)] = v
        pos += len(v)
    return data


def decode_grpc_message(msg: bytes, compressed: int, encoding: str):
    """Per-message decompression per the gRPC spec; shared by the h2 server
    and client. Returns ``(message, None)`` or ``(None, (status, details))``:
    compressed-flag with identity encoding is INTERNAL (spec/grpcio parity),
    unknown codecs are UNIMPLEMENTED, corrupt bodies are INTERNAL."""
    if not compressed:
        return msg, None
    if encoding == "gzip":
        try:
            return gzip.decompress(msg), None
        except (OSError, EOFError, zlib.error):
            return None, (StatusCode.INTERNAL, "corrupt gzip message")
    if encoding == "deflate":
        # gRPC "deflate" is a raw zlib stream (RFC 1950), grpcio parity
        try:
            return zlib.decompress(msg), None
        except zlib.error:
            return None, (StatusCode.INTERNAL, "corrupt deflate message")
    if encoding == "identity":
        return None, (StatusCode.INTERNAL,
                      "compressed-flag set with identity grpc-encoding")
    return None, (StatusCode.UNIMPLEMENTED,
                  f"message encoding {encoding!r} not supported "
                  "(accept: identity, gzip, deflate)")


#: our receive windows (we grant aggressively; tensors are big)
RECV_WINDOW = 4 << 20


def _parse_timeout(value: str) -> Optional[float]:
    try:
        unit = value[-1]
        n = int(value[:-1])
    except (ValueError, IndexError):
        return None
    return n * {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6,
                "n": 1e-9}.get(unit, None) if unit in "HMSmun" else None


def _pct_encode(msg: str) -> str:
    out = []
    for b in msg.encode("utf-8"):
        if 0x20 <= b <= 0x7E and b != 0x25:
            out.append(chr(b))
        else:
            out.append(f"%{b:02X}")
    return "".join(out)


def _decode_metadata_value(key: str, value: bytes):
    if key.endswith("-bin"):
        pad = -len(value) % 4
        return base64.b64decode(value + b"=" * pad)
    return value.decode("utf-8", "replace")


def _encode_metadata_value(key: str, value) -> str:
    if key.endswith("-bin"):
        raw = value if isinstance(value, (bytes, bytearray)) else str(value).encode()
        return base64.b64encode(raw).decode().rstrip("=")
    return value.decode() if isinstance(value, (bytes, bytearray)) else str(value)


class _H2Stream:
    _END = object()

    def __init__(self, stream_id: int):
        self.stream_id = stream_id
        self.requests: "queue.Queue[object]" = queue.Queue()
        self.partial = bytearray()   # gRPC message assembly across DATA frames
        self.recv_encoding = "identity"  # request grpc-encoding
        self.half_closed = False
        self.cancelled = threading.Event()
        self.window: Optional[h2.FlowWindow] = None  # send window, set by conn
        self.headers_sent = False
        #: a health probe: admitted after a GOAWAY, not counted by a drain
        self.is_probe = False
        self.trace_ctx = None
        #: the status the trailers carried (``srv_calls``' code label)
        self.final_code: Optional[StatusCode] = None


class H2ServerContext:
    """grpcio-compatible context for handlers reached over the h2 path."""

    def __init__(self, conn: "GrpcH2Connection", stream: _H2Stream,
                 metadata: List[Tuple[str, object]],
                 deadline: Optional[float]):
        self._conn = conn
        self._stream = stream
        self._metadata = metadata
        self._deadline = deadline
        self._trailing: Metadata = ()
        self._code: Optional[StatusCode] = None
        self._details = ""

    def invocation_metadata(self):
        return list(self._metadata)

    def peer(self) -> str:
        return self._conn.endpoint.peer

    def deadline_remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    time_remaining = deadline_remaining

    def is_active(self) -> bool:
        return not self._stream.cancelled.is_set()

    def cancel(self) -> None:
        self._stream.cancelled.set()

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
        self._conn.send_response_headers(self._stream, metadata)

    def _deadline_exceeded(self) -> bool:
        return self._deadline is not None and time.monotonic() > self._deadline


class GrpcH2Connection:
    """One accepted h2 connection serving gRPC semantics."""

    #: after GOAWAY, wait this long before closing an idle connection (the
    #: native connection's linger)
    GOAWAY_LINGER_S = 1.0

    def __init__(self, server, endpoint: Endpoint,
                 preface_consumed: int = 0):
        self.server = server
        self.endpoint = endpoint
        self._scanner = h2.FrameScanner()
        self._decoder = HpackDecoder()
        self._encoder = HpackEncoder()
        self._write_lock = threading.Lock()
        self._streams: Dict[int, _H2Stream] = {}
        self._lock = threading.Lock()
        self._peer_max_frame = h2.DEFAULT_MAX_FRAME
        self._peer_initial_window = h2.DEFAULT_WINDOW
        self._conn_window = h2.FlowWindow(h2.DEFAULT_WINDOW)  # our sends
        self._preface_left = len(h2.PREFACE) - preface_consumed
        self._headers_frag: Optional[Tuple[int, int, bytearray]] = None
        self.alive = True
        #: GOAWAY sent; streams above ``_last_sid`` are refused
        self.draining = False
        self._last_sid = 0
        self._linger_timer: Optional[_timers.TimerHandle] = None
        self._ftag = _flight.tag_for("h2srv:" + getattr(endpoint, "peer",
                                                        "?"))
        _H2_SRV_CONNS.track(self)
        _H2_SRV_WINDOW.track(self)
        # arm the rendezvous link; the custom SETTINGS id in _send_settings
        # is the capability advert, and only a peer that advertised it back
        # ever sees an RDV frame
        self.rdv = _rdv.link_for_endpoint(
            endpoint, "h2srv:" + getattr(endpoint, "peer", "?"),
            self._rdv_send_op, self._rdv_deliver)
        self._send_settings()
        self._thread = threading.Thread(target=self._read_loop, daemon=True,
                                        name="tpurpc-h2-reader")
        self._thread.start()

    # -- writing -------------------------------------------------------------

    def _write(self, segs: List[bytes]) -> None:
        with self._write_lock:
            self.endpoint.write(segs)

    def _send_settings(self) -> None:
        settings = {
            h2.SETTINGS_MAX_CONCURRENT_STREAMS: 1024,
            h2.SETTINGS_INITIAL_WINDOW_SIZE: RECV_WINDOW,
            h2.SETTINGS_MAX_FRAME_SIZE: h2.DEFAULT_MAX_FRAME,
        }
        if self.rdv is not None:
            settings[h2.SETTINGS_TPURPC_RDV] = 1
        self._write(h2.pack_settings(settings))
        # lift the connection-level receive window too
        self._write(h2.pack_window_update(0, RECV_WINDOW - h2.DEFAULT_WINDOW))

    def _header_block_segs(self, sid: int, block: bytes,
                           end_stream: bool) -> List[bytes]:
        """One logical header block as HEADERS (+ CONTINUATIONs when the
        encoded block exceeds the peer's SETTINGS_MAX_FRAME_SIZE), returned
        as gather segments. END_HEADERS only on the last fragment."""
        limit = self._peer_max_frame
        es = h2.FLAG_END_STREAM if end_stream else 0
        frags = [block[i:i + limit] for i in range(0, len(block), limit)] or [b""]
        segs: List[bytes] = []
        for i, frag in enumerate(frags):
            ftype = h2.HEADERS if i == 0 else h2.CONTINUATION
            flags = es if ftype == h2.HEADERS else 0
            if i == len(frags) - 1:
                flags |= h2.FLAG_END_HEADERS
            segs.extend(h2.pack_frame(ftype, flags, sid, frag))
        return segs

    def _response_header_segs(self, st: _H2Stream,
                              metadata: Metadata = ()) -> List[bytes]:
        """Initial-metadata HEADERS segments (marks them sent), or [] when
        already sent — the building block send paths gather into one write."""
        if st.headers_sent:
            return []
        st.headers_sent = True
        hdrs = [(":status", "200"), ("content-type", "application/grpc"),
                ("grpc-accept-encoding", "identity,gzip,deflate")]
        for k, v in metadata:
            hdrs.append((k.lower(), _encode_metadata_value(k.lower(), v)))
        return self._header_block_segs(st.stream_id,
                                       self._encoder.encode(hdrs),
                                       end_stream=False)

    def send_response_headers(self, st: _H2Stream, metadata: Metadata = ()) -> None:
        segs = self._response_header_segs(st, metadata)
        if segs:
            self._write(segs)

    # -- rendezvous plumbing --------------------------------------------------

    def _rdv_send_op(self, op: int, stream_id: int, payload: bytes) -> None:
        self._write(h2.pack_frame(h2.TPURPC_RDV, op, stream_id, payload))

    def _rdv_deliver(self, stream_id: int, flags: int, body) -> None:
        """A completed rendezvous request payload: the stream's next gRPC
        message, bypassing DATA reassembly and flow control entirely
        (flags bit 0 = the sender half-closed with this message)."""
        with self._lock:
            st = self._streams.get(stream_id)
        if st is None:
            return
        st.requests.put(body)
        if flags & 0x01:
            st.half_closed = True
            st.requests.put(_H2Stream._END)

    def send_message(self, st: _H2Stream, payload) -> None:
        rdv = self.rdv
        if rdv is not None:
            segs = ([memoryview(s).cast("B") for s in payload]
                    if isinstance(payload, (list, tuple)) else
                    [memoryview(payload).cast("B")])
            segs = [s for s in segs if len(s)]
            total = sum(len(s) for s in segs)
            if rdv.eligible(total) and rdv.send_message(
                    st.stream_id, 0, segs, total):
                return  # one-sided write done; COMPLETE frame already sent
        mv = memoryview(_frame_grpc_message(payload))
        pos = 0
        while pos < len(mv):
            want = min(len(mv) - pos, self._peer_max_frame)
            if st.window._value <= 0 or self._conn_window._value <= 0:
                # about to block on peer credit: the watchdog's
                # h2-flow-control evidence (once per starved chunk)
                _flight.emit(_flight.H2_WINDOW_EXHAUSTED, self._ftag,
                             st.stream_id)
            got = st.window.take(want, timeout=120)
            try:
                conn_got = self._conn_window.take(got, timeout=120)
            except Exception:
                # give the stream-window reservation back, then surface a
                # status instead of dying trailers-less
                st.window.grant(got)
                raise AbortError(StatusCode.UNAVAILABLE,
                                 "flow-control stalled: peer stopped granting "
                                 "window credit") from None
            if conn_got < got:  # return the stream window over-reservation
                st.window.grant(got - conn_got)
                got = conn_got
            self._write(h2.pack_frame(h2.DATA, 0, st.stream_id,
                                      mv[pos:pos + got]))
            pos += got

    def _trailer_segs(self, st: _H2Stream, code: StatusCode, details: str,
                      metadata: Metadata = ()) -> List[bytes]:
        hdrs = [("grpc-status", str(int(code)))]
        if details:
            hdrs.append(("grpc-message", _pct_encode(details)))
        for k, v in metadata:
            hdrs.append((k.lower(), _encode_metadata_value(k.lower(), v)))
        return self._header_block_segs(st.stream_id,
                                       self._encoder.encode(hdrs),
                                       end_stream=True)

    def send_trailers(self, st: _H2Stream, code: StatusCode, details: str,
                      metadata: Metadata = ()) -> None:
        # initial metadata (when still unsent) and trailers gather into ONE
        # endpoint write — trailers-only responses cost a single syscall
        st.final_code = code
        segs = self._response_header_segs(st)
        segs += self._trailer_segs(st, code, details, metadata)
        self._write(segs)

    def _send_unary_fused(self, st: _H2Stream, payload, code: StatusCode,
                          details: str, metadata: Metadata = ()) -> bool:
        """The unary fast path: initial metadata + the whole response message
        + trailers in ONE gather write, when the message fits a single DATA
        frame and both flow-control windows can reserve it without blocking.
        Returns False (nothing written) to use the chunked blocking path."""
        data = _frame_grpc_message(payload)
        if len(data) > self._peer_max_frame or st.window is None:
            return False
        if not st.window.try_take(len(data)):
            return False
        if not self._conn_window.try_take(len(data)):
            st.window.grant(len(data))
            return False
        st.final_code = code
        segs = self._response_header_segs(st)
        segs += h2.pack_frame(h2.DATA, 0, st.stream_id, data)
        segs += self._trailer_segs(st, code, details, metadata)
        self._write(segs)
        return True

    # -- reading -------------------------------------------------------------

    def _read_loop(self) -> None:
        if self.rdv is not None:
            # big responses from reader-thread contexts must never park
            # here waiting for a CLAIM this thread would deliver
            self.rdv.disallowed_thread = threading.get_ident()
        scratch = bytearray(1 << 16)
        mv = memoryview(scratch)
        try:
            while True:
                if self._preface_left > 0:
                    n = self.endpoint.read_into(mv[:self._preface_left])
                    if n == 0:
                        return
                    self._preface_left -= n
                    continue
                frames = self._scanner.next_frames()
                if not frames:
                    n = self.endpoint.read_into(mv)
                    if n == 0:
                        return
                    self._scanner.feed(mv[:n])
                    continue
                self._dispatch_burst(frames)
        except (EndpointError, h2.H2Error, HpackError, OSError) as exc:
            _log.debug("h2 connection error: %s", exc)
        finally:
            self._shutdown()

    def _dispatch_burst(self, frames) -> None:
        """Dispatch one transport read's worth of frames, coalescing runs of
        consecutive DATA frames on the same stream into a single payload
        span (one ``_on_data`` per run instead of per frame)."""
        i = 0
        n = len(frames)
        while i < n:
            ftype, flags, sid, payload = frames[i]
            if ftype != h2.DATA or self._headers_frag is not None:
                self._dispatch(ftype, flags, sid, payload)
                i += 1
                continue
            datas = [h2.strip_padding(flags, payload, has_priority=False)]
            consumed = len(payload)
            last_flags = flags
            j = i + 1
            while (j < n and not last_flags & h2.FLAG_END_STREAM):
                ft2, fl2, sid2, pl2 = frames[j]
                if ft2 != h2.DATA or sid2 != sid:
                    break
                datas.append(h2.strip_padding(fl2, pl2, has_priority=False))
                consumed += len(pl2)
                last_flags = fl2
                j += 1
            if j - i > 1:
                _stats.batch_hist("h2_data_coalesce").record(j - i)
            self._on_data(sid, last_flags,
                          datas if len(datas) > 1 else datas[0],
                          consumed)
            i = j

    def _dispatch(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if self._headers_frag is not None and ftype != h2.CONTINUATION:
            raise h2.H2Error("expected CONTINUATION")
        if ftype == h2.SETTINGS:
            if flags & h2.FLAG_ACK:
                return
            settings = h2.parse_settings(payload)
            h2.validate_settings(settings)  # RFC 7540 §6.5.2 ranges
            with self._write_lock:
                # process-all-then-ACK in ONE write-lock hold: a handler
                # thread that observed an enlarged max-frame / window can
                # only reach the socket behind the ACK queued here
                if h2.SETTINGS_MAX_FRAME_SIZE in settings:
                    self._peer_max_frame = settings[
                        h2.SETTINGS_MAX_FRAME_SIZE]
                if h2.SETTINGS_INITIAL_WINDOW_SIZE in settings:
                    new = settings[h2.SETTINGS_INITIAL_WINDOW_SIZE]
                    delta = new - self._peer_initial_window
                    self._peer_initial_window = new
                    with self._lock:
                        for st in self._streams.values():
                            st.window.adjust(delta)
                self.endpoint.write(h2.pack_settings({}, ack=True))
            if settings.get(h2.SETTINGS_TPURPC_RDV) and self.rdv is not None:
                self.rdv.on_peer_hello()
        elif ftype == h2.PING:
            if not flags & h2.FLAG_ACK:
                self._write(h2.pack_frame(h2.PING, h2.FLAG_ACK, 0, payload))
        elif ftype == h2.WINDOW_UPDATE:
            inc = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
            if sid == 0:
                self._conn_window.grant(inc)
            else:
                with self._lock:
                    st = self._streams.get(sid)
                if st is not None:
                    st.window.grant(inc)
        elif ftype == h2.HEADERS:
            block = h2.strip_padding(flags, payload, has_priority=True)
            if flags & h2.FLAG_END_HEADERS:
                self._on_headers(sid, block, bool(flags & h2.FLAG_END_STREAM))
            else:
                self._headers_frag = (sid, flags, bytearray(block))
        elif ftype == h2.CONTINUATION:
            if self._headers_frag is None or self._headers_frag[0] != sid:
                raise h2.H2Error("unexpected CONTINUATION")
            fsid, fflags, buf = self._headers_frag
            buf += payload
            if flags & h2.FLAG_END_HEADERS:
                self._headers_frag = None
                self._on_headers(fsid, bytes(buf),
                                 bool(fflags & h2.FLAG_END_STREAM))
        elif ftype == h2.DATA:
            self._on_data(sid, flags,
                          h2.strip_padding(flags, payload, has_priority=False),
                          len(payload))
        elif ftype == h2.RST_STREAM:
            with self._lock:
                st = self._streams.pop(sid, None)
            if st is not None:
                st.cancelled.set()
                st.requests.put(_H2Stream._END)
        elif ftype == h2.TPURPC_RDV:
            if self.rdv is not None:  # never sent un-negotiated
                self.rdv.on_op(flags, sid, payload)
        elif ftype == h2.GOAWAY:
            raise h2.H2Error("client sent GOAWAY")
        # PRIORITY / PUSH_PROMISE / unknown: ignore

    def _on_headers(self, sid: int, block: bytes, end_stream: bool) -> None:
        headers = self._decoder.decode(block)
        with self._lock:
            existing = self._streams.get(sid)
        if existing is not None:  # client trailers — treat as half-close
            existing.half_closed = True
            existing.requests.put(_H2Stream._END)
            return
        pseudo = {}
        metadata: List[Tuple[str, object]] = []
        timeout_s: Optional[float] = None
        encoding = "identity"
        trace_raw: Optional[bytes] = None
        for name_b, value_b in headers:
            name = name_b.decode("ascii", "replace")
            if name.startswith(":"):
                pseudo[name] = value_b.decode("ascii", "replace")
            elif name == "grpc-timeout":
                timeout_s = _parse_timeout(value_b.decode("ascii", "replace"))
            elif name == "grpc-encoding":
                encoding = value_b.decode("ascii", "replace")
            elif name == _tracing.HEADER:
                # transport-internal like te and content-type: consumed
                # here, never surfaced to handlers
                trace_raw = value_b
            elif name in ("te", "content-type", "user-agent",
                          "grpc-accept-encoding", "accept-encoding"):
                pass  # transport-level, not surfaced as metadata (grpcio parity)
            else:
                metadata.append((name, _decode_metadata_value(name, value_b)))
        path = pseudo.get(":path", "")
        st = _H2Stream(sid)
        st.recv_encoding = encoding
        st.is_probe = path.startswith("/grpc.health.")
        if trace_raw is not None and _tracing.LIVE:
            st.trace_ctx = _tracing.adopt(trace_raw)
        st.window = h2.FlowWindow(self._peer_initial_window)
        with self._lock:
            # the server's flag closes the adoption race, as on the native
            # plane: a connection dialed into a draining server can
            # dispatch HEADERS before it is told
            refused = ((self.draining or self.server._draining)
                       and sid > self._last_sid and not st.is_probe)
            if not refused:
                self._streams[sid] = st
                self._last_sid = max(self._last_sid, sid)
        if refused:
            self._write(h2.pack_rst(sid, REFUSED_STREAM))
            return
        if end_stream:
            st.half_closed = True
            st.requests.put(_H2Stream._END)
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        handler = self.server._lookup_intercepted(path, metadata)
        if handler is None:
            self.send_trailers(st, StatusCode.UNIMPLEMENTED,
                               f"unknown method {path}")
            self._finish(st)
            return
        ctx = H2ServerContext(self, st, metadata, deadline)
        try:
            self.server._pool.submit(self._run_handler, handler, st, ctx, path)
        except RuntimeError:  # pool shut down: server is stopping
            self.send_trailers(st, StatusCode.UNAVAILABLE,
                               "server shutting down")
            self._finish(st)
            # a connection whose server cannot run handlers kills itself so
            # clients redial
            self.close()

    def _on_data(self, sid: int, flags: int, data,
                 consumed: int) -> None:
        """``data`` is the padding-stripped payload — one bytes-like, or a
        LIST of them for a coalesced run of DATA frames; ``consumed`` the
        flow-control bytes the run occupied on the wire (RFC 7540 §6.9
        counts padding)."""
        with self._lock:
            st = self._streams.get(sid)
        # flow control: grant back what we consumed, always (even on unknown
        # streams — the bytes crossed the connection window regardless).
        # Both grants ride ONE endpoint write.
        if consumed:
            segs = h2.pack_window_update(0, consumed)
            if st is not None:
                segs = segs + h2.pack_window_update(sid, consumed)
            self._write(segs)
        if st is None:
            return
        if isinstance(data, list):
            for d in data:
                st.partial += d
        else:
            st.partial += data
        while True:
            if len(st.partial) < _GRPC_MSG_HDR.size:
                break
            compressed, length = _GRPC_MSG_HDR.unpack_from(st.partial)
            if len(st.partial) < _GRPC_MSG_HDR.size + length:
                break
            # one copy out of the reassembly buffer via a released view
            mv = memoryview(st.partial)
            msg = mv[_GRPC_MSG_HDR.size:_GRPC_MSG_HDR.size + length].tobytes()
            mv.release()
            del st.partial[:_GRPC_MSG_HDR.size + length]
            msg, err = decode_grpc_message(msg, compressed, st.recv_encoding)
            if err is not None:
                self.send_trailers(st, err[0], err[1])
                self._finish(st)
                return
            st.requests.put(msg)
        if flags & h2.FLAG_END_STREAM:
            st.half_closed = True
            st.requests.put(_H2Stream._END)

    # -- handler execution ----------------------------------------------------

    def _request_iterator(self, st: _H2Stream, deserializer, ctx):
        while True:
            # the deadline applies while awaiting the next client message
            # too: a client that stalls without half-closing must not pin a
            # worker past grpc-timeout
            try:
                item = st.requests.get(timeout=ctx.deadline_remaining())
            except queue.Empty:
                ctx.cancel()
                raise AbortError(StatusCode.DEADLINE_EXCEEDED,
                                 "deadline exceeded awaiting request") from None
            if item is _H2Stream._END:
                return
            if not ctx.is_active():
                return
            yield deserializer(item)

    def _run_handler(self, handler, st: _H2Stream, ctx: H2ServerContext,
                     path: str) -> None:
        counters = self.server.call_counters
        counters.on_start()
        ok = False
        tctx = st.trace_ctx
        wd_tok = _watchdog.call_started(
            path, tctx.trace_id if tctx is not None else 0)
        t0 = time.monotonic_ns()
        try:
            with _tracing.use(tctx) if tctx is not None \
                    else _tracing.NULL_CM:
                with (_tracing.span("dispatch", tctx, method=path)
                      if tctx is not None else _tracing.NULL_CM):
                    ok = bool(self._run_handler_inner(handler, st, ctx, path))
        finally:
            counters.on_finish(ok)
            code = st.final_code if st.final_code is not None \
                else StatusCode.CANCELLED
            _SRV_CALLS.labels(path, int(code)).inc()
            _watchdog.call_finished(wd_tok, error=not ok)
            _tracing.tail_decide(tctx, time.monotonic_ns() - t0,
                                 error=not ok, method=path)

    def _run_handler_inner(self, handler, st: _H2Stream,
                           ctx: H2ServerContext, path: str) -> bool:
        """Run one call to its trailers; True iff it ended OK."""
        try:
            if handler.request_streaming:
                request_in = self._request_iterator(
                    st, handler.request_deserializer, ctx)
            else:
                try:
                    item = st.requests.get(timeout=ctx.deadline_remaining())
                except queue.Empty:
                    self.send_trailers(st, StatusCode.DEADLINE_EXCEEDED,
                                       "deadline exceeded awaiting request")
                    return
                if item is _H2Stream._END or not ctx.is_active():
                    if ctx.is_active():
                        self.send_trailers(
                            st, StatusCode.INVALID_ARGUMENT,
                            "client half-closed before sending a request")
                    return
                request_in = handler.request_deserializer(item)

            result = handler.behavior(request_in, ctx)

            if handler.response_streaming:
                self.send_response_headers(st)
                for response in result:
                    if not ctx.is_active():
                        return
                    if ctx._deadline_exceeded():
                        self.send_trailers(st, StatusCode.DEADLINE_EXCEEDED,
                                           "deadline exceeded", ctx._trailing)
                        return
                    self.send_message(st, handler.response_serializer(response))
            elif ctx.is_active():
                # unary: headers + message + trailers fuse into one endpoint
                # write when windows allow; else the chunked path below
                code = ctx._code if ctx._code is not None else StatusCode.OK
                payload = handler.response_serializer(result)
                if self._send_unary_fused(st, payload, code, ctx._details,
                                          ctx._trailing):
                    return code is StatusCode.OK
                self.send_response_headers(st)
                self.send_message(st, payload)
            else:
                self.send_response_headers(st)
            if ctx.is_active():
                code = ctx._code if ctx._code is not None else StatusCode.OK
                self.send_trailers(st, code, ctx._details, ctx._trailing)
                return code is StatusCode.OK
        except AbortError as exc:
            self.send_trailers(st, exc.code, exc.details, ctx._trailing)
        except (EndpointError, h2.H2Error, OSError):
            pass  # connection gone
        except Exception as exc:  # handler bug → UNKNOWN, like grpcio
            _log.exception("h2 handler for %s raised", path)
            self.send_trailers(st, StatusCode.UNKNOWN,
                               f"Exception calling application: {exc}")
        finally:
            self._finish(st)
        return False

    def _finish(self, st: _H2Stream) -> None:
        with self._lock:
            self._streams.pop(st.stream_id, None)
            drained = self.draining and not self._streams and self.alive
        if drained:
            self.linger_then_close()

    # -- GOAWAY and teardown --------------------------------------------------

    def goaway(self, why: bytes) -> bool:
        """Send h2's GOAWAY naming the last stream taken, and refuse later
        streams; True when no stream was in flight (the caller lingers,
        then closes). A second call sends nothing."""
        with self._lock:
            if not self.alive or self.draining:
                return False
            self.draining = True
            last = self._last_sid
            empty = not self._streams
        try:
            self._write(h2.pack_goaway(last, h2.NO_ERROR, why))
        except (EndpointError, OSError):
            return False  # connection already dying
        return empty

    def linger_then_close(self) -> None:
        with self._lock:
            if self._linger_timer is not None:
                return
            # close() shuts an endpoint: off the wheel thread
            self._linger_timer = _timers.schedule(
                self.GOAWAY_LINGER_S, lambda: _timers.run_blocking(self.close))

    def _shutdown(self) -> None:
        with self._lock:
            if not self.alive:
                return
            self.alive = False
            streams = list(self._streams.values())
            self._streams.clear()
            timer = self._linger_timer
        if timer is not None:
            timer.cancel()
        if self.rdv is not None:
            self.rdv.close()  # peer gone: claimed landing regions release
        self._conn_window.kill()
        for st in streams:
            st.cancelled.set()
            st.window.kill()
            st.requests.put(_H2Stream._END)
        try:
            self.endpoint.close()
        except Exception:
            pass
        self.server._forget(self)

    def close(self) -> None:
        try:
            self.endpoint.close()
        except Exception:
            pass
