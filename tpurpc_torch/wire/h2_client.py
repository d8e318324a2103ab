"""gRPC-over-HTTP/2 client: the port calls stock gRPC servers unchanged.

A copy of ``tpurpc/wire/h2_client.py``, the other half of the drop-in
capability (the server half is ``tpurpc_torch/wire/grpc_h2.py``):
:class:`H2Channel` dials any grpc-compliant server — grpcio, grpc++, a port
or reference server's sniffed h2 path — and exposes the same four
grpcio-shaped multicallables as :class:`tpurpc_torch.rpc.channel.Channel`,
so ``TensorClient(H2Channel(addr))`` works as ``TensorClient(Channel(addr))``
does.

Protocol mapping (gRPC PROTOCOL-HTTP2 spec): connection preface + SETTINGS
exchange; HEADERS with ``:method: POST``, ``:path``, ``te: trailers``,
``content-type: application/grpc``, ``grpc-timeout``, ``-bin`` metadata as
unpadded base64; requests as 5-byte length-prefixed messages in DATA frames
under both send windows; responses with initial metadata, DATA reassembly
and trailers (the trailers-only form too); HPACK with a dynamic encoder
table sized to the peer's SETTINGS_HEADER_TABLE_SIZE; PING ack, RST_STREAM
to a status; and the rendezvous link, negotiated with a peer that
advertises ``SETTINGS_TPURPC_RDV``.

``credentials`` (:func:`tpurpc_torch.rpc.credentials.
ssl_channel_credentials`) dials over TLS with ALPN ``h2``; a failed
handshake closes the socket and raises, and nothing is sent in plaintext.

Observability, under the reference's names: the ``h2-framing`` profiler
stage, the ``h2_client_connections`` and ``h2_client_send_window_bytes``
fleet gauges, ``H2_WINDOW_EXHAUSTED`` under ``h2cli:<target>`` and the
``h2_data_coalesce`` histogram. Beyond the reference: a GOAWAY with NO_ERROR fails
only the calls above the stream it names (the server did not take them); the
calls it took run to their end, new calls fail UNAVAILABLE at once, and the
connection closes when the last one ends. The reference fails every open
call at any GOAWAY.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from tpurpc_torch.core import rendezvous as _rdv
from tpurpc_torch.core.endpoint import (Endpoint, EndpointError, TcpEndpoint,
                                        tls_client_handshake)
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _obs_metrics
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.rpc.status import Metadata, RpcError, StatusCode
from tpurpc_torch.utils import stats as _stats
from tpurpc_torch.wire import h2
from tpurpc_torch.wire.grpc_h2 import (RECV_WINDOW, _decode_metadata_value,
                                       _encode_metadata_value,
                                       decode_grpc_message)
from tpurpc_torch.wire.hpack import HpackDecoder, HpackEncoder, HpackError

_LENS_STAGES = {
    "_send_message": "h2-framing",
    "_on_data": "h2-framing",
    "_read_loop": "h2-framing",
    "_pump": "h2-framing",
}
_profiler.register_stages(__file__, _LENS_STAGES)

#: live h2 client channels and their send-side connection window, read at
#: scrape time only
_H2_CLI_CONNS = _obs_metrics.fleet("h2_client_connections")
_H2_CLI_WINDOW = _obs_metrics.fleet("h2_client_send_window_bytes",
                                    lambda c: c._conn_window._value)

_GRPC_MSG_HDR = struct.Struct("!BI")


def _pct_decode(raw: str) -> str:
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "%" and i + 2 < len(raw):
            try:
                out.append(int(raw[i + 1:i + 3], 16))
                i += 3
                continue
            except ValueError:
                pass
        out.extend(c.encode("utf-8"))
        i += 1
    return out.decode("utf-8", "replace")


def _grpc_timeout(seconds: float) -> str:
    """Largest-unit encoding that fits the spec's 8-digit cap."""
    for unit, scale in (("n", 1e9), ("u", 1e6), ("m", 1e3)):
        v = int(seconds * scale)
        if v < 1e8:
            return f"{max(v, 1)}{unit}"
    return f"{min(int(seconds), 99999999)}S"


class _H2Call:
    """Client-side per-stream state, fed by the reader thread."""

    def __init__(self, stream_id: int, deadline: Optional[float]):
        self.stream_id = stream_id
        self.deadline = deadline
        self.events: "queue.Queue[tuple]" = queue.Queue()
        self.partial = bytearray()   # gRPC message assembly across DATA
        self.recv_encoding = "identity"  # response grpc-encoding
        self.initial_md: Optional[List[Tuple[str, object]]] = None
        self.window: Optional[h2.FlowWindow] = None  # send window
        self.trailing_md: Optional[List[Tuple[str, object]]] = None
        self.code: Optional[StatusCode] = None
        self.details = ""

    # reader-thread side -----------------------------------------------------

    def feed_data(self, chunk: bytes) -> int:
        """Append DATA payload; emit completed gRPC messages. Returns the
        number of flow-control bytes consumed (== len(chunk))."""
        self.partial += chunk
        while len(self.partial) >= 5:
            compressed, length = _GRPC_MSG_HDR.unpack_from(self.partial)
            if len(self.partial) - 5 < length:
                break
            msg = bytes(self.partial[5:5 + length])
            del self.partial[:5 + length]
            msg, err = decode_grpc_message(msg, compressed,
                                           self.recv_encoding)
            if err is not None:
                self.deliver_status(err[0], err[1], [])
                return len(chunk)
            self.events.put(("message", msg))
        return len(chunk)

    def deliver_initial(self, md: List[Tuple[str, object]]) -> None:
        self.initial_md = md
        self.events.put(("initial_metadata", md))

    def deliver_status(self, code: StatusCode, details: str,
                       md: List[Tuple[str, object]]) -> None:
        # record on the call BEFORE queueing: a sender blocked in the flow
        # window needs a non-consuming way to learn the outcome
        self.code = code
        self.details = details
        self.trailing_md = md
        self.events.put(("status", code, details, md))

    # caller side ------------------------------------------------------------

    def _remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def next_event(self) -> tuple:
        remain = self._remaining()
        if remain is not None and remain <= 0:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "deadline exceeded")
        try:
            return self.events.get(timeout=remain)
        except queue.Empty:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "deadline exceeded awaiting response") from None


class H2Channel:
    """A gRPC-over-HTTP/2 client channel (one connection, multiplexed calls).

    grpcio-shaped surface: ``unary_unary`` / ``unary_stream`` /
    ``stream_unary`` / ``stream_stream`` return multicallables accepting
    ``(request, timeout=None, metadata=None)``.
    """

    def __init__(self, target: str, connect_timeout: float = 30.0,
                 authority: Optional[str] = None, credentials=None):
        host, _, port = target.rpartition(":")
        sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                        timeout=connect_timeout)
        ssl_ctx = getattr(credentials, "_context", None)
        if ssl_ctx is not None:
            hostname = (getattr(credentials, "_override_hostname", None)
                        or host or "127.0.0.1")
            sock = tls_client_handshake(sock, ssl_ctx, hostname)
        sock.settimeout(None)
        self._ep: Endpoint = TcpEndpoint(sock)
        self._authority = authority or target
        self._lock = threading.Lock()
        self._wlock = threading.Lock()   # serializes writes + HPACK encoder
        self._calls: Dict[int, _H2Call] = {}
        self._next_stream = 1
        self._dead: Optional[str] = None
        #: why the server said GOAWAY (NO_ERROR): no new calls; taken calls
        #: run to their end, then the connection closes
        self._goaway: Optional[str] = None

        self._enc = HpackEncoder(dynamic=True)
        self._dec = HpackDecoder()
        self._peer_max_frame = h2.DEFAULT_MAX_FRAME
        self._peer_initial_window = h2.DEFAULT_WINDOW
        self._conn_window = h2.FlowWindow(h2.DEFAULT_WINDOW)  # our sends
        self._ftag = _flight.tag_for("h2cli:" + str(target))
        _H2_CLI_CONNS.track(self)
        _H2_CLI_WINDOW.track(self)

        # arm the rendezvous link and advertise the capability in our
        # SETTINGS; it activates only when the server's SETTINGS carry the
        # id back (stock servers never do)
        self.rdv = _rdv.link_for_endpoint(
            self._ep, "h2cli:" + str(target),
            self._rdv_send_op, self._rdv_deliver)
        settings = {h2.SETTINGS_INITIAL_WINDOW_SIZE: RECV_WINDOW,
                    h2.SETTINGS_MAX_FRAME_SIZE: 1 << 20}
        if self.rdv is not None:
            settings[h2.SETTINGS_TPURPC_RDV] = 1
        with self._wlock:
            self._ep.write([h2.PREFACE]
                           + h2.pack_settings(settings)
                           + h2.pack_window_update(0, RECV_WINDOW))
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="tpurpc-h2c-reader")
        self._reader.start()

    # -- connection lifecycle -------------------------------------------------

    def close(self) -> None:
        self._die("channel closed", notify_peer=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _die(self, why: str, notify_peer: bool = False) -> None:
        with self._lock:
            if self._dead is not None:
                return
            self._dead = why
            calls = list(self._calls.values())
            self._calls.clear()
        if notify_peer:
            try:
                with self._wlock:
                    self._ep.write(h2.pack_goaway(0, h2.NO_ERROR))
            except (EndpointError, OSError):
                pass
        if self.rdv is not None:
            self.rdv.close()  # claimed landing regions release on death
        for call in calls:
            if call.window is not None:
                call.window.kill()
            call.deliver_status(StatusCode.UNAVAILABLE, f"connection: {why}", [])
        self._conn_window.kill()
        try:
            self._ep.close()
        except (EndpointError, OSError):
            pass

    def _on_goaway(self, last: int, code: int) -> bool:
        """The server's GOAWAY: True when the connection is done (an error
        code, or no call left that the server took)."""
        why = f"server sent GOAWAY (error {code})"
        if code != h2.NO_ERROR:
            self._die(why)
            return True
        with self._lock:
            self._goaway = why
            refused = [c for sid, c in self._calls.items() if sid > last]
            for call in refused:
                del self._calls[call.stream_id]
            done = not self._calls
        for call in refused:
            if call.window is not None:
                call.window.kill()
            call.deliver_status(StatusCode.UNAVAILABLE,
                                f"stream refused: {why} before taking it", [])
        if done:
            self._die(why)
        return done

    # -- reader thread --------------------------------------------------------

    def _read_loop(self) -> None:
        if self.rdv is not None:
            self.rdv.disallowed_thread = threading.get_ident()
        scanner = h2.FrameScanner()
        hdr_accum: Optional[Tuple[int, int, bytearray]] = None  # sid, flags, block
        pending: List[Tuple[int, int, int, bytes]] = []  # burst being walked
        buf = memoryview(bytearray(1 << 20))
        try:
            while True:
                if not pending:
                    pending = scanner.next_frames()
                if not pending:
                    n = self._ep.read_into(buf)
                    if not n:
                        self._die("server closed connection")
                        return
                    scanner.feed(buf[:n])
                    continue
                ftype, flags, sid, payload = pending[0]
                if hdr_accum is not None and ftype != h2.CONTINUATION:
                    raise h2.H2Error("expected CONTINUATION")
                if ftype == h2.DATA:
                    # coalesce the burst's run of DATA frames for this stream
                    # into ONE reassembly pass + ONE window-update write
                    datas = [h2.strip_padding(flags, payload,
                                              has_priority=False)]
                    consumed = len(payload)
                    taken = 1
                    while (taken < len(pending)
                           and not flags & h2.FLAG_END_STREAM):
                        ft2, fl2, sid2, pl2 = pending[taken]
                        if ft2 != h2.DATA or sid2 != sid:
                            break
                        datas.append(h2.strip_padding(fl2, pl2,
                                                      has_priority=False))
                        consumed += len(pl2)
                        flags = fl2
                        taken += 1
                    del pending[:taken]
                    if taken > 1:
                        _stats.batch_hist("h2_data_coalesce").record(taken)
                    self._on_data(sid, flags,
                                  b"".join(datas) if len(datas) > 1
                                  else datas[0], consumed)
                    continue
                del pending[:1]
                if ftype == h2.HEADERS:
                    block = bytearray(
                        h2.strip_padding(flags, payload, has_priority=True))
                    if flags & h2.FLAG_END_HEADERS:
                        self._on_headers(sid, flags, block)
                    else:
                        hdr_accum = (sid, flags, block)
                elif ftype == h2.CONTINUATION:
                    if hdr_accum is None or hdr_accum[0] != sid:
                        raise h2.H2Error("unexpected CONTINUATION")
                    hdr_accum[2].extend(payload)
                    if flags & h2.FLAG_END_HEADERS:
                        sid0, flags0, block = hdr_accum
                        hdr_accum = None
                        self._on_headers(sid0, flags0, block)
                elif ftype == h2.SETTINGS:
                    self._on_settings(flags, payload)
                elif ftype == h2.WINDOW_UPDATE:
                    self._on_window_update(sid, payload)
                elif ftype == h2.PING:
                    if not flags & h2.FLAG_ACK:
                        with self._wlock:
                            self._ep.write(
                                h2.pack_frame(h2.PING, h2.FLAG_ACK, 0, payload))
                elif ftype == h2.RST_STREAM:
                    (code,) = struct.unpack("!I", payload)
                    call = self._pop_call(sid)
                    if call is not None:
                        call.deliver_status(
                            StatusCode.CANCELLED if code == h2.CANCEL
                            else StatusCode.UNAVAILABLE,
                            f"stream reset by server (h2 error {code})", [])
                elif ftype == h2.TPURPC_RDV:
                    if self.rdv is not None:  # never sent un-negotiated
                        self.rdv.on_op(flags, sid, payload)
                elif ftype == h2.GOAWAY:
                    last, code = struct.unpack_from("!II", payload)
                    if self._on_goaway(last & 0x7FFFFFFF, code):
                        return
                # PRIORITY / PUSH_PROMISE / unknown: ignored
        except (EndpointError, h2.H2Error, HpackError, struct.error, OSError) as exc:
            self._die(f"h2 read loop failed: {exc}")

    def _get_call(self, sid: int) -> Optional[_H2Call]:
        with self._lock:
            return self._calls.get(sid)

    def _pop_call(self, sid: int) -> Optional[_H2Call]:
        with self._lock:
            call = self._calls.pop(sid, None)
            done = (call is not None and self._goaway is not None
                    and not self._calls)
        if call is not None and call.window is not None:
            # the stream is over (trailers/RST/cancel): release any sender
            # blocked in FlowWindow.take — no grant can ever arrive for a
            # dead stream
            call.window.kill()
        if done:
            self._die(self._goaway)
        return call

    def _on_headers(self, sid: int, flags: int, block: bytes) -> None:
        headers = self._dec.decode(block)
        call = self._get_call(sid)
        if call is None:
            return
        md: List[Tuple[str, object]] = []
        grpc_status: Optional[bytes] = None
        grpc_message = b""
        http_status = None
        for k, v in headers:
            key = k.decode("ascii", "replace")
            if key == "grpc-status":
                grpc_status = v
            elif key == "grpc-message":
                grpc_message = v
            elif key == ":status":
                http_status = v
            elif key == "grpc-encoding":
                call.recv_encoding = (v.decode("ascii", "replace")
                                      if isinstance(v, (bytes, bytearray))
                                      else str(v))
            elif (key.startswith(":")
                  or key in ("content-type", "grpc-accept-encoding")):
                continue
            else:
                md.append((key, _decode_metadata_value(key, v)))
        end = bool(flags & h2.FLAG_END_STREAM)
        if grpc_status is not None or end:
            # trailers (or trailers-only response)
            if grpc_status is None:
                code = (StatusCode.UNKNOWN if http_status == b"200"
                        else StatusCode.UNAVAILABLE)
                details = f"stream ended without grpc-status (:status {http_status})"
            else:
                try:
                    code = StatusCode(int(grpc_status))
                except ValueError:
                    code = StatusCode.UNKNOWN
                details = _pct_decode(grpc_message.decode("ascii", "replace"))
            self._pop_call(sid)
            call.trailing_md = md
            call.deliver_status(code, details, md)
        else:
            call.deliver_initial(md)

    def _on_data(self, sid: int, flags: int, data: bytes,
                 consumed: int) -> None:
        """``data`` is padding-stripped (possibly a whole coalesced run of
        DATA frames); ``consumed`` the wire-level flow-control bytes
        (RFC 7540 §6.9: flow control covers the padding too)."""
        call = self._get_call(sid)
        if call is not None and data:
            call.feed_data(data)
        if consumed:
            segs = h2.pack_window_update(0, consumed)
            if call is not None:
                segs = segs + h2.pack_window_update(sid, consumed)
            with self._wlock:
                self._ep.write(segs)
        if flags & h2.FLAG_END_STREAM:
            call2 = self._pop_call(sid)
            if call2 is not None and call2.code is None:
                # DATA+END_STREAM without trailers is a protocol violation in
                # gRPC; surface it rather than hang the caller
                call2.deliver_status(
                    StatusCode.INTERNAL, "stream ended without trailers", [])

    def _on_settings(self, flags: int, payload: bytes) -> None:
        if flags & h2.FLAG_ACK:
            return
        settings = h2.parse_settings(payload)
        h2.validate_settings(settings)  # RFC 7540 §6.5.2 ranges
        with self._wlock:
            # process EVERY setting, then ACK, in ONE write-lock hold
            # (RFC 7540 §6.5.3): a peer may keep enforcing its pre-settings
            # limits until our ACK arrives, and a sender that observed an
            # enlarged value can only reach the socket behind the ACK
            if h2.SETTINGS_MAX_FRAME_SIZE in settings:
                self._peer_max_frame = settings[h2.SETTINGS_MAX_FRAME_SIZE]
            if h2.SETTINGS_INITIAL_WINDOW_SIZE in settings:
                new = settings[h2.SETTINGS_INITIAL_WINDOW_SIZE]
                # one critical section with _start_call's window creation,
                # or a call created in between gets the delta twice
                with self._lock:
                    delta = new - self._peer_initial_window
                    self._peer_initial_window = new
                    calls = list(self._calls.values())
                for call in calls:
                    if call.window is not None:
                        call.window.adjust(delta)
            # indexing stays off until this first SETTINGS is processed
            self._enc.apply_peer_table_size(
                settings.get(h2.SETTINGS_HEADER_TABLE_SIZE, 4096))
            self._ep.write(h2.pack_settings({}, ack=True))
        if settings.get(h2.SETTINGS_TPURPC_RDV) and self.rdv is not None:
            self.rdv.on_peer_hello()

    def _on_window_update(self, sid: int, payload: bytes) -> None:
        (inc,) = struct.unpack("!I", payload)
        inc &= 0x7FFFFFFF
        if sid == 0:
            self._conn_window.grant(inc)
        else:
            call = self._get_call(sid)
            if call is not None and call.window is not None:
                call.window.grant(inc)

    # -- call machinery -------------------------------------------------------

    def _start_call(self, method: str, timeout: Optional[float],
                    metadata: Optional[Metadata]) -> _H2Call:
        deadline = None if timeout is None else time.monotonic() + timeout
        headers: List[Tuple[str, str]] = [
            (":method", "POST"),
            (":scheme", "http"),
            (":path", method),
            (":authority", self._authority),
            ("te", "trailers"),
            ("content-type", "application/grpc"),
            ("grpc-accept-encoding", "identity,gzip,deflate"),
            ("user-agent", "tpurpc-h2/0.1"),
        ]
        if timeout is not None:
            headers.append(("grpc-timeout", _grpc_timeout(timeout)))
        for key, value in metadata or ():
            headers.append((key, _encode_metadata_value(key, value)))
        # sid allocation and the HEADERS write share one critical section:
        # h2 requires new stream ids to appear on the wire in increasing
        # order
        with self._wlock:
            with self._lock:
                if self._dead is not None:
                    raise RpcError(StatusCode.UNAVAILABLE,
                                   f"channel dead: {self._dead}")
                if self._goaway is not None:
                    raise RpcError(StatusCode.UNAVAILABLE,
                                   f"channel draining: {self._goaway}")
                sid = self._next_stream
                self._next_stream += 2
                call = _H2Call(sid, deadline)
                call.window = h2.FlowWindow(self._peer_initial_window)
                self._calls[sid] = call
            block = self._enc.encode(headers)
            frames: List[bytes] = []
            first = True
            while first or block:
                chunk, block = (block[:self._peer_max_frame],
                                block[self._peer_max_frame:])
                flags = (h2.FLAG_END_HEADERS if not block else 0)
                frames.extend(h2.pack_frame(
                    h2.HEADERS if first else h2.CONTINUATION,
                    flags, sid, bytes(chunk)))
                first = False
            try:
                self._ep.write(frames)
            except (EndpointError, OSError) as exc:
                # the connection closed under this HEADERS (a GOAWAY's
                # close racing a call that took its id just before): the
                # server never took the stream, so it fails as refused
                with self._lock:
                    self._calls.pop(sid, None)
                    why = self._dead or self._goaway or str(exc)
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"channel dead: {why}") from exc
        return call

    # -- rendezvous plumbing --------------------------------------------------

    def _rdv_send_op(self, op: int, stream_id: int, payload: bytes) -> None:
        with self._wlock:
            self._ep.write(h2.pack_frame(h2.TPURPC_RDV, op, stream_id,
                                         payload))

    def _rdv_deliver(self, stream_id: int, flags: int, body) -> None:
        """A completed rendezvous response payload: the call's next gRPC
        message, bypassing DATA reassembly and flow control (end-of-stream
        rides trailers on the response direction)."""
        call = self._get_call(stream_id)
        if call is not None:
            call.events.put(("message", body))

    def _send_message(self, call: _H2Call, payload, end: bool) -> None:
        rdv = self.rdv
        if rdv is not None:
            segs = ([memoryview(s).cast("B") for s in payload]
                    if isinstance(payload, (list, tuple)) else
                    [memoryview(payload).cast("B")])
            segs = [s for s in segs if len(s)]
            total = sum(len(s) for s in segs)
            # COMPLETE's flags bit 0 carries the half-close, so the whole
            # message+end costs one one-sided write + one control frame
            if rdv.eligible(total) and rdv.send_message(
                    call.stream_id, 1 if end else 0, segs, total):
                return
        data = (b"".join(bytes(s) for s in payload)
                if isinstance(payload, (list, tuple)) else bytes(payload))
        buf = _GRPC_MSG_HDR.pack(0, len(data)) + data
        view = memoryview(buf)
        while view:
            want = min(len(view), self._peer_max_frame)
            if call.window._value <= 0 or self._conn_window._value <= 0:
                # about to block on peer credit: the watchdog's
                # h2-flow-control evidence
                _flight.emit(_flight.H2_WINDOW_EXHAUSTED, self._ftag,
                             call.stream_id)
            try:
                got = call.window.take(want, timeout=call._remaining())
                conn_got = self._conn_window.take(got,
                                                  timeout=call._remaining())
            except TimeoutError:
                # the deadline passed while flow control starved: a
                # DEADLINE, not a transport failure (grpcio semantics)
                raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                               "deadline exceeded while sending "
                               "(flow-control starved)") from None
            except h2.H2Error:
                # the stream's window was killed: terminated under us. If a
                # real status arrived, surface THAT; stop sending quietly on
                # OK (the server finished without draining the request)
                if call.code is StatusCode.OK:
                    return
                if call.code is not None:
                    raise RpcError(call.code, call.details,
                                   call.trailing_md) from None
                raise RpcError(StatusCode.UNAVAILABLE,
                               "stream closed while sending") from None
            if conn_got < got:
                # another stream drained the shared connection window: give
                # back the stream credit we reserved but cannot send
                call.window.grant(got - conn_got)
                got = conn_got
            chunk = view[:got]
            view = view[got:]
            last = end and not view
            with self._wlock:
                self._ep.write(h2.pack_frame(
                    h2.DATA, h2.FLAG_END_STREAM if last else 0,
                    call.stream_id, bytes(chunk)))

    def _half_close(self, call: _H2Call) -> None:
        with self._wlock:
            self._ep.write(h2.pack_frame(h2.DATA, h2.FLAG_END_STREAM,
                                         call.stream_id, b""))

    def _cancel(self, call: _H2Call) -> None:
        self._pop_call(call.stream_id)
        try:
            with self._wlock:
                self._ep.write(h2.pack_rst(call.stream_id, h2.CANCEL))
        except (EndpointError, OSError):
            pass

    def _messages(self, call: _H2Call):
        """Yield response messages until status; raise on non-OK."""
        while True:
            ev = call.next_event()
            if ev[0] == "initial_metadata":
                continue
            if ev[0] == "message":
                yield ev[1]
                continue
            _, code, details, md = ev
            call.code, call.details = code, details
            if code is not StatusCode.OK:
                raise RpcError(code, details, md)
            return

    # -- grpcio-shaped surface ------------------------------------------------
    # The factories take and ignore extra keywords (grpcio stubs'
    # ``_registered_method``, the tensor service's ``tpurpc_native``): this
    # channel has no native plane to opt out of.

    def unary_unary(self, method: str, request_serializer=None,
                    response_deserializer=None, **_grpcio_kwargs):
        ser = request_serializer or (lambda x: x)
        deser = response_deserializer or (lambda x: x)

        def call_fn(request, timeout: Optional[float] = None,
                    metadata: Optional[Metadata] = None):
            call = self._start_call(method, timeout, metadata)
            try:
                self._send_message(call, ser(request), end=True)
                msgs = list(self._messages(call))
            except (h2.H2Error, EndpointError, TimeoutError) as exc:
                self._cancel(call)
                raise RpcError(StatusCode.UNAVAILABLE, str(exc)) from exc
            except Exception:
                # RpcError, or user code (serializer) blew up: free the
                # server-side stream before propagating
                self._cancel(call)
                raise
            if len(msgs) != 1:
                raise RpcError(StatusCode.INTERNAL,
                               f"expected 1 response message, got {len(msgs)}")
            return deser(msgs[0])

        return call_fn

    def unary_stream(self, method: str, request_serializer=None,
                     response_deserializer=None, **_grpcio_kwargs):
        ser = request_serializer or (lambda x: x)
        deser = response_deserializer or (lambda x: x)

        def call_fn(request, timeout: Optional[float] = None,
                    metadata: Optional[Metadata] = None):
            call = self._start_call(method, timeout, metadata)
            try:
                self._send_message(call, ser(request), end=True)
                for msg in self._messages(call):
                    yield deser(msg)
            except (h2.H2Error, EndpointError, TimeoutError) as exc:
                self._cancel(call)
                raise RpcError(StatusCode.UNAVAILABLE, str(exc)) from exc
            except (Exception, GeneratorExit):
                # tell the server to stop streaming into a consumer that is
                # gone
                self._cancel(call)
                raise

        return call_fn

    def stream_unary(self, method: str, request_serializer=None,
                     response_deserializer=None, **_grpcio_kwargs):
        ser = request_serializer or (lambda x: x)
        deser = response_deserializer or (lambda x: x)

        def call_fn(request_iterator: Iterable,
                    timeout: Optional[float] = None,
                    metadata: Optional[Metadata] = None):
            call = self._start_call(method, timeout, metadata)
            try:
                for req in request_iterator:
                    self._send_message(call, ser(req), end=False)
                self._half_close(call)
                msgs = list(self._messages(call))
            except (h2.H2Error, EndpointError, TimeoutError) as exc:
                self._cancel(call)
                raise RpcError(StatusCode.UNAVAILABLE, str(exc)) from exc
            except Exception:
                self._cancel(call)
                raise
            if len(msgs) != 1:
                raise RpcError(StatusCode.INTERNAL,
                               f"expected 1 response message, got {len(msgs)}")
            return deser(msgs[0])

        return call_fn

    def stream_stream(self, method: str, request_serializer=None,
                      response_deserializer=None, **_grpcio_kwargs):
        ser = request_serializer or (lambda x: x)
        deser = response_deserializer or (lambda x: x)

        def call_fn(request_iterator: Iterable,
                    timeout: Optional[float] = None,
                    metadata: Optional[Metadata] = None):
            call = self._start_call(method, timeout, metadata)

            def _pump():
                try:
                    for req in request_iterator:
                        self._send_message(call, ser(req), end=False)
                    self._half_close(call)
                except (h2.H2Error, EndpointError, TimeoutError, RpcError):
                    self._cancel(call)
                except Exception as exc:
                    # user code (request iterator / serializer) blew up in
                    # the sender thread: cancel AND deliver a status, or the
                    # response consumer blocks forever on an empty queue
                    self._cancel(call)
                    call.deliver_status(
                        StatusCode.INTERNAL,
                        f"request iterator/serializer failed: {exc!r}", [])

            sender = threading.Thread(target=_pump, daemon=True,
                                      name="tpurpc-h2c-sender")
            sender.start()
            try:
                for msg in self._messages(call):
                    yield deser(msg)
            except (RpcError, GeneratorExit):
                self._cancel(call)
                raise
            finally:
                sender.join(timeout=5)

        return call_fn
