"""Client channel: multiplexed calls over one endpoint, with reconnect.

A trimmed copy of ``tpurpc/rpc/channel.py`` (one address, no resolver, load
balancing, retries, hedging, compression or native fast path; a dedicated
reader thread per connection):

* ``Channel`` owns one subchannel that (re)connects with exponential
  backoff and maps transport failure to ``UNAVAILABLE``;
* ``_Connection`` is one live transport: a reader thread demuxing frames to
  per-stream state, a write path serialized by ``FrameWriter``, odd client
  stream ids, and a rendezvous link (``core/rendezvous.py``) that moves
  bulk payloads one-sided;
* ``UnaryUnary`` / ``UnaryStream`` / ``StreamStream`` mirror grpcio's
  multicallables; ``Call.device_ring`` is the ring of the connection the
  call ran on;
* ``PipelinedUnary`` keeps many unary calls in flight on one connection,
  each resolved as a future by the reader thread (no REFUSED-replay
  migration, stall watchdog, pump mode or latency histograms).
"""

from __future__ import annotations

import concurrent.futures
import queue
import random
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

from tpurpc_torch.core import rendezvous as _rdv
from tpurpc_torch.core.endpoint import (Endpoint, EndpointError,
                                        connect_endpoint, device_ring_of)
from tpurpc_torch.rpc import frame as fr
from tpurpc_torch.rpc.status import (Deserializer, Metadata, RpcError,
                                     Serializer, StatusCode,
                                     deserialize as _deserialize,
                                     identity_codec as _identity)
from tpurpc_torch.utils.config import get_config


class _ClientStream:
    """Per-call state the reader thread feeds and the caller drains."""

    def __init__(self, stream_id: int, queue_depth: int = 64):
        self.stream_id = stream_id
        self.events: "queue.Queue[tuple]" = queue.Queue()
        self.initial_metadata: Optional[List[Tuple[str, "str | bytes"]]] = None
        self.assembly = fr.Assembly()
        self.done = False  # trailers or failure delivered
        #: pipelined-call completion hook: invoked (on the delivering thread)
        #: AFTER the terminal event is queued — PipelinedUnary resolves its
        #: future here instead of parking a thread on the event queue
        self.on_terminal: Optional[Callable[[], None]] = None
        #: backpressure: bounded completed-but-unconsumed responses
        self._credits = threading.BoundedSemaphore(max(1, queue_depth))

    def _acquire_credit(self) -> bool:
        while not self._credits.acquire(timeout=0.25):
            if self.done:
                return False
        return True

    def release_credit(self) -> None:
        try:
            self._credits.release()
        except ValueError:
            pass

    def commit_message(self, more: bool, oversized: bool = False
                       ) -> Optional[Tuple[StatusCode, str]]:
        """Returns (code, details) when THIS side failed the stream (an
        oversized payload): the caller owes the server an RST."""
        if more:
            return None
        if oversized:
            self.assembly.oversized = False
            code, details = (StatusCode.RESOURCE_EXHAUSTED,
                             "received message larger than "
                             "max_receive_message_length")
            self.deliver_failure(code, details)
            return code, details
        if self._acquire_credit():
            self.events.put(("message", self.assembly.take()))
        else:
            self.assembly.take()  # stream already finished: drop
        return None

    def commit_external(self, body) -> None:
        """A rendezvous response payload, already whole in its landing
        region (the decode aliases it): the same credit as a framed
        commit."""
        if self._acquire_credit():
            self.events.put(("message", body))

    def deliver_trailers(self, code: StatusCode, details: str, md) -> None:
        # queue first: a pipelined caller that sees ``done`` drains the
        # events at once and must find the trailers there
        self.events.put(("trailers", code, details, md))
        self.done = True
        cb = self.on_terminal
        if cb is not None:
            try:
                cb()
            except Exception:  # a completion hook bug must not kill the
                pass           # reader thread (every stream rides it)

    def deliver_failure(self, code: StatusCode, details: str) -> None:
        self.deliver_trailers(code, details, [])


class _ChannelSink(fr.MessageSink):
    """Routes MESSAGE payload bytes into per-stream assembly buffers."""

    def __init__(self, conn: "_Connection"):
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
        if st is None:
            return
        failed = st.commit_message(bool(flags & fr.FLAG_MORE),
                                   oversized=st.assembly.oversized)
        if failed is not None:
            try:
                self._conn.writer.send(fr.RST, 0, stream_id,
                                       fr.rst_payload(*failed))
            except (EndpointError, OSError):
                pass
            self._conn.close_stream(st)


class _Connection:
    """One live transport: endpoint + reader thread + muxed writer."""

    def __init__(self, endpoint: Endpoint,
                 on_dead: Callable[["_Connection"], None],
                 max_recv_bytes: Optional[int] = None):
        self.endpoint = endpoint
        self.writer = fr.FrameWriter(endpoint)
        self.reader = fr.FrameReader(endpoint)
        self.reader.sink = _ChannelSink(self)
        self.reader.sink.max_message_bytes = max_recv_bytes
        self._streams: Dict[int, _ClientStream] = {}
        self._lock = threading.Lock()
        self._next_stream_id = 1  # odd ids, client-initiated
        self.alive = True
        self.draining = False  # GOAWAY received: no new streams
        self._on_dead = on_dead
        self.writer.send_preface()
        # the rendezvous link and its hello: a PING any peer echoes; only a
        # rendezvous-capable peer answers with its own hello, which arms the
        # link. Until then every payload is framed.
        self.rdv = _rdv.link_for_endpoint(
            endpoint, "chan:" + getattr(endpoint, "peer", "?"),
            self._rdv_send_op, self._rdv_deliver)
        self.writer.rdv = self.rdv
        if self.rdv is not None:
            self.rdv.recv_limit = max_recv_bytes
            # a ring plane negotiated at the pair bootstrap (Address.caps)
            pair = getattr(endpoint, "pair", None)
            if pair is not None and "rdv" in pair.peer_caps:
                self.rdv.on_peer_hello()
            try:
                self.writer.send(fr.PING, 0, 0, _rdv.HELLO_PAYLOAD)
            except (EndpointError, OSError, fr.FrameError):
                pass  # connection dying; the reader surfaces it
        self._thread = threading.Thread(target=self._read_loop, daemon=True,
                                        name="tpurpc-chan-reader")
        self._thread.start()

    def open_stream(self) -> _ClientStream:
        with self._lock:
            if not self.alive:
                raise EndpointError("connection closed")
            if self.draining:
                raise EndpointError("connection draining (GOAWAY)")
            sid = self._next_stream_id
            self._next_stream_id += 2
            st = _ClientStream(sid,
                               queue_depth=get_config().stream_queue_depth)
            self._streams[sid] = st
            return st

    def close_stream(self, st: _ClientStream) -> None:
        with self._lock:
            self._streams.pop(st.stream_id, None)
            finish_drain = self.draining and not self._streams
        if finish_drain:
            self._die("drained after GOAWAY")

    def _read_loop(self) -> None:
        if self.rdv is not None:
            # this thread delivers CLAIMs: a big send here must frame
            self.rdv.disallowed_thread = threading.get_ident()
        try:
            while True:
                f = self.reader.read_frame()
                if f is None:
                    self._die("server closed connection")
                    return
                if f is not fr.CONSUMED:  # MESSAGEs are routed via the sink
                    self._dispatch(f)
        except (EndpointError, fr.FrameError, OSError) as exc:
            self._die(str(exc))

    def _rdv_send_op(self, op: int, stream_id: int, payload: bytes) -> None:
        self.writer.send(fr.RDV_FRAME_OF_OP[op], 0, stream_id, payload)

    def _rdv_deliver(self, stream_id: int, flags: int, body) -> None:
        """A completed rendezvous payload is the stream's next message, in
        frame order, aliasing its landing region."""
        with self._lock:
            st = self._streams.get(stream_id)
        if st is not None:
            st.commit_external(body)

    def _dispatch(self, f: fr.Frame) -> None:
        if f.type == fr.PING:
            if (self.rdv is not None
                    and f.payload.startswith(_rdv.HELLO_PAYLOAD)):
                self.rdv.on_peer_hello(f.payload)
            self.writer.send(fr.PONG, 0, 0, f.payload)
            return
        if f.type in fr.RDV_OP_OF_FRAME:
            if self.rdv is not None:
                self.rdv.on_op(fr.RDV_OP_OF_FRAME[f.type], f.stream_id,
                               f.payload)
            return
        if f.type == fr.PONG:
            return
        if f.type == fr.GOAWAY:
            # stop opening streams here; in-flight calls run to completion
            with self._lock:
                self.draining = True
                empty = not self._streams
            if empty:
                self._die("server sent GOAWAY")
            return
        with self._lock:
            st = self._streams.get(f.stream_id)
        if st is None:
            return  # late frame for a cancelled/finished stream
        if f.type == fr.HEADERS:
            md, _ = fr.decode_metadata(f.payload)
            st.initial_metadata = md
            st.events.put(("initial_metadata", md))
        elif f.type in (fr.TRAILERS, fr.RST):
            code, details, md = fr.parse_trailers(f.payload)
            self.close_stream(st)
            st.deliver_trailers(code, details, md)
        else:
            raise fr.FrameError(f"unexpected frame {f!r}")

    def _die(self, why: str) -> None:
        with self._lock:
            if not self.alive:
                return
            self.alive = False
            streams = list(self._streams.values())
            self._streams.clear()
        if self.rdv is not None:
            # claimed landing regions are released; waiting senders wake
            self.rdv.close()
        for st in streams:
            st.deliver_failure(StatusCode.UNAVAILABLE, f"transport failed: {why}")
        try:
            self.endpoint.close()
        except Exception:
            pass
        self._on_dead(self)

    def close(self) -> None:
        self._die("channel closed")


class Channel:
    """A lazily-(re)connecting client channel to ``"host:port"``, or over an
    injected ``endpoint_factory``."""

    #: reconnect backoff: start 50 ms, cap 2 s, ×1.6, 20% jitter
    _BACKOFF_INITIAL = 0.05
    _BACKOFF_MAX = 2.0
    _BACKOFF_MULT = 1.6

    def __init__(self, target: Optional[str] = None, *,
                 endpoint_factory: Optional[Callable[[], Endpoint]] = None,
                 connect_timeout: float = 30.0,
                 max_receive_message_length: Optional[int] = None):
        if endpoint_factory is None:
            if target is None:
                raise ValueError("need target or endpoint_factory")
            host, _, port = target.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(f"target must be host:port, got {target!r}")
            endpoint_factory = (lambda: connect_endpoint(
                host, int(port), timeout=connect_timeout))
        self._factory = endpoint_factory
        self.max_receive_message_length = get_config().resolve_recv_limit(
            max_receive_message_length)
        self._lock = threading.Lock()          # guards _conn/backoff/_closed
        self._connect_lock = threading.Lock()  # serializes dials
        self._conn: Optional[_Connection] = None
        self._closed = False
        self._backoff = self._BACKOFF_INITIAL
        self._next_attempt = 0.0

    def _live(self) -> Optional[_Connection]:
        conn = self._conn
        if conn is not None and conn.alive and not conn.draining:
            return conn
        return None

    def _connection(self) -> _Connection:
        """The live connection, dialing (after any backoff) if needed."""
        with self._lock:
            if self._closed:
                raise RpcError(StatusCode.UNAVAILABLE, "channel closed")
            conn = self._live()
            if conn is not None:
                return conn
        with self._connect_lock:
            with self._lock:
                conn = self._live()
                if conn is not None:
                    return conn
                wait = self._next_attempt - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            try:
                conn = _Connection(self._factory(), self._on_conn_dead,
                                   max_recv_bytes=self.max_receive_message_length)
            except (OSError, EndpointError) as exc:
                with self._lock:
                    self._next_attempt = (
                        time.monotonic()
                        + self._backoff * (1 + 0.2 * random.random()))
                    self._backoff = min(self._backoff * self._BACKOFF_MULT,
                                        self._BACKOFF_MAX)
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"connect failed: {exc}") from exc
            with self._lock:
                if self._closed:
                    conn.close()
                    raise RpcError(StatusCode.UNAVAILABLE, "channel closed")
                self._backoff = self._BACKOFF_INITIAL
                self._conn = conn
            return conn

    def _on_conn_dead(self, conn: _Connection) -> None:
        with self._lock:
            if self._conn is conn:
                self._conn = None

    def device_ring(self):
        """The live connection's device receive ring, or None off the TPU
        platform. This dials; to decode a response already in hand prefer
        :meth:`Call.device_ring`."""
        return device_ring_of(self._connection().endpoint)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def unary_unary(self, method: str, request_serializer: Serializer = _identity,
                    response_deserializer: Deserializer = _identity) -> "UnaryUnary":
        return UnaryUnary(self, method, request_serializer or _identity,
                          response_deserializer or _identity)

    def unary_stream(self, method: str, request_serializer: Serializer = _identity,
                     response_deserializer: Deserializer = _identity) -> "UnaryStream":
        return UnaryStream(self, method, request_serializer or _identity,
                           response_deserializer or _identity)

    def stream_stream(self, method: str, request_serializer: Serializer = _identity,
                      response_deserializer: Deserializer = _identity) -> "StreamStream":
        return StreamStream(self, method, request_serializer or _identity,
                            response_deserializer or _identity)


class Call:
    """In-flight call handle: response iteration, cancel, metadata."""

    def __init__(self, conn: _Connection, st: _ClientStream,
                 deserializer: Deserializer, deadline: Optional[float]):
        self._conn = conn
        self._st = st
        self._deser = deserializer
        self._deadline = deadline
        self._trailing: Optional[Metadata] = None
        self._code: Optional[StatusCode] = None
        self._details = ""
        self._cancelled = False

    def initial_metadata(self):
        return self._st.initial_metadata or []

    def trailing_metadata(self):
        return self._trailing

    def code(self) -> Optional[StatusCode]:
        return self._code

    def details(self) -> str:
        return self._details

    def cancel(self) -> None:
        if self._code is not None or self._cancelled:
            return
        self._cancelled = True
        try:
            self._conn.writer.send(fr.RST, 0, self._st.stream_id,
                                   fr.rst_payload(StatusCode.CANCELLED,
                                                  "cancelled by client"))
        except (EndpointError, OSError):
            pass
        self._st.deliver_failure(StatusCode.CANCELLED, "cancelled by client")

    def __del__(self):
        # an abandoned streaming call must not wedge the connection's reader
        # on a full credit bound: RST the server and finish the stream
        try:
            self.cancel()
        except Exception:
            pass

    def time_remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def device_ring(self):
        """Device ring of the connection THIS call ran on (None off the TPU
        platform); never dials."""
        return device_ring_of(self._conn.endpoint)

    def _expire(self) -> None:
        """The deadline passed: RST the server and finish the stream."""
        self._code = StatusCode.DEADLINE_EXCEEDED
        self._details = "deadline exceeded"
        try:
            self._conn.writer.send(fr.RST, 0, self._st.stream_id,
                                   fr.rst_payload(StatusCode.DEADLINE_EXCEEDED,
                                                  "deadline exceeded"))
        except (EndpointError, OSError):
            pass
        self._conn.close_stream(self._st)

    def _finish(self, code: StatusCode, details: str, md) -> None:
        self._code, self._details, self._trailing = code, details, md
        self._conn.close_stream(self._st)

    def _next_event(self):
        try:
            return self._st.events.get(timeout=self.time_remaining())
        except queue.Empty:
            self._expire()
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "deadline exceeded awaiting response") from None

    def messages(self) -> Iterator[object]:
        """Yield deserialized responses until trailers; raise on non-OK."""
        while True:
            ev = self._next_event()
            if ev[0] == "initial_metadata":
                continue
            if ev[0] == "message":
                self._st.release_credit()  # slot freed: reader may refill
                yield _deserialize(self._deser, ev[1])
                continue
            _, code, details, md = ev
            self._finish(code, details, md)
            if code is not StatusCode.OK:
                raise RpcError(code, details, md)
            return

    def __iter__(self):
        return self.messages()


_NO_REQUEST = object()


class _MultiCallable:
    def __init__(self, channel: Channel, method: str,
                 serializer: Serializer, deserializer: Deserializer):
        self._channel = channel
        self._method = method
        self._ser = serializer
        self._deser = deserializer

    def _start(self, metadata: Optional[Metadata], timeout: Optional[float],
               first_request=_NO_REQUEST) -> Tuple[_Connection, _ClientStream, Call]:
        """Open a stream and send HEADERS — fused with the only MESSAGE when
        the request is known upfront (one transport write per unary call)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        conn = self._channel._connection()
        try:
            st = conn.open_stream()
        except EndpointError as exc:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"connection closed while starting call: {exc}") from exc
        try:
            timeout_us = (None if deadline is None else
                          max(0, int((deadline - time.monotonic()) * 1e6)))
            hdr = fr.headers_payload(self._method, metadata or (), timeout_us)
            if first_request is _NO_REQUEST:
                conn.writer.send(fr.HEADERS, 0, st.stream_id, hdr)
            else:
                conn.writer.send_many([
                    (fr.HEADERS, 0, st.stream_id, hdr),
                    (fr.MESSAGE, fr.FLAG_END_STREAM, st.stream_id,
                     self._ser(first_request)),
                ])
        except fr.FrameError as exc:
            conn.close_stream(st)
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED, str(exc)) from exc
        except (EndpointError, OSError) as exc:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"transport failed: {exc}") from exc
        return conn, st, Call(conn, st, self._deser, deadline)

    def _send_stream(self, conn: _Connection, st: _ClientStream,
                     request_iterator: Iterable) -> None:
        try:
            for request in request_iterator:
                if st.done:
                    return  # server already terminated the call
                conn.writer.send(fr.MESSAGE, 0, st.stream_id, self._ser(request))
            # pure half-close marker, not an empty message
            conn.writer.send(fr.MESSAGE, fr.FLAG_END_STREAM | fr.FLAG_NO_MESSAGE,
                             st.stream_id, b"")
        except (EndpointError, OSError):
            pass  # the reader surfaces the transport failure with a status
        except Exception as exc:
            # the caller's iterator (or serializer) raised: end both ways
            try:
                conn.writer.send(fr.RST, 0, st.stream_id,
                                 fr.rst_payload(StatusCode.CANCELLED,
                                                f"request iterator raised: {exc}"))
            except (EndpointError, OSError, fr.FrameError):
                pass
            conn.close_stream(st)
            st.deliver_failure(StatusCode.CANCELLED,
                               f"request iterator raised: {exc!r}")


class UnaryUnary(_MultiCallable):
    def __call__(self, request, timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None):
        response, _ = self.with_call(request, timeout=timeout, metadata=metadata)
        return response

    def with_call(self, request, timeout: Optional[float] = None,
                  metadata: Optional[Metadata] = None):
        """``(response, call)``; the call carries the trailing metadata and
        the connection's device ring."""
        _, _, call = self._start(metadata, timeout, first_request=request)
        response = None
        got = False
        for msg in call.messages():
            if got:
                raise RpcError(StatusCode.INTERNAL,
                               "unary call received multiple responses")
            response, got = msg, True
        if not got:
            raise RpcError(StatusCode.INTERNAL, "unary call received no response")
        return response, call

    def future(self, request, timeout: Optional[float] = None,
               metadata: Optional[Metadata] = None
               ) -> "concurrent.futures.Future":
        """Minimal future: runs the call on a daemon thread."""
        fut: "concurrent.futures.Future" = concurrent.futures.Future()

        def run():
            if not fut.set_running_or_notify_cancel():
                return
            try:
                fut.set_result(self(request, timeout, metadata))
            except BaseException as exc:
                fut.set_exception(exc)

        threading.Thread(target=run, daemon=True,
                         name="tpurpc-unary-future").start()
        return fut

    def pipeline(self, depth: int = 16) -> "PipelinedUnary":
        """A bounded-window pipelined caller for this method: many unary
        calls in flight on ONE connection, demuxed by stream id — no
        thread waits on a reply (contrast :meth:`future`, which spawns one
        per call); a deadline costs a timer thread per call."""
        return PipelinedUnary(self, depth=depth)


class PipelinedUnary:
    """Multi-in-flight unary calls over one connection (the serving
    pipeline's client half).

    ``call_async`` sends the fused HEADERS+MESSAGE immediately and returns
    a ``concurrent.futures.Future``; the connection's reader thread demuxes
    completions by stream id and resolves each future in place, so N
    in-flight calls cost N streams, not N threads waiting on replies. A
    call with a deadline does start one ``threading.Timer`` thread, which
    sleeps until the deadline and is cancelled when the call ends. The bounded
    window (``depth``) backpressures callers: the depth+1'th ``call_async``
    blocks until a completion frees a slot, which is what keeps a fast
    client from ballooning server-side queues.

    Completion (including response deserialization) runs on the reader
    thread — keep deserializers cheap (the tensor codec's zero-copy decode
    qualifies). Out-of-order completion across streams is the point: a
    slow call does not head-of-line-block its siblings' futures.
    """

    def __init__(self, mc: UnaryUnary, depth: int = 16):
        self._mc = mc
        self.depth = max(1, int(depth))
        self._window = threading.BoundedSemaphore(self.depth)
        self._lock = threading.Lock()

    def call_async(self, request, timeout: Optional[float] = None,
                   metadata: Optional[Metadata] = None
                   ) -> "concurrent.futures.Future":
        """One pipelined call; returns a Future of the deserialized
        response. Blocks only for a window slot (backpressure), never for
        the response."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if not self._window.acquire(timeout=timeout):
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "deadline exceeded waiting for pipeline window")
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        state = {"claimed": False, "fired": False, "timer": None}

        def claim() -> bool:
            """Once-only: the terminal or the deadline resolves the call."""
            with self._lock:
                if state["claimed"]:
                    return False
                state["claimed"] = True
            self._window.release()
            timer = state["timer"]
            if timer is not None:
                timer.cancel()
            return True

        try:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            _, st, call = self._mc._start(metadata, remaining,
                                          first_request=request)
        except BaseException:
            self._window.release()
            raise

        def complete():
            with self._lock:
                if state["fired"]:
                    return  # hook + done-fallback both ran: once only
                state["fired"] = True
            msgs = []
            code, details, md = None, "", []
            while True:
                try:
                    ev = st.events.get_nowait()
                except queue.Empty:
                    break
                if ev[0] == "message":
                    st.release_credit()  # the reader may commit the next
                    msgs.append(ev[1])
                elif ev[0] == "trailers":
                    _, code, details, md = ev
            if code is None:  # terminal hook without a queued trailer
                code, details = StatusCode.INTERNAL, "terminal without status"
            if not claim():
                return  # the deadline already failed the future
            call._finish(code, details, md)
            if not fut.set_running_or_notify_cancel():
                return  # the caller cancelled the future; drop the result
            if code is not StatusCode.OK:
                fut.set_exception(RpcError(code, details, md))
            elif len(msgs) != 1:
                fut.set_exception(RpcError(
                    StatusCode.INTERNAL,
                    "unary call received no response" if not msgs
                    else "unary call received multiple responses"))
            else:
                try:
                    fut.set_result(_deserialize(self._mc._deser, msgs[0]))
                except BaseException as exc:  # a raising deserializer
                    fut.set_exception(exc)    # fails, never hangs

        if deadline is not None:
            # No thread waits on this call, so the deadline needs its own
            # timer: expire RSTs the stream and fails the future.
            def expire():
                if not claim():
                    return
                call._expire()
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(RpcError(
                        StatusCode.DEADLINE_EXCEEDED,
                        "deadline exceeded awaiting pipelined response"))

            timer = threading.Timer(max(0.0, deadline - time.monotonic()),
                                    expire)
            timer.daemon = True
            state["timer"] = timer
            timer.start()
        # Hook AFTER the send: the terminal may already have been delivered
        # (fast server + slow caller), in which case st.done is set and the
        # hook will never fire — complete from here instead. state["fired"]
        # makes the two funnels once-only.
        st.on_terminal = complete
        if st.done:
            complete()
        return fut


class UnaryStream(_MultiCallable):
    def __call__(self, request, timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None) -> Call:
        _, _, call = self._start(metadata, timeout, first_request=request)
        return call


class StreamStream(_MultiCallable):
    def __call__(self, request_iterator: Iterable,
                 timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None) -> Call:
        conn, st, call = self._start(metadata, timeout)
        threading.Thread(target=self._send_stream,
                         args=(conn, st, request_iterator),
                         daemon=True, name="tpurpc-stream-sender").start()
        return call

