"""Client channel: multiplexed calls over one endpoint, with reconnect.

A trimmed copy of ``tpurpc/rpc/channel.py``:

* ``Channel`` resolves its target into subchannels (one per address), each
  (re)connecting with exponential backoff, over TLS when given
  ``credentials`` (:func:`secure_channel`; every dial, replays and redials
  included, handshakes, and a failed handshake is ``UNAVAILABLE``, never a
  plaintext retry); an LB policy
  (``tpurpc_torch/rpc/resolver.py``) orders them per call, and transport
  failure maps to ``UNAVAILABLE``. A server's per-response load report is
  stripped from the trailing metadata and fed to the policy;
* ``_Connection`` is one live transport: frames demuxed to per-stream
  state, a write path serialized by ``FrameWriter``, odd client stream ids,
  a rendezvous link (``core/rendezvous.py``) that moves bulk payloads
  one-sided, and its descriptor-ring control plane (``core/ctrlring.py``),
  negotiated in the rendezvous hello, that takes the link's control ops
  off frames. Who reads it is the inline-pump discipline
  (``TPURPC_INLINE_PUMP``: ``auto``, the default, for endpoints with a
  ``pair``; ``1``/``on``/``true`` for every endpoint; ``0``/``off``/
  ``false`` for none): a pump-mode connection has no reader thread, and
  the thread waiting on it (a call's ``_next_event``, ``ping``, a
  rendezvous claim wait, a pipeline's servicing thread) reads it itself,
  one owner at a time, while a timer-wheel tick (the backup pump) services
  it when nobody waits; any other connection has a reader thread;
* ``compression=`` (or the ``grpc.default_compression_algorithm`` option:
  ``gzip``/``2``, ``deflate``/``1``) gzips every request MESSAGE
  (``FLAG_COMPRESSED``; a port or reference server mirrors it on its
  replies); an unknown value degrades to identity with a warning, and a
  per-call ``compression=`` is accepted and advisory, as in the
  reference;
* ``UnaryUnary`` / ``UnaryStream`` / ``StreamUnary`` / ``StreamStream``
  mirror grpcio's multicallables; ``Call.device_ring`` is the ring of the
  connection the call ran on;
* the native fast path (:meth:`Channel._native_fast`): on a shm-ring
  platform (``RDMA_BP``, ``RDMA_EVENT``, ``RDMA_BPEV``; never ``TPU``) a
  plain single-address channel runs its eligible calls inside the C core's
  loop through a cached ``NativeChannel`` (``rpc/native_client.py``):
  unary calls without metadata, wait-for-ready, hedging or a live trace
  sample, under the retry policy, and the three streaming shapes
  (:class:`_NativeStreamCall`). ``TPURPC_NATIVE_FAST_UNARY`` (``0`` off,
  ``1`` on TCP too) and a factory's ``tpurpc_native=False`` opt out; an
  open copy-ledger window or live profiling keeps calls on the Python
  plane, whose copies the instruments count. A failure that provably
  happened before the request left replays on the Python plane;
* the call plane: a service config (``rpc/service_config.py``) delivered
  by the resolver, by ``update_service_config`` or by the
  ``grpc.service_config`` option gives per-method timeouts,
  wait-for-ready, :class:`RetryPolicy` (with the channel-wide retry
  throttle and the server's pushback as a floor) and
  :class:`HedgingPolicy`. A stream the server REFUSED before any handler
  ran (``RST|FLAG_REFUSED``, a draining server) is replayed transparently
  on another subchannel, and so is a stream that could not open because
  its connection turned draining;
* ``PipelinedUnary`` keeps many unary calls in flight on one connection,
  each resolved as a future by the thread that reads the terminal (a
  servicing thread pumps a pump-mode connection while calls are in flight);
  a call a draining server refused replays on another subchannel;
* the connection lifecycle: client keepalive (``keepalive_time_ms``: a
  PING after that much inactivity, and a connection whose PONG misses
  ``keepalive_timeout_ms`` dies and is redialed) and the idle timeout
  (``client_idle_timeout_ms``: a connection with no streams is closed and
  the next call dials fresh), both on the timer wheel, with every endpoint
  write off the wheel's thread; ``Channel.ping``; ``get_state``
  (``ChannelConnectivity``: READY with a live connection, CONNECTING while
  a ``try_to_connect`` dial runs, TRANSIENT_FAILURE in connect backoff,
  else IDLE, and SHUTDOWN once closed), ``wait_for_state_change`` and
  :func:`channel_ready_future`;
* the call plane's observability (``tpurpc_torch/obs``, the reference's
  names): the ``tpurpc-trace`` context on every HEADERS while tracing or
  tail capture is live, with the ``client-send`` and ``wire`` spans and
  the client's tail decision; the flight events ``CONN_CONNECT``,
  ``CONN_DEAD``, ``RECONNECT``, ``CALL_FIRST_OK``, ``DEADLINE_EXPIRED`` and
  the ``hedge`` tag's ``HEDGE_FIRED``/``HEDGE_WON``/``HEDGE_CANCELLED``;
  ``hedges_fired``, ``hedges_won`` and ``deadline_exceeded{method}``; and
  the ``cli_unary`` profile span while ``TPURPC_PROFILING`` is on.
"""

from __future__ import annotations

import concurrent.futures
import os
import queue
import random
import threading
import time
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

from tpurpc_torch.core import ctrlring as _ctrl
from tpurpc_torch.core import rendezvous as _rdv
from tpurpc_torch.core.endpoint import (Endpoint, EndpointError,
                                        connect_endpoint, device_ring_of)
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _obs_metrics
from tpurpc_torch.obs import tracing as _tracing
from tpurpc_torch.obs import watchdog as _watchdog
from tpurpc_torch.rpc import frame as fr
from tpurpc_torch.rpc import resolver as _resolver
from tpurpc_torch.rpc.resolver import (make_policy, resolve_target,
                                       resolve_target_full)
from tpurpc_torch.rpc.service_config import ServiceConfig
from tpurpc_torch.rpc.status import (ChannelConnectivity, Deserializer,
                                     Metadata, RpcError, Serializer,
                                     StatusCode,
                                     deserialize as _deserialize,
                                     identity_codec as _identity)
from tpurpc_torch.utils import stats as _stats
from tpurpc_torch.utils import timers as _timers
from tpurpc_torch.utils.config import get_config
from tpurpc_torch.utils.trace import TraceFlag

trace_channel = TraceFlag("channel")

# The call plane's observability (the reference's names): in-flight depth
# is a scrape-time fleet gauge over live PipelinedUnary windows; the two
# latency histograms record once per pipelined call (microseconds):
# call_us is send to future resolved, demux_us the delivering thread's hop
# from the terminal to the resolution.
_PIPELINES_INFLIGHT = _obs_metrics.fleet("pipeline_inflight",
                                         lambda pl: pl._inflight)
_PIPE_CALL_US = _obs_metrics.histogram("pipeline_call_us", kind="latency")
_PIPE_DEMUX_US = _obs_metrics.histogram("pipeline_demux_us", kind="latency")
#: client-observed deadline expiries per method (the pipeline's timer and
#: the blocking unary path both feed it)
_DEADLINE_EXCEEDED = _obs_metrics.labeled_counter("deadline_exceeded",
                                                  ("method",))
_HEDGES_FIRED = _obs_metrics.counter("hedges_fired")
_HEDGES_WON = _obs_metrics.counter("hedges_won")
_HEDGE_TAG = _flight.tag_for("hedge")
#: no sampling decision was made upstream: ``_start`` draws one (None is a
#: decision, unsampled, and is not redrawn)
_TRACE_UNSET = object()

#: the server's load-report and pushback keys
#: (``tpurpc_torch.rpc.server.LOAD_KEY`` / ``PUSHBACK_KEY``), literals here
#: rather than a server import in the client module
_LOAD_KEY = "tpurpc-load"
_PUSHBACK_KEY = "tpurpc-pushback-ms"


def _pushback_s(exc) -> "Optional[float]":
    """Server retry-pushback (``tpurpc-pushback-ms`` trailing metadata on
    an admission rejection) in seconds, or None when absent/junk."""
    try:
        md = exc.trailing_metadata() or ()
    except Exception:
        return None
    for key, value in md:
        if key == _PUSHBACK_KEY:
            try:
                return max(0.0, float(value) / 1000.0)
            except (TypeError, ValueError):
                return None
    return None


class _ClientStream:
    """Per-call state the reader thread feeds and the caller drains."""

    def __init__(self, stream_id: int, queue_depth: int = 64):
        self.stream_id = stream_id
        self.events: "queue.Queue[tuple]" = queue.Queue()
        self.initial_metadata: Optional[List[Tuple[str, "str | bytes"]]] = None
        self.assembly = fr.Assembly()
        self.done = False  # trailers or failure delivered
        self.refused = False  # RST|FLAG_REFUSED: admission refusal, replayable
        #: pipelined-call completion hook: invoked (on the delivering thread)
        #: AFTER the terminal event is queued — PipelinedUnary resolves its
        #: future here instead of parking a thread on the event queue
        self.on_terminal: Optional[Callable[[], None]] = None
        #: backpressure: bounded completed-but-unconsumed responses
        self._credits = threading.BoundedSemaphore(max(1, queue_depth))
        #: the open "wire" span of a traced call, closed at the terminal
        self._wire_span: Optional[list] = None
        #: perf_counter_ns at the terminal (the pipeline's demux histogram)
        self._t_terminal = 0
        #: (trace context, t0_ns, method): the client's tail decision and
        #: deadline labels at the terminal
        self._tail: Optional[tuple] = None

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

    def commit_message(self, more: bool, oversized: bool = False,
                       compressed: bool = False,
                       recv_limit: Optional[int] = None
                       ) -> Optional[Tuple[StatusCode, str]]:
        """Returns (code, details) when THIS side failed the stream (an
        oversized or undecodable payload): the caller owes the server an
        RST."""
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
            body = self.assembly.take()
            if compressed:
                try:
                    # the limit binds the inflated size (gzip-bomb guard)
                    body = fr.decompress_message(body, recv_limit)
                except fr.DecompressTooLarge as exc:
                    self.deliver_failure(StatusCode.RESOURCE_EXHAUSTED,
                                         str(exc))
                    return StatusCode.RESOURCE_EXHAUSTED, str(exc)
                except fr.FrameError as exc:
                    self.deliver_failure(StatusCode.INTERNAL, str(exc))
                    return StatusCode.INTERNAL, str(exc)
            self.events.put(("message", body))
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
        sp = self._wire_span
        if sp is not None:
            self._wire_span = None
            _tracing.finish(sp)
        self._t_terminal = time.perf_counter_ns()
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
                                   oversized=st.assembly.oversized,
                                   compressed=bool(flags & fr.FLAG_COMPRESSED),
                                   recv_limit=self.max_message_bytes)
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
        self._pong_waiters: List[threading.Event] = []
        self.pong_count = 0  # keepalive verdicts compare against this
        self.alive = True
        self.draining = False  # GOAWAY received: no new streams
        self.last_activity = time.monotonic()
        self._ka_handle: Optional[_timers.TimerHandle] = None
        self._idle_handle: Optional[_timers.TimerHandle] = None
        self._backup_handle: Optional[_timers.TimerHandle] = None
        self._on_dead = on_dead
        #: the LB policy's load-report sink for this connection, rebound by
        #: the channel at every pick (None: reports are stripped, unused)
        self.on_load: Optional[Callable[[object], None]] = None
        #: the connection's lifecycle in the flight ring: the
        #: disconnect, reconnect, first-OK sequence a postmortem replays
        self._ftag = _flight.tag_for("conn:" + getattr(endpoint, "peer",
                                                       "?"))
        self._flight_first_ok = False
        _flight.emit(_flight.CONN_CONNECT, self._ftag)
        self.writer.send_preface()
        # The inline pump: on ring endpoints the WAITING CALLER reads the
        # transport itself, which takes the reader-thread-to-caller wakeup
        # out of every round trip. TPURPC_INLINE_PUMP=auto (the default)
        # turns it on for endpoints with a pair, =1 for every endpoint, =0
        # keeps a reader thread everywhere. Read once, here.
        self._pump_mode = self._pump_enabled(endpoint)
        self._pumping = False  # one thread owns the FrameReader at a time
        self._pump_cond = threading.Condition(self._lock)
        # the rendezvous link and its hello: a PING any peer echoes; only a
        # rendezvous-capable peer answers with its own hello, which arms the
        # link. Until then every payload is framed. The hello also carries
        # this side's descriptor-ring blob: a peer that opens it (same
        # host, shm) moves the link's control ops off frames. In pump mode
        # a sender waiting for a CLAIM pumps for it (nobody else reads).
        self.rdv = _rdv.link_for_endpoint(
            endpoint, "chan:" + getattr(endpoint, "peer", "?"),
            self._rdv_send_op, self._rdv_deliver,
            pump=self._pump_wait if self._pump_mode else None,
            send_ops=self._rdv_send_ops)
        self.writer.rdv = self.rdv
        #: frames this side's reader dispatched: the ring's ordering gate
        self._frames_dispatched = 0
        self.ctrl: Optional[_ctrl.CtrlPlane] = None
        if self.rdv is not None and _ctrl.enabled():
            try:
                self.ctrl = _ctrl.CtrlPlane(
                    "chan:" + getattr(endpoint, "peer", "?"))
            except Exception:
                self.ctrl = None  # no shm: framed control forever
            if self.ctrl is not None:
                self.rdv.ctrl_post = self._rdv_ctrl_post
                self.rdv.ctrl_drain = self._ctrl_drain_nowait
                # per-stream order across the ring/framed split: control
                # ops posted before a sink-routed MESSAGE deliver first
                self.reader.pre_commit = self._ctrl_drain
        if self.rdv is not None:
            self.rdv.recv_limit = max_recv_bytes
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
                pass  # connection dying; the reader surfaces it
        if self._pump_mode:
            self._start_backup_pump()
        else:
            self._thread = threading.Thread(target=self._read_loop,
                                            daemon=True,
                                            name="tpurpc-chan-reader")
            self._thread.start()
        self._start_keepalive()
        self._start_idle_monitor()

    @staticmethod
    def _pump_enabled(endpoint: Endpoint) -> bool:
        mode = os.environ.get("TPURPC_INLINE_PUMP", "auto").lower()
        if mode in ("0", "off", "false"):
            return False
        if mode in ("1", "on", "true"):
            return True
        # auto: ring endpoints only (a pair-backed byte pipe); TCP keeps its
        # blocking reader thread
        return hasattr(endpoint, "pair")

    def _start_keepalive(self) -> None:
        """Client keepalive (``keepalive_time_ms``, off by default as in
        gRPC): PING an idle connection; a PONG missing past
        ``keepalive_timeout_ms`` kills it, so that the channel redials
        instead of calls hanging on a dead peer. Event-style on the wheel:
        one tick sends the PING and schedules a verdict that compares
        ``pong_count``; no thread per connection."""
        cfg = get_config()
        if cfg.keepalive_time_ms <= 0:
            return
        interval = cfg.keepalive_time_ms / 1000.0
        timeout = max(0.001, cfg.keepalive_timeout_ms / 1000.0)

        def tick():
            if not self.alive:
                return
            # only an idle connection is pinged: with streams open the one
            # reader may sit in a credit wait or a long burst with the PONG
            # unread, and a verdict would kill a healthy connection
            with self._lock:
                busy = (bool(self._streams)
                        or time.monotonic() - self.last_activity < interval)
                before = self.pong_count
            if busy:
                self._ka_handle = _timers.schedule(interval, tick)
                return
            sent_at = time.monotonic()

            def send_ping():  # an endpoint write: never on the wheel
                try:
                    self.writer.send(fr.PING, 0, 0, b"tpurpc-keepalive")
                except (EndpointError, OSError, fr.FrameError):
                    self._die("keepalive ping send failed")

            _timers.run_blocking(send_ping)

            def check():
                # answered: the next PING an interval after this one;
                # unanswered past the timeout: reap, off the wheel
                if not self.alive:
                    return
                elapsed = time.monotonic() - sent_at
                with self._lock:
                    ponged = self.pong_count > before
                if ponged:
                    self._ka_handle = _timers.schedule(
                        max(0.05, interval - elapsed), tick)
                elif elapsed >= timeout:
                    _timers.run_blocking(
                        lambda: self._die("keepalive ping timed out"))
                else:
                    self._ka_handle = _timers.schedule(
                        min(1.0, max(0.05, timeout - elapsed)), check)

            self._ka_handle = _timers.schedule(min(1.0, timeout), check)

        self._ka_handle = _timers.schedule(interval, tick)

    def _start_idle_monitor(self) -> None:
        """The client idle filter (``client_idle_timeout_ms``, off by
        default): a connection with no streams and no activity for the
        window is closed and the next call dials fresh, freeing the
        server's per-connection state (pairs, rings)."""
        cfg = get_config()
        if cfg.client_idle_timeout_ms <= 0:
            return
        window = cfg.client_idle_timeout_ms / 1000.0

        def tick():
            if not self.alive:
                return
            with self._lock:
                remain = window - (time.monotonic() - self.last_activity)
                busy = bool(self._streams)
                idle = not busy and remain <= 0
                if idle:
                    # gate before the lock goes: open_stream checks
                    # draining under it, so a call racing the close is
                    # redialed instead of failing on a dying connection
                    self.draining = True
                delay = window if busy else max(0.05, remain)
            if idle:
                _timers.run_blocking(lambda: self._die("client idle timeout"))
                return
            self._idle_handle = _timers.schedule(delay, tick)

        self._idle_handle = _timers.schedule(window, tick)

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
            self.last_activity = time.monotonic()
            return st

    def close_stream(self, st: _ClientStream) -> None:
        with self._lock:
            self._streams.pop(st.stream_id, None)
            self.last_activity = time.monotonic()
            finish_drain = self.draining and not self._streams
        if finish_drain:
            self._die("drained after GOAWAY")

    def _read_loop(self) -> None:
        if self.rdv is not None:
            # this thread delivers CLAIMs: a big send here must frame (a
            # pump-mode connection has no such thread: its claim waits pump)
            self.rdv.disallowed_thread = threading.get_ident()
        try:
            while True:
                f = self._read_frame_ctrl()
                if f is None:
                    self._die("server closed connection")
                    return
                if f is not fr.CONSUMED:  # MESSAGEs are routed via the sink
                    self._dispatch(f)
                self._frames_dispatched += 1
        except (EndpointError, fr.FrameError, OSError) as exc:
            self._die(str(exc))

    # -- inline pump (pump-mode connections only) -----------------------------

    def _pump_wait(self, pred: Callable[[], bool],
                   deadline: Optional[float]) -> bool:
        """Wait for ``pred`` by PUMPING the transport from this thread.

        One pumper at a time owns the FrameReader (it is not thread-safe);
        the others park on the condition and are notified after every
        dispatched frame, so a parked waiter whose pred the owner's pumping
        satisfied wakes at once; the owner pumps only until its OWN pred
        holds.

        True when ``pred()`` holds or the connection died (the caller reads
        the terminal state from its event queue); False only when
        ``deadline`` (a ``time.monotonic()`` instant) passed."""
        while True:
            with self._pump_cond:
                while True:
                    if pred() or not self.alive:
                        return True
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        return False
                    if not self._pumping:
                        self._pumping = True
                        break  # this thread owns the pump now
                    self._pump_cond.wait(remaining)
            try:
                self._pump(pred, deadline)
            finally:
                with self._pump_cond:
                    self._pumping = False
                    self._pump_cond.notify_all()
            # loop: re-check pred and deadline under the lock (the pump may
            # have returned because the connection died mid-frame)

    def _pump(self, pred: Callable[[], bool],
              deadline: Optional[float]) -> None:
        """Read frames until pred, deadline or death. Runs WITHOUT the
        connection lock (a commit's credit wait may block until a consumer
        drains its queue, and consumers must be able to run), owning the
        reader through ``_pumping``."""
        def _stop() -> bool:
            # a ring drain inside the polled read may satisfy the pred with
            # no frame arriving: return to the outer loop instead of
            # blocking out the deadline
            with self._lock:
                return pred() or not self.alive

        while True:
            if _stop():
                return
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                return
            try:
                f = self._read_frame_ctrl(remaining, should_stop=_stop)
            except TimeoutError:
                return  # deadline or pred: the outer loop re-checks
            except (EndpointError, fr.FrameError, OSError) as exc:
                self._die(str(exc))
                return
            if f is None:
                self._die("server closed connection")
                return
            if f is not fr.CONSUMED:
                self._dispatch(f)
            self._frames_dispatched += 1
            # every frame (CONSUMED commits included) may satisfy a PARKED
            # waiter's pred: hand them the wakeup now, not at pump release
            with self._pump_cond:
                self._pump_cond.notify_all()

    def _start_backup_pump(self) -> None:
        """Idle servicing of a pump-mode connection: with no caller waiting
        nobody pumps, and server PINGs, GOAWAYs and keepalive PONGs would
        sit unread. A timer-wheel tick takes the pump when it is free and
        reads whatever is already buffered (the backup poller of gRPC's
        client, for the same reason)."""
        # the only reader of an IDLE pump-mode connection must beat the
        # keepalive verdict, or an unread PONG reaps a healthy connection:
        # a third of the timeout gives at least two reads inside a window
        cfg = get_config()
        interval = 0.5
        if cfg.keepalive_time_ms > 0:
            interval = min(interval,
                           max(0.05, cfg.keepalive_timeout_ms / 1000.0 / 3))

        def service():
            if not self.alive:
                return
            with self._pump_cond:
                grab = not self._pumping and self.alive
                if grab:
                    self._pumping = True
            if grab:
                try:
                    while True:
                        self._ctrl_drain()
                        try:
                            f = self.reader.read_frame(timeout=0.005)
                        except TimeoutError:
                            break
                        except (EndpointError, fr.FrameError, OSError) as exc:
                            self._die(str(exc))
                            return
                        if f is None:
                            self._die("server closed connection")
                            return
                        if f is not fr.CONSUMED:
                            self._ctrl_drain()  # ring ops sent before f
                            self._dispatch(f)
                        self._frames_dispatched += 1
                finally:
                    with self._pump_cond:
                        self._pumping = False
                        self._pump_cond.notify_all()
            if self.alive:
                self._backup_handle = _timers.schedule(interval, tick)

        def tick():  # the read runs off the wheel thread
            _timers.run_blocking(service)

        self._backup_handle = _timers.schedule(interval, tick)

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
            pass  # connection dying; the framed paths surface it

    def _frames_count(self) -> int:
        return self._frames_dispatched

    def _ctrl_drain(self, wait: bool = True) -> int:
        """Drain this side's ring. The reader (the reader thread, a caller
        that owns the pump, or the backup pump) waits out a sender thread's
        concurrent drain, so that every record the ring holds before a frame
        is delivered before that frame is dispatched."""
        plane, rdv = self.ctrl, self.rdv
        if plane is None or rdv is None:
            return 0
        n = plane.drain(rdv.on_op, self._frames_count, wait)
        if n and self._pump_mode:
            # a drained record may satisfy a PARKED pump waiter's pred: the
            # same handoff the frame path makes after each dispatch
            with self._pump_cond:
                self._pump_cond.notify_all()
        return n

    def _ctrl_drain_nowait(self) -> int:
        """A sender thread's drain (standing-grant pickup): skips when the
        reader is draining."""
        return self._ctrl_drain(wait=False)

    def _read_frame_ctrl(self, timeout=None, should_stop=None):
        plane = self.ctrl
        if plane is None or plane.rx is None:
            return self.reader.read_frame(timeout=timeout)
        return _ctrl.read_frame_polled(self.reader.read_frame,
                                       self._ctrl_drain, plane, timeout,
                                       should_stop)

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
            with self._lock:
                self.pong_count += 1
                waiters, self._pong_waiters = self._pong_waiters, []
            for ev in waiters:
                ev.set()
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
            if md:
                # the server's piggybacked load report is transport-internal:
                # strip it before metadata surfaces to the app, feed it to
                # the LB policy's sink
                for i, (key, value) in enumerate(md):
                    if key == _LOAD_KEY:
                        del md[i]
                        cb = self.on_load
                        if cb is not None:
                            try:
                                cb(value)
                            except Exception:
                                pass  # a policy bug must not kill the reader
                        break
            if f.type == fr.RST and f.flags & fr.FLAG_REFUSED:
                # admission refusal: the server certifies no handler ran
                # (set BEFORE the event lands; the queue orders the read)
                st.refused = True
            self.close_stream(st)
            st.deliver_trailers(code, details, md)
        else:
            raise fr.FrameError(f"unexpected frame {f!r}")

    def ping(self, timeout: float) -> float:
        """Round-trip one PING; seconds, or raises when no PONG comes."""
        ev = threading.Event()
        with self._lock:
            if not self.alive:
                raise EndpointError("connection closed")
            self._pong_waiters.append(ev)
            before = self.pong_count
        t0 = time.perf_counter()
        self.writer.send(fr.PING, 0, 0, b"tpurpc-ping")
        if self._pump_mode:
            if not self._pump_wait(lambda: self.pong_count > before,
                                   time.monotonic() + timeout):
                raise TimeoutError("ping timed out")
        elif not ev.wait(timeout):
            raise TimeoutError("ping timed out")
        if not self.alive:  # waiters are released at death too
            raise EndpointError("connection died during ping")
        return time.perf_counter() - t0

    def _die(self, why: str) -> None:
        with self._lock:
            if not self.alive:
                return
            self.alive = False
            streams = list(self._streams.values())
            self._streams.clear()
            waiters, self._pong_waiters = self._pong_waiters, []
            # parked pump waiters see the death now, not when the owner's
            # read fails
            self._pump_cond.notify_all()
        for ev in waiters:
            ev.set()  # ping() sees the death
        for h in (self._ka_handle, self._idle_handle, self._backup_handle):
            if h is not None:
                h.cancel()  # the ticks also check alive themselves
        graceful = "GOAWAY" in why or "closed" in why or "idle" in why
        _flight.emit(_flight.CONN_DEAD, self._ftag, 1 if graceful else 0)
        if self.rdv is not None:
            # claimed landing regions are released; waiting senders wake
            self.rdv.close()
        if self.ctrl is not None:
            # descriptor rings die with the connection: a straggling peer's
            # late slot store lands in the orphaned mapping, never in a ring
            # advertised to another connection
            self.ctrl.close()
        trace_channel.log("connection dead: %s", why)
        for st in streams:
            st.deliver_failure(StatusCode.UNAVAILABLE, f"transport failed: {why}")
        try:
            self.endpoint.close()
        except Exception:
            pass
        self._on_dead(self)

    def close(self) -> None:
        self._die("channel closed")


class _Subchannel:
    """One address's connection + exponential reconnect backoff (gRPC's
    Subchannel in client_channel + lib/backoff)."""

    def __init__(self, factory: Callable[[], Endpoint], channel: "Channel"):
        self._factory = factory
        self._channel = channel
        self._conn: Optional[_Connection] = None
        self._lock = threading.Lock()          # guards _conn/backoff state
        self._connect_lock = threading.Lock()  # serializes dial attempts only
        self._backoff = Channel._BACKOFF_INITIAL
        self._next_attempt = 0.0
        self._lost_conn = False  # a connection died: the next is a RECONNECT

    def _live(self) -> Optional[_Connection]:
        conn = self._conn
        if conn is not None and conn.alive and not conn.draining:
            return conn
        return None

    def get(self, fail_fast: bool = False) -> _Connection:
        """The live connection, dialing if needed. ``fail_fast=True`` (the
        multi-subchannel LB walk) raises UNAVAILABLE immediately while the
        subchannel is in connect backoff instead of sleeping it out —
        sleeping through backoff inside the dial lock convoys every walker
        behind one dead backend, and with other backends in the walk there
        is nothing worth waiting for. Single-subchannel channels keep the
        sleep: there, waiting out the backoff IS the reconnect contract."""
        with self._lock:
            conn = self._live()
            if conn is not None:
                return conn
            if fail_fast and self._next_attempt > time.monotonic():
                raise RpcError(StatusCode.UNAVAILABLE,
                               "subchannel in connect backoff")
        # dial outside self._lock: a blackholed connect must not freeze
        # close() or concurrent calls for the whole connect timeout
        with self._connect_lock:
            with self._lock:
                conn = self._live()
                if conn is not None:
                    return conn
                wait = self._next_attempt - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            if self._channel._is_closed():
                raise RpcError(StatusCode.UNAVAILABLE, "channel closed")
            try:
                conn = _Connection(
                    self._factory(), self._on_conn_dead,
                    max_recv_bytes=self._channel.max_receive_message_length)
            except (OSError, EndpointError) as exc:
                with self._lock:
                    self._next_attempt = (
                        time.monotonic()
                        + self._backoff * (1 + 0.2 * random.random()))
                    self._backoff = min(self._backoff * Channel._BACKOFF_MULT,
                                        Channel._BACKOFF_MAX)
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"connect failed: {exc}") from exc
            with self._lock:
                if self._channel._is_closed():
                    conn.close()
                    raise RpcError(StatusCode.UNAVAILABLE, "channel closed")
                self._backoff = Channel._BACKOFF_INITIAL
                self._conn = conn
                was_lost, self._lost_conn = self._lost_conn, False
            if was_lost:
                _flight.emit(_flight.RECONNECT, conn._ftag)
            return conn

    def _on_conn_dead(self, conn: _Connection) -> None:
        with self._lock:
            if self._conn is conn:
                self._conn = None
            self._lost_conn = True

    def close(self) -> None:
        with self._lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()


class Channel:
    """A lazily-(re)connecting client channel.

    ``target`` is a gRPC target (``"host:port"``, ``"dns:///host:port"``,
    ``"ipv4:h1:p1,h2:p2"`` or a registered scheme; see
    :mod:`tpurpc_torch.rpc.resolver`); tests may instead inject
    ``endpoint_factory``. Each resolved address is one subchannel.

    ``lb_policy`` is a policy name (``"pick_first"``, ``"round_robin"``,
    ``"ring_hash"``, ``"least_loaded"``) or a composition-tree dict spec
    (``priority`` / ``weighted_target`` over subchannel index subsets) — see
    :func:`tpurpc_torch.rpc.resolver.make_policy`. ``options`` takes
    grpcio's ``[("grpc.arg_name", value), ...]``; the port reads
    ``grpc.max_receive_message_length``, ``grpc.lb_policy_name`` (an
    explicit parameter wins), ``grpc.default_compression_algorithm`` and
    ``grpc.service_config`` (a fallback used only when the resolver
    delivers no config) and ignores the rest, as grpcio ignores unknown
    channel args.

    ``compression`` (``"gzip"``/``2``, or ``"deflate"``/``1``, honored with
    the framing's one codec) sets ``FLAG_COMPRESSED`` on every request
    MESSAGE; an unknown value degrades to identity with a warning.

    ``retry_policy`` / ``hedging_policy`` apply to every method and win
    over a service config's; without them (gRPC's default) calls are not
    retried unless a service config says so.

    ``credentials`` (:func:`tpurpc_torch.rpc.credentials.
    ssl_channel_credentials`) makes every dial a TLS one (see
    :func:`secure_channel`).
    """

    #: reconnect backoff: start 50 ms, cap 2 s, ×1.6, 20% jitter
    _BACKOFF_INITIAL = 0.05
    _BACKOFF_MAX = 2.0
    _BACKOFF_MULT = 1.6

    def __init__(self, target: Optional[str] = None, *,
                 endpoint_factory: Optional[Callable[[], Endpoint]] = None,
                 connect_timeout: float = 30.0,
                 lb_policy: "Union[str, dict]" = "pick_first",
                 credentials=None,
                 max_receive_message_length: Optional[int] = None,
                 retry_policy: "Optional[RetryPolicy]" = None,
                 hedging_policy: "Optional[HedgingPolicy]" = None,
                 compression=None,
                 options=None):
        svc_cfg_fallback = None
        if options:
            opt = dict(options)
            if max_receive_message_length is None:
                max_receive_message_length = opt.get(
                    "grpc.max_receive_message_length")
            if lb_policy == "pick_first" and "grpc.lb_policy_name" in opt:
                lb_policy = opt["grpc.lb_policy_name"]
            if compression is None:
                compression = opt.get("grpc.default_compression_algorithm")
            #: grpcio's service-config channel arg: a JSON FALLBACK used
            #: only when the resolver delivers no config (the resolver wins)
            svc_cfg_fallback = opt.get("grpc.service_config")
        # The framing's one codec is gzip, so grpcio's Compression.Deflate
        # (1) is honored as "compress my messages" with it. An unknown
        # value degrades to identity with a warning: grpcio tolerates
        # unknown channel args, and a constructor error would break
        # drop-in call sites.
        if compression in (None, 0, "identity", False):
            self._compress_flag = 0
        elif (compression in ("gzip", "deflate", 1, 2)
              or str(compression).endswith(("Gzip", "Deflate"))):
            self._compress_flag = fr.FLAG_COMPRESSED
        else:
            import warnings
            warnings.warn(
                f"unsupported compression {compression!r}: the tpurpc "
                "framing speaks gzip only — using identity", stacklevel=2)
            self._compress_flag = 0
        #: channel-level retry policy for unary-request calls (None = off,
        #: gRPC's default without a service config). An explicit policy
        #: here WINS over any service config the resolver delivers.
        self.retry_policy = retry_policy
        #: channel-level hedging policy (gRFC A6): staggered parallel
        #: attempts on distinct subchannels, first response wins. Retry wins
        #: when both are configured (a call runs ONE strategy).
        self.hedging_policy = hedging_policy
        #: parsed service config (per-method timeout / waitForReady /
        #: retryPolicy / hedgingPolicy, channel-wide retryThrottling);
        #: swapped whole by update_service_config, read once per call by
        #: _call_plan
        self._service_config: Optional[ServiceConfig] = None
        self.max_receive_message_length = get_config().resolve_recv_limit(
            max_receive_message_length)
        self._lb_spec = lb_policy
        #: every dial's arguments: the TLS context and the hostname to
        #: verify (None: the target's host) travel with each connect
        self._conn_kw = dict(
            timeout=connect_timeout,
            ssl_context=getattr(credentials, "_context", None),
            server_hostname=getattr(credentials, "_override_hostname", None))
        if endpoint_factory is None:
            if target is None:
                raise ValueError("need target or endpoint_factory")
            resolution = resolve_target_full(target)
            addrs = resolution.addresses
            self._addrs: Optional[list] = list(addrs)
            factories = [self._addr_factory(h, p) for h, p in addrs]
            if resolution.service_config is not None:
                self.update_service_config(resolution.service_config)
        else:
            self._addrs = None  # injected factory: membership is fixed
            factories = [endpoint_factory]
        if self._service_config is None and svc_cfg_fallback is not None:
            self.update_service_config(svc_cfg_fallback)
        self._subchannels = [_Subchannel(f, self) for f in factories]
        self._policy = make_policy(lb_policy, len(self._subchannels))
        self._lock = threading.Lock()  # guards _closed and the membership
        self._closed = False
        #: the background dial a get_state(try_to_connect=True) started
        self._kicker: Optional[threading.Thread] = None
        #: the native fast path (lazy, see _native_fast): the cached
        #: NativeChannel, and a throttle so that an absent or down native
        #: path costs one probe per 5 s
        self._native_lock = threading.Lock()
        self._native_ch = None
        self._native_retry_at = 0.0
        from tpurpc_torch.rpc import channelz as _channelz

        #: channelz ChannelData counters (started/succeeded/failed)
        self.call_counters = _channelz.CallCounters()
        _channelz.register_channel(self)

    def _addr_factory(self, h: str, p: int) -> Callable[[], Endpoint]:
        kw = self._conn_kw
        return lambda: connect_endpoint(h, p, **kw)

    def update_service_config(self, cfg) -> None:
        """Apply a JSON service config (dict or JSON text): per-method
        timeouts, wait-for-ready, retry and hedging policies, and
        channel-wide retry throttling take effect for SUBSEQUENT calls
        without touching call sites. A malformed config raises
        ``ValueError`` and the previous one stays (reject-whole,
        keep-last-good). The throttle's drain state carries across updates:
        a re-resolution re-delivering the same config must not refill the
        bucket and resume a suppressed retry storm."""
        new = ServiceConfig.from_json(cfg)
        prev = self._service_config
        if new.retry_throttle is not None:
            new.retry_throttle.carry_from(
                prev.retry_throttle if prev else None)
        self._service_config = new

    def _call_plan(self, method: str, timeout: "Optional[float]",
                   wait_for_ready: bool = False):
        """ONE consistent per-call snapshot of the service-config-derived
        values: ``(retry_policy, timeout, throttle, wait_for_ready,
        hedging_policy)``, from a single read of ``_service_config`` so a
        concurrent update can never pair one config's retry policy with
        another's throttle or timeout. Rules: an explicit constructor
        policy wins; the config's timeout can only TIGHTEN the call's (the
        min rule); waitForReady is or-ed with the per-call flag; a method
        runs ONE strategy — when both retry and hedging resolve, retry
        wins."""
        sc = self._service_config
        mc = sc.for_method(method) if sc is not None else None
        policy = self.retry_policy
        if policy is None and mc is not None:
            policy = mc.retry_policy
        hedging = self.hedging_policy
        if hedging is None and mc is not None:
            hedging = mc.hedging_policy
        if policy is not None:
            hedging = None
        if mc is not None and mc.timeout is not None:
            timeout = (mc.timeout if timeout is None
                       else min(timeout, mc.timeout))
        return (policy, timeout,
                sc.retry_throttle if sc is not None else None,
                bool(wait_for_ready) or bool(mc and mc.wait_for_ready),
                hedging)

    @property
    def _conn(self) -> Optional[_Connection]:
        """The first subchannel's connection, or None: THE connection of a
        one-address channel (tests and the smoke read its rendezvous
        link)."""
        return self._subchannels[0]._conn

    def _is_closed(self) -> bool:
        with self._lock:
            return self._closed

    def update_addresses(self, addrs) -> None:
        """Replace the channel's backend set (re-resolution). Addresses
        present in both old and new sets KEEP their live subchannel (and
        its connection); removed ones are closed; the LB policy is rebuilt
        over the new membership with the channel's original spec.

        ``addrs``: iterable of ``(host, port)`` or ``"host:port"`` strings.
        In-flight calls on kept subchannels are unaffected; calls racing
        the swap may still land on a closing backend once and fail
        UNAVAILABLE.
        """
        parsed: list = []
        for a in addrs:
            if isinstance(a, tuple):
                parsed.append(a)
            else:
                # resolve strings as the constructor did: the keep-live
                # matching below compares RESOLVED addresses, so
                # "localhost:p" must normalize to the same keys or a no-op
                # update would tear down live connections
                parsed.extend(resolve_target(a))
        if not parsed:
            raise ValueError("update_addresses needs at least one address")
        # composite dict specs pin absolute subchannel indices and cannot
        # survive a membership size change: balanced sets get round_robin
        spec = (self._lb_spec if isinstance(self._lb_spec, str)
                else "round_robin")
        # dynamic membership is routing the Python transport owns: the
        # single-address native fast path would pin traffic to the original
        # backend, so it is off for this channel from now on
        with self._native_lock:
            nch, self._native_ch = self._native_ch, None
            self._native_retry_at = float("inf")
        if nch is not None:
            try:
                nch.close()
            except Exception:
                pass
        with self._lock:
            if self._closed:
                raise RpcError(StatusCode.UNAVAILABLE, "channel closed")
            if self._addrs is None:
                raise RuntimeError(
                    "channel built from endpoint_factory has fixed membership")
            old: dict = {}
            for a, sc in zip(self._addrs, self._subchannels):
                old.setdefault(a, []).append(sc)
            new_subs = []
            for a in parsed:
                bucket = old.get(a)
                if bucket:
                    new_subs.append(bucket.pop(0))  # keep the live conn
                else:
                    new_subs.append(_Subchannel(self._addr_factory(*a), self))
            removed = [sc for bucket in old.values() for sc in bucket]
            policy = make_policy(spec, len(new_subs))
            # atomic swap: _connection() snapshots both attributes
            self._subchannels = new_subs
            self._policy = policy
            self._addrs = list(parsed)
        for sc in removed:
            sc.close()

    def batch_calls(self):
        """Batch the fused unary sends THIS thread issues inside the block
        into ONE gathered writev (``FrameWriter.batch``): a burst of small
        control RPCs, such as a migration drain's sequence handoffs, is one
        transport write instead of one per call. Pipelined ``call_async``
        inside the block composes: the sends queue, the responses demux as
        usual. On a channel with no dialable connection the block runs
        unbatched (the calls surface the dial failure)."""
        import contextlib

        try:
            conn = self._connection()
        except Exception:
            return contextlib.nullcontext()
        return conn.writer.batch()

    def _connection(self, exclude=None, picked=None) -> _Connection:
        """LB pick: walk subchannels in policy order, first live or
        dialable wins (client_channel's resolver → LB → subchannel flow).

        ``exclude`` (a set of :class:`_Subchannel` objects) deprioritizes
        backends this logical call already used — hedged attempts prefer
        distinct subchannels, and a drain-refused replay migrates instead
        of re-hitting the drainer. Excluded subchannels are walked LAST,
        not dropped: landing on a busy backend beats failing the call when
        nothing else is dialable. ``picked`` (a list, out-param) receives
        the chosen subchannel."""
        with self._lock:
            if self._closed:
                raise RpcError(StatusCode.UNAVAILABLE, "channel closed")
            # snapshot: update_addresses swaps both under this lock, so a
            # pick never mixes one generation's policy with another's subs
            policy, subs = self._policy, self._subchannels
        last_exc: Optional[Exception] = None
        order = list(policy.order())
        if exclude:
            order = ([i for i in order if subs[i] not in exclude]
                     + [i for i in order if subs[i] in exclude])
        fail_fast = len(subs) > 1  # walkers skip backing-off members
        for idx in order:
            sc = subs[idx]
            try:
                conn = sc.get(fail_fast=fail_fast)
            except RpcError as exc:
                policy.failed(idx)
                last_exc = exc
                continue
            policy.connected(idx)
            # bind the connection's load-report sink to this pick's
            # (policy, index) — rebound every pick so a policy rebuilt by
            # update_addresses never receives stale indices
            if hasattr(policy, "load_report"):
                conn.on_load = (lambda raw, _p=policy, _i=idx:
                                _p.load_report(_i, raw))
            if picked is not None:
                picked.append(sc)
            return conn
        raise last_exc if last_exc is not None else RpcError(
            StatusCode.UNAVAILABLE, "no subchannels")

    def device_ring(self):
        """The live connection's device receive ring, or None off the TPU
        platform. This dials; to decode a response already in hand prefer
        :meth:`Call.device_ring`."""
        return device_ring_of(self._connection().endpoint)

    def ping(self, timeout: float = 5.0) -> float:
        """Round-trip a PING on the live connection (dialing one if
        needed); seconds. DEADLINE_EXCEEDED when no PONG comes in time."""
        conn = self._connection()
        try:
            return conn.ping(timeout)
        except TimeoutError as exc:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, str(exc)) from exc
        except (EndpointError, OSError) as exc:
            raise RpcError(StatusCode.UNAVAILABLE, str(exc)) from exc

    def get_state(self, try_to_connect: bool = False) -> ChannelConnectivity:
        """grpcio's ``Channel.get_state``, folded over the subchannels:
        READY if one holds a live connection; CONNECTING while a kicked
        dial runs; TRANSIENT_FAILURE if none is live but one is in connect
        backoff; else IDLE; SHUTDOWN once closed. ``try_to_connect=True``
        on an idle channel starts one background dial sweep; polls while
        it runs read CONNECTING and start no other."""
        CC = ChannelConnectivity
        with self._lock:
            if self._closed:
                return CC.SHUTDOWN
            subs = list(self._subchannels)
        with self._native_lock:
            nch = self._native_ch
        if nch is not None and nch._ch:
            # calls flow through the native fast path: the channel is READY
            # though no Python-transport connection exists
            return CC.READY
        now = time.monotonic()
        backing_off = False
        for sc in subs:
            with sc._lock:
                if sc._live() is not None:
                    return CC.READY
                if sc._next_attempt > now:
                    backing_off = True
        with self._lock:
            kicker = self._kicker
            if kicker is not None and kicker.is_alive():
                return CC.CONNECTING  # one dial sweep at a time
            if try_to_connect and subs:
                self._kicker = threading.Thread(
                    target=self._kick_connect, daemon=True,
                    name="tpurpc-try-connect")
                self._kicker.start()
                return CC.CONNECTING
        return CC.TRANSIENT_FAILURE if backing_off else CC.IDLE

    def _kick_connect(self) -> None:
        # dial each subchannel until one answers: a dead first address must
        # not mask a live second one
        with self._lock:
            subs = list(self._subchannels)
        for sc in subs:
            if self._is_closed():
                return
            try:
                sc.get()
                return
            except RpcError:
                continue  # its backoff reads TRANSIENT_FAILURE

    def wait_for_state_change(self, last_observed_state,
                              timeout: Optional[float] = None) -> bool:
        """Block until ``get_state()`` differs from
        ``last_observed_state``; False at the timeout (polled)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.get_state() == last_observed_state:
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.02)
        return True

    def close(self) -> None:
        with self._lock:
            self._closed = True
            subs = list(self._subchannels)
        with self._native_lock:
            nch, self._native_ch = self._native_ch, None
            self._native_retry_at = float("inf")  # closed: never re-dial
        if nch is not None:
            try:
                nch.close()
            except Exception:
                pass
        for sc in subs:
            sc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- native fast path ----------------------------------------------------

    def _native_fast(self):
        """The channel's NativeChannel (calls run inside the C core's
        inline-read loop), or None when ineligible.

        Eligibility is the common drop-in case, checked once: a plain
        single address, pick_first with static membership, no TLS, no
        compression, a shm-ring platform (plain-TCP channels keep the
        Python transport), the library present.
        ``TPURPC_NATIVE_FAST_UNARY=1`` forces it for TCP too; ``=0`` opts
        out entirely. Everything else stays on the Python transport: the
        same wire, the same server."""
        with self._native_lock:
            if self._native_ch is not None:
                return self._native_ch
            now = time.monotonic()
            if now < self._native_retry_at or self._closed:
                return None
            self._native_retry_at = now + 5.0  # throttle failed probes
            mode = os.environ.get("TPURPC_NATIVE_FAST_UNARY",
                                  "auto").lower()
            if mode in ("0", "off", "false"):
                self._native_retry_at = float("inf")
                return None
            if (self._compress_flag or self._addrs is None
                    or len(self._addrs) != 1 or self._lb_spec != "pick_first"
                    or self._conn_kw.get("ssl_context") is not None):
                self._native_retry_at = float("inf")
                return None
            cfg = get_config()
            ring_ok = (cfg.platform.is_ring and cfg.platform.name != "TPU"
                       and cfg.ring_domain == "shm")
            if not (ring_ok or (mode in ("1", "on", "true")
                                and not cfg.platform.is_ring)):
                self._native_retry_at = float("inf")
                return None
            try:
                from tpurpc_torch.rpc.native_client import NativeChannel

                host, port = self._addrs[0]
                # inline_read: the fast path issues only BLOCKING entries
                # (unary calls and NativeCall streams), so it takes the
                # lowest-latency discipline: callers pump the ring, no
                # reader-thread wakeup per round trip
                self._native_ch = NativeChannel(
                    host, port, connect_timeout=self._conn_kw["timeout"],
                    inline_read=True)
            except Exception:
                return None  # library absent or server down: retry in 5 s
            return self._native_ch

    def _native_invalidate(self, nch) -> None:
        """Drop a dead fast-path channel; the next eligible call re-dials."""
        with self._native_lock:
            if self._native_ch is nch:
                self._native_ch = None
        try:
            nch.close()
        except Exception:
            pass

    # The factories take and ignore the extra keywords grpcio-generated
    # stubs pass (``_registered_method=True`` since grpcio 1.60) and read
    # None codecs as identity, as grpcio does, so a stock
    # ``*_pb2_grpc.FooStub(channel)`` runs on this channel unchanged.
    # ``tpurpc_native=False`` opts a method out of the native fast paths
    # (to keep a bulk stream on the fully instrumented Python plane, say).

    def unary_unary(self, method: str, request_serializer: Serializer = _identity,
                    response_deserializer: Deserializer = _identity,
                    **_grpcio_kwargs) -> "UnaryUnary":
        return UnaryUnary(self, method, request_serializer or _identity,
                          response_deserializer or _identity,
                          allow_native=_grpcio_kwargs.pop(
                              "tpurpc_native", True))

    def unary_stream(self, method: str, request_serializer: Serializer = _identity,
                     response_deserializer: Deserializer = _identity,
                     **_grpcio_kwargs) -> "UnaryStream":
        return UnaryStream(self, method, request_serializer or _identity,
                           response_deserializer or _identity,
                           allow_native=_grpcio_kwargs.pop(
                               "tpurpc_native", True))

    def stream_unary(self, method: str, request_serializer: Serializer = _identity,
                     response_deserializer: Deserializer = _identity,
                     **_grpcio_kwargs) -> "StreamUnary":
        return StreamUnary(self, method, request_serializer or _identity,
                           response_deserializer or _identity,
                           allow_native=_grpcio_kwargs.pop(
                               "tpurpc_native", True))

    def stream_stream(self, method: str, request_serializer: Serializer = _identity,
                      response_deserializer: Deserializer = _identity,
                      **_grpcio_kwargs) -> "StreamStream":
        return StreamStream(self, method, request_serializer or _identity,
                            response_deserializer or _identity,
                            allow_native=_grpcio_kwargs.pop(
                                "tpurpc_native", True))


class Call:
    """In-flight call handle: response iteration, cancel, metadata."""

    def __init__(self, conn: _Connection, st: _ClientStream,
                 deserializer: Deserializer, deadline: Optional[float],
                 counters=None, channel: "Optional[Channel]" = None):
        self._channel = channel  # for the compression degrade below
        self._conn = conn
        self._st = st
        self._deser = deserializer
        self._deadline = deadline
        self._trailing: Optional[Metadata] = None
        self._code: Optional[StatusCode] = None
        self._details = ""
        self._cancelled = False
        self._counters = counters  # channelz ChannelData (counted once)

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

    def _tail_decide(self, error: bool) -> None:
        """The client half of the tail-capture decision: commit this call's
        provisional span tree iff it was slow or failed (either end
        committing promotes the shared trace)."""
        stash = self._st._tail
        if stash is None:
            return
        self._st._tail = None  # decide once per stream
        tctx, t0, method = stash
        _tracing.tail_decide(tctx, time.monotonic_ns() - t0,
                             error=error, method=method)

    def _expire(self) -> None:
        """The deadline passed: RST the server and finish the stream."""
        if self._counters is not None:  # an expiry counts as failed
            self._counters.on_finish(False)
            self._counters = None
        self._code = StatusCode.DEADLINE_EXCEEDED
        self._details = "deadline exceeded"
        stash = self._st._tail
        if stash is not None and stash[2]:
            _DEADLINE_EXCEEDED.labels(stash[2]).inc()
        _flight.emit(_flight.DEADLINE_EXPIRED, self._conn._ftag,
                     self._st.stream_id)
        self._tail_decide(error=True)
        try:
            self._conn.writer.send(fr.RST, 0, self._st.stream_id,
                                   fr.rst_payload(StatusCode.DEADLINE_EXCEEDED,
                                                  "deadline exceeded"))
        except (EndpointError, OSError):
            pass
        self._conn.close_stream(self._st)

    def _finish(self, code: StatusCode, details: str, md) -> None:
        if self._counters is not None:
            self._counters.on_finish(code is StatusCode.OK)
            self._counters = None  # a repeated event must not count twice
        self._code, self._details, self._trailing = code, details, md
        self._tail_decide(error=code is not StatusCode.OK)
        if code is StatusCode.OK and not self._conn._flight_first_ok:
            self._conn._flight_first_ok = True
            _flight.emit(_flight.CALL_FIRST_OK, self._conn._ftag)
        if (self._channel is not None and self._channel._compress_flag
                and code is StatusCode.UNIMPLEMENTED
                and fr.COMPRESSED_UNSUPPORTED_SENTINEL in details):
            # the peer cannot decompress: later calls go uncompressed (the
            # unary path also replays this one, see UnaryUnary.with_call)
            self._channel._compress_flag = 0
        self._conn.close_stream(self._st)

    def _next_event(self):
        if self._conn._pump_mode:
            # the inline pump: THIS thread reads the transport until its
            # stream has an event, with no reader-thread wakeup in the trip
            if self._conn._pump_wait(lambda: not self._st.events.empty(),
                                     self._deadline):
                try:
                    return self._st.events.get_nowait()
                except queue.Empty:
                    # the pred held through `not alive`: the death path
                    # delivers the failure right after flipping alive
                    try:
                        return self._st.events.get(timeout=5)
                    except queue.Empty:
                        raise RpcError(
                            StatusCode.UNAVAILABLE,
                            "connection died without delivering status",
                        ) from None
            self._expire()
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "deadline exceeded awaiting response") from None
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
                exc = RpcError(code, details, md)
                if self._st.refused:
                    exc._tpurpc_refused = True  # replay-safe: FLAG_REFUSED
                raise exc
            return

    def __iter__(self):
        return self.messages()


_NO_REQUEST = object()


def _status_of(exc: RpcError) -> StatusCode:
    """RpcError's grpcio-style ``code()`` method, tolerant of plain attrs."""
    return exc.code() if callable(exc.code) else exc.code


class RetryPolicy:
    """Client retry policy (gRPC's service-config ``retryPolicy``:
    maxAttempts, backoff, retryableStatusCodes), applied to unary-request
    calls (the whole request is in hand to replay); a call that already
    delivered a response message is never retried, the gRPC retry
    contract.

    >>> ch = Channel(target, retry_policy=RetryPolicy(max_attempts=4))
    """

    __slots__ = ("max_attempts", "initial_backoff", "max_backoff",
                 "backoff_multiplier", "retryable_codes")

    def __init__(self, max_attempts: int = 3, initial_backoff: float = 0.05,
                 max_backoff: float = 1.0, backoff_multiplier: float = 2.0,
                 retryable_codes: Sequence[StatusCode] = (
                     StatusCode.UNAVAILABLE,)):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        self.backoff_multiplier = backoff_multiplier
        self.retryable_codes = tuple(retryable_codes)

    def next_sleep(self, backoff: float,
                   deadline: Optional[float]) -> Optional[float]:
        """The jittered (±20%) clamped sleep for the next retry, or None
        when it would outlive the call deadline."""
        sleep = min(backoff, self.max_backoff)
        sleep *= 1.0 + random.uniform(-0.2, 0.2)
        if deadline is not None and time.monotonic() + sleep >= deadline:
            return None
        return sleep

    def run(self, deadline: Optional[float], attempt_fn, throttle=None):
        """Drive attempt_fn() under this policy. ``throttle`` is the
        channel-wide :class:`~tpurpc_torch.rpc.service_config.RetryThrottle`
        (gRFC A6): retryable failures drain it, successes refill it, and a
        drained bucket suppresses the retry (the failure surfaces)."""
        backoff = self.initial_backoff
        attempt = 0
        while True:
            try:
                result = attempt_fn()
            except RpcError as exc:
                attempt += 1
                code = _status_of(exc)
                retryable = code in self.retryable_codes
                if throttle is not None and retryable:
                    throttle.record_failure()
                if (attempt >= self.max_attempts
                        or not retryable
                        or getattr(exc, "_tpurpc_committed", False)
                        or (throttle is not None
                            and not throttle.allow_retry())):
                    raise
                sleep = self.next_sleep(backoff, deadline)
                # an admission-shedding server names its own backoff
                # (tpurpc-pushback-ms): the FLOOR of the retry sleep
                pushback = _pushback_s(exc)
                if pushback is not None:
                    sleep = pushback if sleep is None else max(sleep,
                                                               pushback)
                    if (deadline is not None
                            and time.monotonic() + sleep >= deadline):
                        sleep = None
                if sleep is None:
                    raise
                time.sleep(sleep)
                backoff *= self.backoff_multiplier
            else:
                if throttle is not None:
                    throttle.record_success()
                return result


class HedgingPolicy:
    """gRFC A6 hedging: up to ``max_attempts`` copies of one unary call in
    flight, staggered ``hedging_delay`` apart, each preferring a subchannel
    the call hasn't used yet. The first usable response wins and the losers
    are cancelled (RST on their streams); a failure with a status in
    ``non_fatal_codes`` fires the next hedge IMMEDIATELY instead of waiting
    out the delay; any other failure is fatal and resolves the call.

    The method must be idempotent (two servers may both execute it). All
    attempts share ONE deadline (the caller's timeout, anchored once), the
    channel-wide retry throttle gates every hedge beyond the first, and a
    server's admission pushback stops further hedging outright.

    >>> ch = Channel(target, lb_policy="round_robin",
    ...              hedging_policy=HedgingPolicy(max_attempts=3,
    ...                                           hedging_delay=0.01))
    """

    __slots__ = ("max_attempts", "hedging_delay", "non_fatal_codes")

    def __init__(self, max_attempts: int = 2, hedging_delay: float = 0.05,
                 non_fatal_codes: Sequence[StatusCode] = (
                     StatusCode.UNAVAILABLE,)):
        if max_attempts < 2:
            raise ValueError("max_attempts must be >= 2")
        if hedging_delay < 0:
            raise ValueError("hedging_delay must be >= 0")
        self.max_attempts = int(max_attempts)
        self.hedging_delay = float(hedging_delay)
        self.non_fatal_codes = tuple(non_fatal_codes)


class _MultiCallable:
    def __init__(self, channel: Channel, method: str,
                 serializer: Serializer, deserializer: Deserializer,
                 allow_native: bool = True):
        self._channel = channel
        self._method = method
        self._ser = serializer
        self._deser = deserializer
        #: the factory's ``tpurpc_native``: False keeps this method off the
        #: native fast paths
        self._allow_native = allow_native

    def _dial(self, wait_for_ready: bool, deadline: Optional[float],
              exclude=None, picked=None) -> _Connection:
        """One LB-picked connection. With ``wait_for_ready`` (the grpcio
        per-call flag), a channel in TRANSIENT_FAILURE QUEUES the call —
        keep redialing until the deadline — instead of failing it fast
        (fail-fast is the default)."""
        if not wait_for_ready:
            return self._channel._connection(exclude=exclude, picked=picked)
        while True:
            try:
                return self._channel._connection(exclude=exclude,
                                                 picked=picked)
            except RpcError as exc:
                if (self._channel._is_closed()
                        or _status_of(exc) is not StatusCode.UNAVAILABLE):
                    raise
                if deadline is not None and time.monotonic() >= deadline:
                    raise RpcError(
                        StatusCode.DEADLINE_EXCEEDED,
                        "deadline exceeded waiting for channel readiness",
                    ) from exc
                # Subchannel.get already sleeps through its backoff; this
                # only paces the no-deadline case. The deadline is checked
                # BETWEEN attempts, so one connect to a blackholed address
                # can overshoot it by up to the channel's connect_timeout.
                time.sleep(0.05)

    def _start(self, metadata: Optional[Metadata], timeout: Optional[float],
               first_request=_NO_REQUEST, wait_for_ready: bool = False,
               exclude=None, picked=None, trace_ctx=_TRACE_UNSET
               ) -> Tuple[_Connection, _ClientStream, Call]:
        """Open a stream and send HEADERS — fused with the only MESSAGE when
        the request is known upfront (one transport write per unary call).

        A connection that turned draining (GOAWAY) between the LB pick and
        ``open_stream`` is redialed transparently: the stream never reached
        the wire."""
        # ONE deadline for the whole call, anchored before the dial: time
        # queued in wait_for_ready counts against the caller's timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        for _ in range(3):
            conn = self._dial(wait_for_ready, deadline,
                              exclude=exclude, picked=picked)
            try:
                st = conn.open_stream()
                break
            except EndpointError:
                if not conn.draining:
                    raise RpcError(StatusCode.UNAVAILABLE,
                                   "connection closed while starting call")
        else:
            raise RpcError(StatusCode.UNAVAILABLE,
                           "no non-draining connection after 3 dials")
        # trace propagation: a sampled (or tail-captured) call carries its
        # context in ordinary metadata; the send is the "client-send"
        # span, and the open "wire" span rides the stream until the
        # terminal closes it on the delivering thread. A caller that drew
        # the sampling decision already passes it as trace_ctx.
        if trace_ctx is _TRACE_UNSET:
            tctx = _tracing.maybe_sample() if _tracing.LIVE else None
        else:
            tctx = trace_ctx
        send_sp = None
        if tctx is not None:
            tctx = tctx.child()  # this call's own span id
            metadata = list(metadata or ())
            metadata.append((_tracing.HEADER, tctx.encode()))
            send_sp = _tracing.begin("client-send", tctx)
            # open the wire span BEFORE the write: on a loopback transport
            # the server can parse HEADERS before send_many returns, and
            # the wire interval must enclose every server-side span
            st._wire_span = _tracing.begin("wire", tctx)
        st._tail = (tctx, time.monotonic_ns(), self._method)
        try:
            timeout_us = (None if deadline is None else
                          max(0, int((deadline - time.monotonic()) * 1e6)))
            hdr = fr.headers_payload(self._method, metadata or (), timeout_us)
            with _tracing.use(tctx) if tctx is not None \
                    else _tracing.NULL_CM:
                if first_request is _NO_REQUEST:
                    conn.writer.send(fr.HEADERS, 0, st.stream_id, hdr)
                else:
                    conn.writer.send_many([
                        (fr.HEADERS, 0, st.stream_id, hdr),
                        (fr.MESSAGE,
                         fr.FLAG_END_STREAM | self._channel._compress_flag,
                         st.stream_id, self._ser(first_request)),
                    ])
            _tracing.finish(send_sp)
        except fr.FrameError as exc:
            conn.close_stream(st)
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED, str(exc)) from exc
        except (EndpointError, OSError) as exc:
            err = RpcError(StatusCode.UNAVAILABLE, f"transport failed: {exc}")
            if st.refused:
                # A draining server refused the stream (RST|FLAG_REFUSED: no
                # handler ran) while its request was still being written, and
                # the drained connection closed behind the refusal: the send
                # fails, but the refusal stands, and the call may be replayed.
                # (The reference fails such a call with this detail.)
                err._tpurpc_refused = True
            elif conn.draining:
                # Its GOAWAY arrived first and the drained connection closed
                # before the request was whole: no handler ran. Only
                # PipelinedUnary replays on this mark; every other path
                # fails UNAVAILABLE, as the reference does.
                err._tpurpc_unsent = True
            else:
                raise err from exc
            if picked:
                err._tpurpc_sub = picked[-1]
            raise err from exc
        counters = self._channel.call_counters
        counters.on_start()
        return conn, st, Call(conn, st, self._deser, deadline,
                              counters=counters, channel=self._channel)

    @staticmethod
    def _instruments_live() -> bool:
        """An open copy-ledger window or live profiling spans measure the
        INSTRUMENTED Python data plane: do not route around them."""
        from tpurpc_torch.tpu import ledger as _ledger

        return _ledger.tracking() or _stats.profiling_on()

    def _try_native_stream(self, request_iterator: Iterable,
                           timeout: Optional[float],
                           pre_serialized: bool = False):
        """The shared native-stream entry of the three streaming shapes: an
        eager :class:`_NativeStreamCall` through the channel's fast path,
        or None to use the Python transport (an ineligible channel, a live
        measurement window, or a dead cached fast channel, which is
        invalidated so the next call re-dials; nothing was sent, so the
        Python path is always safe)."""
        if self._instruments_live():
            return None
        nch = self._channel._native_fast()
        if nch is None:
            return None
        # a sampled stream carries its trace context through
        # tpr_call_start's metadata: the same wire key and the same
        # server-side extraction as the Python plane
        md = None
        if _tracing.LIVE:
            tctx = _tracing.maybe_sample()
            if tctx is not None:
                md = [(_tracing.HEADER, tctx.child().encode())]
        try:
            nc = nch.start_call(self._method, timeout, metadata=md)
        except RpcError:
            self._channel._native_invalidate(nch)
            return None
        ser = (lambda x: x) if pre_serialized else self._ser
        return _NativeStreamCall(self._channel, nc, ser, self._deser,
                                 request_iterator, timeout)

    def _send_stream(self, conn: _Connection, st: _ClientStream,
                     request_iterator: Iterable) -> None:
        try:
            for request in request_iterator:
                if st.done:
                    return  # server already terminated the call
                conn.writer.send(fr.MESSAGE, self._channel._compress_flag,
                                 st.stream_id, self._ser(request))
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


def _reject_call_credentials(grpcio_kw: dict) -> None:
    """grpcio callers may pass credentials/wait_for_ready/compression per
    call. wait_for_ready is honored (queue instead of fail-fast, see
    _MultiCallable._dial); per-call compression is advisory; per-call
    CREDENTIALS are a security feature that must not be silently
    dropped."""
    if grpcio_kw.get("credentials") is not None:
        raise NotImplementedError(
            "per-call credentials are not supported; use channel credentials")


class UnaryUnary(_MultiCallable):
    #: (NativeChannel, native multicallable) cache, rebuilt when the channel
    #: re-dials its fast path after a failure
    _native_mc: "Optional[tuple]" = None

    def __call__(self, request, timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None, **grpcio_kw):
        _reject_call_credentials(grpcio_kw)
        # one sampling decision per call, drawn here and handed down to
        # every retry and hedge attempt, which share its trace id
        tctx = _tracing.maybe_sample() if _tracing.LIVE else None
        # the native fast path: a plain response-only unary call with no
        # per-call extras runs inside the C core's inline-read loop. Per-
        # call metadata, wait-for-ready (per call or from the service
        # config), hedging and a sampled trace (the unary native entry has
        # no metadata to carry it) stay on the Python transport; a
        # tail-provisional context does not, and _native_call records a
        # post-hoc span iff the call turns out slow or failed
        plan = self._channel._call_plan(self._method, None)
        if ((tctx is None or getattr(tctx, "provisional", False))
                and self._allow_native and not metadata
                and not grpcio_kw.get("wait_for_ready")
                and not plan[3]
                and plan[4] is None
                and not self._instruments_live()):
            nch = self._channel._native_fast()
            if nch is not None:
                done, resp = self._native_call(nch, request, timeout, tctx)
                if done:
                    return resp
        response, _ = self.with_call(request, timeout=timeout,
                                     metadata=metadata, _trace_ctx=tctx,
                                     **grpcio_kw)
        return response

    def _native_call(self, nch, request, timeout: Optional[float],
                     tctx=None):
        """One unary call inside the native loop: ``(True, resp)``, or
        ``(False, None)`` to fall back to the Python transport, which is
        allowed only for failures that PROVE no handler ran (refused or
        connect-time), so a fallback never re-executes a committed call.
        The retry policy runs over it as over the Python path."""
        cached = self._native_mc
        if cached is None or cached[0] is not nch:
            cached = (nch, nch.unary_unary(self._method))
            self._native_mc = cached
        mc = cached[1]
        counters = self._channel.call_counters
        policy, timeout, throttle, _, _hedging = self._channel._call_plan(
            self._method, timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        recv_limit = self._channel.max_receive_message_length

        def attempt():
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            counters.on_start()
            try:
                body = mc(self._ser(request), timeout=remaining)
                if recv_limit is not None and len(body) > recv_limit:
                    # the native loop does not enforce the receive limit,
                    # so the contract holds here
                    raise RpcError(
                        StatusCode.RESOURCE_EXHAUSTED,
                        "received message larger than "
                        "max_receive_message_length")
            except RpcError:
                counters.on_finish(False)
                raise
            counters.on_finish(True)
            return _deserialize(self._deser, body)

        t0 = time.monotonic_ns() if tctx is not None else 0

        def _tail(error: bool) -> None:
            if tctx is None:
                return
            dur = time.monotonic_ns() - t0
            if _tracing.tail_decide(tctx, dur, error=error,
                                    method=self._method):
                _tracing.record("native-unary", tctx, t0, dur,
                                method=self._method)

        try:
            if policy is None:
                result = attempt()
            else:
                result = policy.run(deadline, attempt, throttle=throttle)
            _tail(error=False)
            return True, result
        except RpcError as exc:
            _tail(error=True)
            if _status_of(exc) is StatusCode.UNAVAILABLE:
                # a dead fast-path connection: drop it so the next call
                # re-dials, and replay on the Python transport only when
                # the C loop's machine-readable verdict (_tpurpc_preexec)
                # says the server never saw a complete request. A post-send
                # death surfaces as the Python transport's mid-call death
                # does. The draining wording is the one compat signal left
                # (a refusal sent without FLAG_REFUSED).
                self._channel._native_invalidate(nch)
                if (getattr(exc, "_tpurpc_preexec", False)
                        or "connection draining" in (exc.details() or "")):
                    return False, None
            raise

    def with_call(self, request, timeout: Optional[float] = None,
                  metadata: Optional[Metadata] = None,
                  _trace_ctx=_TRACE_UNSET, **grpcio_kw):
        """``(response, call)``; the call carries the trailing metadata and
        the connection's device ring. Runs under the call plan: a retry
        policy, else a hedging policy, else one attempt — each with the
        transparent replay of refused streams. With profiling on
        (``TPURPC_PROFILING``) the whole call is the ``cli_unary`` span.
        ``_trace_ctx`` is ``__call__``'s sampling decision, which every
        attempt shares; called directly, each attempt draws its own, as in
        the reference."""
        with _stats.profile("cli_unary"):
            return self._with_call_impl(request, timeout, metadata,
                                        _trace_ctx, **grpcio_kw)

    def _with_call_impl(self, request, timeout: Optional[float],
                        metadata: Optional[Metadata], _trace_ctx,
                        **grpcio_kw):
        _reject_call_credentials(grpcio_kw)
        policy, timeout, throttle, eff_wfr, hedging = \
            self._channel._call_plan(
                self._method, timeout, bool(grpcio_kw.get("wait_for_ready")))
        deadline = None if timeout is None else time.monotonic() + timeout
        if policy is None and hedging is not None:
            return self._hedged_call(request, deadline, metadata, eff_wfr,
                                     hedging, throttle, _trace_ctx)
        #: subchannels that REFUSED this logical call (drain): the replay
        #: deprioritizes them, so a draining backend's traffic migrates
        #: instead of re-racing the same GOAWAY
        refused_subs: set = set()

        def remaining():
            return (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))

        def attempt():
            # Transparent retry (distinct from RetryPolicy): a stream the
            # server REFUSED at admission never reached a handler, so
            # replaying it is always safe. Each replay spends from the
            # OUTER deadline; nothing re-anchors it.
            for _ in range(3):
                try:
                    return self._call_once(request, remaining(), metadata,
                                           eff_wfr, trace_ctx=_trace_ctx,
                                           exclude=refused_subs or None)
                except RpcError as exc:
                    # FLAG_REFUSED is the contract; the "connection
                    # draining" wording stays for servers that send the
                    # RST without the flag
                    committed = getattr(exc, "_tpurpc_committed", False)
                    refused = ((getattr(exc, "_tpurpc_refused", False)
                                or (_status_of(exc) is StatusCode.UNAVAILABLE
                                    and "connection draining"
                                    in exc.details()))
                               and not committed)
                    # a peer that cannot decompress rejects the stream
                    # before any handler ran: Call._finish cleared the
                    # channel's flag, and the call replays uncompressed
                    if (not committed and not refused
                            and _status_of(exc) is StatusCode.UNIMPLEMENTED
                            and fr.COMPRESSED_UNSUPPORTED_SENTINEL
                            in exc.details()):
                        self._channel._compress_flag = 0
                        refused = True
                    if not refused:
                        raise
                    sub = getattr(exc, "_tpurpc_sub", None)
                    if sub is not None:
                        refused_subs.add(sub)
            return self._call_once(request, remaining(), metadata, eff_wfr,
                                   trace_ctx=_trace_ctx,
                                   exclude=refused_subs or None)

        if policy is None:
            return attempt()
        return policy.run(deadline, attempt, throttle=throttle)

    def _hedged_call(self, request, deadline: Optional[float],
                     metadata: Optional[Metadata], wait_for_ready: bool,
                     hp: HedgingPolicy, throttle, trace_ctx):
        """The gRFC A6 hedging state machine. The caller's thread drives
        one thread per attempt:

        * attempt 0 launches at once; attempt k+1 launches when the hedging
          delay lapses with nothing resolved, OR at once when an attempt
          fails with a non-fatal status;
        * every launch beyond the first consults the channel-wide retry
          throttle, so hedges never amplify into a retry storm;
        * admission pushback from any attempt stops further hedging;
        * the first OK response wins: the losers' streams are RST and
          their Calls observe CANCELLED. A fatal failure resolves the call
          the same way.

        All attempts share the ONE deadline anchored by the caller; each
        attempt carries its own remaining-budget snapshot, so every
        outstanding attempt self-resolves by the deadline and the final
        wait cannot hang."""
        def remaining():
            return (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))

        results: "queue.Queue[tuple]" = queue.Queue()
        lock = threading.Lock()
        calls: dict = {}        # attempt idx -> live Call (for cancellation)
        used_subs: set = set()  # prefer-distinct exclusion, cross-attempt
        done = [False]

        def on_call_for(idx):
            def on_call(call, sub):
                cancel_now = False
                with lock:
                    calls[idx] = call
                    if sub is not None:
                        used_subs.add(sub)
                    if done[0]:
                        cancel_now = True  # raced the winner: die quietly
                if cancel_now:
                    call.cancel()
            return on_call

        def run_attempt(idx):
            refused_local: set = set()
            last_exc = None
            for _ in range(3):  # transparent refused-replay, per attempt
                with lock:
                    excl = set(used_subs) | refused_local
                try:
                    resp, call = self._call_once(
                        request, remaining(), metadata, wait_for_ready,
                        trace_ctx=trace_ctx, exclude=excl or None,
                        on_call=on_call_for(idx))
                    results.put((idx, (resp, call), None))
                    return
                except RpcError as exc:
                    last_exc = exc
                    if (getattr(exc, "_tpurpc_refused", False)
                            and not getattr(exc, "_tpurpc_committed",
                                            False)):
                        sub = getattr(exc, "_tpurpc_sub", None)
                        if sub is not None:
                            refused_local.add(sub)
                        continue
                    results.put((idx, None, exc))
                    return
                except BaseException as exc:  # serializer bug etc.
                    results.put((idx, None, exc))
                    return
            results.put((idx, None, last_exc))

        launched = 0
        outstanding = 0
        stop_hedging = False  # flipped by admission pushback

        def may_hedge():
            return (launched < hp.max_attempts and not stop_hedging
                    and (throttle is None or throttle.allow_retry()))

        def launch():
            nonlocal launched, outstanding
            idx = launched
            launched += 1
            outstanding += 1
            if idx > 0:
                _HEDGES_FIRED.inc()
                _flight.emit(_flight.HEDGE_FIRED, _HEDGE_TAG, idx)
            threading.Thread(target=run_attempt, args=(idx,), daemon=True,
                             name="tpurpc-hedge").start()

        def finish(win_idx=None):
            with lock:
                done[0] = True
                losers = [(i, c) for i, c in calls.items() if i != win_idx]
            for i, call in losers:
                try:
                    call.cancel()
                except Exception:
                    pass
                if win_idx is not None:
                    _flight.emit(_flight.HEDGE_CANCELLED, _HEDGE_TAG, i)

        launch()
        last_failure = None
        while True:
            wait = hp.hedging_delay if may_hedge() else None
            rem = remaining()
            if rem is not None and (wait is None or rem < wait):
                # bound the wait by the budget + slack: outstanding
                # attempts self-expire at the deadline and deliver here
                wait = rem + 1.0
            try:
                idx, ok, exc = results.get(timeout=wait)
            except queue.Empty:
                if may_hedge():
                    launch()  # the delay lapsed unresolved: hedge
                    continue
                if outstanding > 0:
                    continue  # attempts carry their own deadline
                finish()
                raise last_failure if last_failure is not None else RpcError(
                    StatusCode.DEADLINE_EXCEEDED,
                    "deadline exceeded before any hedged attempt resolved")
            outstanding -= 1
            if exc is None:
                resp, call = ok
                if idx > 0:
                    _HEDGES_WON.inc()
                _flight.emit(_flight.HEDGE_WON, _HEDGE_TAG, idx)
                finish(win_idx=idx)
                if throttle is not None:
                    throttle.record_success()
                return resp, call
            if done[0]:
                continue  # a cancelled loser reporting in: ignore
            if isinstance(exc, RpcError):
                code = _status_of(exc)
                retryable = (code in hp.non_fatal_codes
                             and not getattr(exc, "_tpurpc_committed",
                                             False))
                if throttle is not None and retryable:
                    throttle.record_failure()
                if _pushback_s(exc) is not None:
                    stop_hedging = True  # the fleet is shedding: no more
                if retryable:
                    last_failure = exc
                    if may_hedge():
                        launch()  # gRFC A6: non-fatal fires the next
                        continue  # hedge immediately
                    if outstanding > 0:
                        continue
                    finish()
                    raise exc
            # fatal failure (or a non-RpcError bug): resolve now
            finish()
            raise exc

    def _call_once(self, request, timeout: Optional[float],
                   metadata: Optional[Metadata], wait_for_ready: bool = False,
                   trace_ctx=_TRACE_UNSET, exclude=None, on_call=None):
        """One wire attempt. ``exclude`` deprioritizes subchannels this
        logical call already touched (drain migration / hedge spread);
        ``on_call(call, subchannel)`` fires as soon as the stream is open —
        the hedging orchestrator registers the Call for cross-attempt
        cancellation there. A failure carries the subchannel it ran on as
        ``_tpurpc_sub`` so callers can extend their exclusion set, and
        ``_tpurpc_committed`` once a response message was delivered."""
        picked: list = []
        conn, st, call = self._start(metadata, timeout, first_request=request,
                                     wait_for_ready=wait_for_ready,
                                     trace_ctx=trace_ctx,
                                     exclude=exclude, picked=picked)
        if on_call is not None:
            on_call(call, picked[-1] if picked else None)
        response = None
        got = False
        try:
            for msg in call.messages():
                if got:
                    raise RpcError(StatusCode.INTERNAL,
                                   "unary call received multiple responses")
                response, got = msg, True
        except RpcError as exc:
            if got:
                # a response message was already delivered: the call is
                # committed — replaying it would re-execute the handler
                exc._tpurpc_committed = True
            if picked:
                exc._tpurpc_sub = picked[-1]
            raise
        if not got:
            raise RpcError(StatusCode.INTERNAL, "unary call received no response")
        return response, call

    def future(self, request, timeout: Optional[float] = None,
               metadata: Optional[Metadata] = None
               ) -> "concurrent.futures.Future":
        """Minimal future: runs the call on a daemon thread. The caller's
        ring_hash key (a thread-local) is captured NOW and re-installed in
        the worker thread, so keyed routing survives the thread hop."""
        key = getattr(_resolver._call_key, "key", None)
        fut: "concurrent.futures.Future" = concurrent.futures.Future()

        def run():
            if not fut.set_running_or_notify_cancel():
                return
            try:
                if key is not None:
                    with _resolver.ring_hash_key(key):
                        fut.set_result(self(request, timeout, metadata))
                else:
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
    a ``concurrent.futures.Future``; the connection's reader (its reader
    thread, or on a pump-mode connection whichever thread owns the pump)
    demuxes completions by stream id and resolves each future in place, so
    N in-flight calls cost N streams, not N threads waiting on replies. A
    pump-mode connection has no reader thread, so one servicing thread per
    connection pumps it while this pipeline has calls in flight and exits
    when the window drains. A call's deadline is one entry on the
    process-wide timer wheel (``utils/timers.py``), cancelled when the call
    ends. The bounded window (``depth``) backpressures callers: the
    depth+1'th ``call_async`` blocks until a completion frees a slot, which
    is what keeps a fast client from ballooning server-side queues.

    Completion (including response deserialization) runs on the delivering
    thread — keep deserializers cheap (the tensor codec's zero-copy decode
    qualifies). Out-of-order completion across streams is the point: a
    slow call does not head-of-line-block its siblings' futures.

    A refused call migrates (:meth:`call_async`). Each attempt registers
    with the stall watchdog; every resolved call records
    ``pipeline_call_us`` and ``pipeline_demux_us``, and the window's
    in-flight count is the ``pipeline_inflight`` fleet gauge.
    """

    #: how often a servicing thread returns the pump and re-checks
    #: ``close()``: a pump wait with no deadline would block on the
    #: transport until the next frame
    _SERVICE_SLICE_S = 0.25
    #: replays of a refused call (the reference's cap)
    _MAX_REPLAYS = 3

    def __init__(self, mc: UnaryUnary, depth: int = 16):
        self._mc = mc
        self.depth = max(1, int(depth))
        self._window = threading.BoundedSemaphore(self.depth)
        self._lock = threading.Lock()
        self._inflight = 0
        self._closed = False
        #: id(connection) -> its servicing thread (pump-mode connections)
        self._pump_threads: Dict[int, threading.Thread] = {}
        _PIPELINES_INFLIGHT.track(self)

    def call_async(self, request, timeout: Optional[float] = None,
                   metadata: Optional[Metadata] = None
                   ) -> "concurrent.futures.Future":
        """One pipelined call; returns a Future of the deserialized
        response. Blocks only for a window slot (backpressure), never for
        the response.

        A REFUSED terminal (a draining server, or a max-age GOAWAY race:
        the server certifies no handler ran) replays on another
        subchannel instead of failing the future, up to
        :data:`_MAX_REPLAYS` times under the original deadline: the
        refusing subchannel joins the call's exclusion set, and the next
        attempt dials off the delivering thread, on ``run_blocking``'s
        pool. A replay that raises fails the future; a refusal that is
        final fails it with ``_tpurpc_refused`` set."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if not self._window.acquire(timeout=timeout):
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "deadline exceeded waiting for pipeline window")
        t_start = time.perf_counter_ns()
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        #: ``cur`` is the current attempt: its stream, call, watchdog token
        #: and subchannel; a replay replaces it
        state = {"claimed": False, "timer": None, "replays": 0,
                 "exclude": set(), "cur": None}

        def claim() -> bool:
            """Once-only: the terminal, the deadline or a failed replay
            resolves the call."""
            with self._lock:
                if state["claimed"]:
                    return False
                state["claimed"] = True
                self._inflight -= 1
            self._window.release()
            timer = state["timer"]
            if timer is not None:
                timer.cancel()
            return True

        def fail(exc: BaseException) -> None:
            if claim() and fut.set_running_or_notify_cancel():
                fut.set_exception(exc)

        def replay() -> None:
            if state["claimed"]:
                return  # expired while queued
            try:
                start_attempt()
            except BaseException as exc:
                fail(exc)

        def refused_again(exc: BaseException) -> bool:
            """Count one more replay of a refused call, excluding the
            refusing subchannel; False once the replays are spent."""
            with self._lock:
                if (not getattr(exc, "_tpurpc_refused", False)
                        or state["replays"] >= self._MAX_REPLAYS
                        or state["claimed"]):
                    return False
                state["replays"] += 1
            sub = getattr(exc, "_tpurpc_sub", None)
            if sub is not None:
                state["exclude"].add(sub)
            return True

        def start_attempt() -> None:
            while True:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                picked: list = []
                try:
                    conn, st, call = self._mc._start(
                        metadata, remaining, first_request=request,
                        exclude=state["exclude"] or None, picked=picked)
                    break
                except RpcError as exc:
                    # the request's write failed on a connection a draining
                    # server refused or closed: no handler ran, so replay
                    # at once, on this thread (a divergence: the reference
                    # raises from call_async)
                    if getattr(exc, "_tpurpc_unsent", False):
                        exc._tpurpc_refused = True
                    if not refused_again(exc):
                        raise
            # no thread waits on a pipelined call: the stall watchdog is
            # the only observer that can see it wedge and name the stage
            tctx = st._tail[0] if st._tail is not None else None
            wd_tok = _watchdog.call_started(
                self._mc._method, tctx.trace_id if tctx is not None else 0,
                kind="client")
            cur = {"st": st, "call": call, "wd": wd_tok, "fired": False,
                   "sub": picked[-1] if picked else None}
            state["cur"] = cur

            def complete():
                with self._lock:
                    if cur["fired"]:
                        return  # hook + done-fallback both ran: once only
                    cur["fired"] = True
                msgs = []
                code, details, md = None, "", []
                while True:
                    try:
                        ev = st.events.get_nowait()
                    except queue.Empty:
                        break
                    if ev[0] == "message":
                        st.release_credit()  # the reader may commit more
                        msgs.append(ev[1])
                    elif ev[0] == "trailers":
                        _, code, details, md = ev
                if code is None:  # terminal hook without a queued trailer
                    code, details = (StatusCode.INTERNAL,
                                     "terminal without status")
                refused = (code is not StatusCode.OK and not msgs
                           and st.refused)
                exc = None
                if code is not StatusCode.OK:
                    exc = RpcError(code, details, md)
                    if refused:
                        exc._tpurpc_refused = True
                        exc._tpurpc_sub = cur["sub"]
                if refused and refused_again(exc):
                    # migrate: the refusing subchannel is excluded and the
                    # call replays, off this (delivering) thread, which
                    # must not block in a dial
                    call._finish(code, details, md)
                    _watchdog.call_finished(wd_tok, error=True)
                    _timers.run_blocking(replay)
                    return
                if not claim():
                    # the deadline already failed the future; an attempt
                    # it did not see (a replay dialed while it fired) still
                    # ends its call and its watchdog registration here
                    call._finish(code, details, md)
                    _watchdog.call_finished(wd_tok, error=True)
                    return
                call._finish(code, details, md)
                _watchdog.call_finished(wd_tok,
                                        error=code is not StatusCode.OK)
                if not fut.set_running_or_notify_cancel():
                    return  # the caller cancelled the future
                if code is not StatusCode.OK:
                    fut.set_exception(exc)
                elif len(msgs) != 1:
                    fut.set_exception(RpcError(
                        StatusCode.INTERNAL,
                        "unary call received no response" if not msgs
                        else "unary call received multiple responses"))
                else:
                    try:
                        fut.set_result(_deserialize(self._mc._deser,
                                                    msgs[0]))
                    except BaseException as exc:  # a raising deserializer
                        fut.set_exception(exc)    # fails, never hangs
                now = time.perf_counter_ns()
                _PIPE_CALL_US.record((now - t_start) // 1000)
                if st._t_terminal:
                    _PIPE_DEMUX_US.record((now - st._t_terminal) // 1000)

            # Hook AFTER the send: the terminal may already have been
            # delivered (fast server + slow caller), in which case st.done
            # is set and the hook will never fire — complete from here
            # instead. cur["fired"] makes the two funnels once-only.
            st.on_terminal = complete
            if st.done:
                complete()
            self._ensure_pump(conn)

        with self._lock:
            self._inflight += 1
        try:
            start_attempt()
        except BaseException:
            with self._lock:
                self._inflight -= 1
            self._window.release()
            raise
        if deadline is not None:
            # No thread waits on this call, so the deadline needs its own
            # timer: expire RSTs the CURRENT attempt's stream and fails the
            # future. One absolute deadline covers every replay.
            def expire():
                if not claim():
                    return
                cur = state["cur"]
                if cur is not None:
                    cur["call"]._expire()
                    _watchdog.call_finished(cur["wd"], error=True)
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(RpcError(
                        StatusCode.DEADLINE_EXCEEDED,
                        "deadline exceeded awaiting pipelined response"))

            # expire writes an RST (an endpoint write that may stall on
            # backpressure): it runs off the wheel thread
            with self._lock:
                if not state["claimed"]:
                    state["timer"] = _timers.schedule(
                        max(0.0, deadline - time.monotonic()),
                        lambda: _timers.run_blocking(expire))
        return fut

    # -- pump-mode servicing --------------------------------------------------

    def _ensure_pump(self, conn: _Connection) -> None:
        """A pump-mode connection has no reader thread: with every caller
        detached (futures, nobody in ``_pump_wait``) its transport would
        never be read. One servicing thread per live connection pumps while
        this pipeline has calls in flight."""
        if not conn._pump_mode:
            return
        key = id(conn)
        with self._lock:
            t = self._pump_threads.get(key)
            if t is not None and t.is_alive():
                return
            t = threading.Thread(target=self._pump_loop, args=(conn, key),
                                 daemon=True, name="tpurpc-pipeline-pump")
            self._pump_threads[key] = t
        t.start()

    def _pump_loop(self, conn: _Connection, key: int) -> None:
        try:
            while True:
                conn._pump_wait(lambda: self._idle() or not conn.alive,
                                time.monotonic() + self._SERVICE_SLICE_S)
                with self._lock:
                    if self._idle() or not conn.alive:
                        self._pump_threads.pop(key, None)
                        return
        except Exception:
            with self._lock:
                self._pump_threads.pop(key, None)

    def _idle(self) -> bool:
        return self._inflight == 0 or self._closed

    def close(self) -> None:
        """Stop servicing. Outstanding futures still resolve when their
        terminals are read; pump-mode servicing threads wind down."""
        with self._lock:
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _RetryingStreamCall:
    """Call-shaped wrapper retrying a server-streaming RPC that failed
    BEFORE its first response message (gRPC's retry rule for streams: once
    anything was delivered the call is committed). The request is unary,
    so replay is always possible. Start failures (dial, admission) consume
    retry attempts exactly like stream failures; one attempt/backoff
    budget spans the whole call. Cancellation during a backoff sleep stops
    further replays."""

    def __init__(self, mc: "UnaryStream", request, timeout, metadata,
                 policy: RetryPolicy, wait_for_ready: bool = False,
                 throttle=None):
        self._inner: Optional[Call] = None  # first: __getattr__ recursion guard
        self._mc = mc
        self._request = request
        self._deadline = (None if timeout is None
                          else time.monotonic() + timeout)
        self._metadata = metadata
        self._policy = policy
        self._throttle = throttle  # channel-wide gRFC A6 token bucket
        self._wait_for_ready = wait_for_ready
        self._attempt = 0
        self._backoff = policy.initial_backoff
        self._cancelled = False
        self._start_with_retry()  # eager start, grpcio semantics

    def _handle_failure(self, exc: RpcError, committed: bool) -> None:
        """Count the attempt; sleep for the backoff; or re-raise."""
        self._attempt += 1
        retryable = _status_of(exc) in self._policy.retryable_codes
        if self._throttle is not None and retryable:
            self._throttle.record_failure()
        if (self._cancelled or committed
                or self._attempt >= self._policy.max_attempts
                or not retryable
                or (self._throttle is not None
                    and not self._throttle.allow_retry())):
            raise exc
        sleep = self._policy.next_sleep(self._backoff, self._deadline)
        pushback = _pushback_s(exc)  # admission shed: server-named floor
        if pushback is not None:
            sleep = pushback if sleep is None else max(sleep, pushback)
            if (self._deadline is not None
                    and time.monotonic() + sleep >= self._deadline):
                sleep = None
        if sleep is None:
            raise exc
        time.sleep(sleep)
        self._backoff *= self._policy.backoff_multiplier
        if self._cancelled:  # cancelled while we slept: stop replaying
            raise exc

    def _start_with_retry(self) -> None:
        while True:
            try:
                remaining = (None if self._deadline is None
                             else max(0.0, self._deadline - time.monotonic()))
                _, _, self._inner = self._mc._start(
                    self._metadata, remaining, first_request=self._request,
                    wait_for_ready=self._wait_for_ready)
                return
            except RpcError as exc:
                self._handle_failure(exc, committed=False)

    def messages(self) -> Iterator[object]:
        while True:
            delivered = False
            try:
                for msg in self._inner.messages():
                    delivered = True
                    yield msg
                if self._throttle is not None:
                    self._throttle.record_success()
                return
            except RpcError as exc:
                self._handle_failure(exc, committed=delivered)
                self._start_with_retry()

    def __iter__(self):
        return self.messages()

    def cancel(self):
        self._cancelled = True
        if self._inner is not None:
            self._inner.cancel()

    def __getattr__(self, name):
        # the rest of the Call surface (time_remaining, device_ring, ...)
        # goes to the CURRENT attempt's call
        return getattr(self._inner, name)


def _drain_single_response(messages) -> object:
    """The exactly-one-response rule of a stream-unary call."""
    response = None
    got = False
    for msg in messages:
        if got:
            raise RpcError(StatusCode.INTERNAL,
                           "unary call received multiple responses")
        response, got = msg, True
    if not got:
        raise RpcError(StatusCode.INTERNAL, "unary response missing")
    return response


class UnaryStream(_MultiCallable):
    def __call__(self, request, timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None, **grpcio_kw):
        _reject_call_credentials(grpcio_kw)
        policy, timeout, throttle, wfr, _hedging = self._channel._call_plan(
            self._method, timeout, bool(grpcio_kw.get("wait_for_ready")))
        # the native fast path (retrying and wait-for-ready calls stay on
        # the Python transport); cheap eligibility first, so a call headed
        # for the Python path is not serialized twice
        if (policy is None and self._allow_native and not metadata
                and not wfr
                and not self._instruments_live()
                and self._channel._native_fast() is not None):
            # serialize EAGERLY: the Python path raises serializer errors
            # at call time, and the native path must not defer them
            raw = self._ser(request)
            nsc = self._try_native_stream(iter([raw]), timeout,
                                          pre_serialized=True)
            if nsc is not None:
                return nsc
        if policy is None:
            _, _, call = self._start(metadata, timeout, first_request=request,
                                     wait_for_ready=wfr)
            return call
        return _RetryingStreamCall(self, request, timeout, metadata, policy,
                                   wfr, throttle=throttle)


class StreamUnary(_MultiCallable):
    def __call__(self, request_iterator: Iterable,
                 timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None, **grpcio_kw):
        _reject_call_credentials(grpcio_kw)
        _, timeout, _, wfr, _hedging = self._channel._call_plan(
            self._method, timeout, bool(grpcio_kw.get("wait_for_ready")))
        if self._allow_native and not metadata and not wfr:
            nsc = self._try_native_stream(request_iterator, timeout)
            if nsc is not None:
                return _drain_single_response(nsc)
        conn, st, call = self._start(metadata, timeout, wait_for_ready=wfr)
        sender = threading.Thread(
            target=self._send_stream, args=(conn, st, request_iterator),
            daemon=True, name="tpurpc-stream-sender")
        sender.start()
        response = _drain_single_response(call.messages())
        sender.join(timeout=5)
        return response


class _NativeStreamCall:
    """A call-shaped stream over a native ``NativeCall``. The RPC starts
    EAGERLY (requests flow before the first response is consumed, as on
    the Python transport), ``cancel()`` is safe from any thread (a plain C
    call), responses honor the channel's receive limit, and completions
    feed the channel's call counters."""

    def __init__(self, channel: "Channel", nc, serializer, deserializer,
                 request_iterator, timeout: Optional[float]):
        self._nc = nc
        self._deser = deserializer
        self._code: Optional[StatusCode] = None
        self._details = ""
        self._deadline = (None if timeout is None
                          else time.monotonic() + timeout)
        self._recv_limit = channel.max_receive_message_length
        self._counters = channel.call_counters
        self._counters.on_start()
        self._finished = False
        self._finish_lock = threading.Lock()
        self._callbacks: list = []
        self._app_exc: list = []
        self._sender = threading.Thread(
            target=self._pump_requests, args=(request_iterator, serializer),
            daemon=True, name="tpurpc-native-sender")
        self._sender.start()

    def _pump_requests(self, request_iterator, serializer) -> None:
        try:
            for item in request_iterator:
                self._nc.write(serializer(item))
            self._nc.writes_done()
        except RpcError:
            pass  # the read side surfaces the status
        except BaseException as exc:  # the app's iterator or serializer
            self._app_exc.append(exc)
            self._nc.cancel()  # both sides unblock; the reader sees CANCELLED

    def _finish(self) -> None:
        with self._finish_lock:
            if self._finished:
                return
            self._finished = True
        if self._sender.is_alive():
            # early consumer exit with requests still flowing: RST first so
            # the blocked writer fails fast, THEN join (destroying the call
            # under a live writer is a native use-after-free)
            self._nc.cancel()
        self._sender.join()
        code, details = self._nc.finish()
        self._code, self._details = code, details
        self._nc.close()
        self._counters.on_finish(code is StatusCode.OK)
        for cb in self._callbacks:
            try:
                cb()
            except Exception:
                pass

    def __iter__(self):
        return self

    def __next__(self):
        msg = self._nc.read()
        if msg is None:
            self._finish()
            if self._app_exc:
                raise self._app_exc[0]
            if self._code is not StatusCode.OK:
                raise RpcError(self._code, self._details)
            raise StopIteration
        if self._recv_limit is not None and len(msg) > self._recv_limit:
            self._nc.cancel()
            self._finish()
            self._code = StatusCode.RESOURCE_EXHAUSTED
            self._details = ("received message larger than "
                             "max_receive_message_length")
            raise RpcError(self._code, self._details)
        return _deserialize(self._deser, msg)

    def __del__(self):
        # an abandoned stream: RST and teardown so the server stops
        try:
            if not self._finished:
                self._nc.cancel()
                self._finish()
        except Exception:
            pass

    # -- grpc Call surface ---------------------------------------------------

    def cancel(self) -> None:
        self._nc.cancel()  # thread-safe: a plain C call; the reader unblocks

    def code(self) -> Optional[StatusCode]:
        return self._code

    def details(self) -> str:
        return self._details

    def is_active(self) -> bool:
        return not self._finished

    def time_remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def add_callback(self, callback) -> bool:
        with self._finish_lock:
            if not self._finished:
                self._callbacks.append(callback)
                return True
        return False

    def initial_metadata(self):
        return []

    def trailing_metadata(self):
        return []

    def messages(self) -> Iterator[object]:
        """The response iterator (``UnaryStream`` callers use this name; on
        this wrapper it IS the iterator)."""
        return self

    def device_ring(self):
        """The native loop has no device-ring seam (the ``TPU`` platform is
        never fast-path eligible): callers decode on the host."""
        return None


class StreamStream(_MultiCallable):
    def __call__(self, request_iterator: Iterable,
                 timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None, **grpcio_kw) -> Call:
        _reject_call_credentials(grpcio_kw)
        _, timeout, _, wfr, _hedging = self._channel._call_plan(
            self._method, timeout, bool(grpcio_kw.get("wait_for_ready")))
        # the native bidi fast path: plain calls on eligible channels
        # stream through the C core's loop (the duplex and tensor path)
        if self._allow_native and not metadata and not wfr:
            nsc = self._try_native_stream(request_iterator, timeout)
            if nsc is not None:
                return nsc
        conn, st, call = self._start(metadata, timeout, wait_for_ready=wfr)
        threading.Thread(target=self._send_stream,
                         args=(conn, st, request_iterator),
                         daemon=True, name="tpurpc-stream-sender").start()
        return call


def channel_ready_future(channel: Channel) -> "concurrent.futures.Future":
    """grpc.channel_ready_future's analog: a Future that resolves (to None)
    once the channel reads READY, ``get_state(try_to_connect=True)``
    driving the dial, and fails UNAVAILABLE if the channel closes first.
    Cancel it to stop waiting; the watcher holds only a weak reference, so
    an abandoned future never keeps a dropped channel alive."""
    import weakref

    fut: "concurrent.futures.Future" = concurrent.futures.Future()
    chref = weakref.ref(channel)

    def watch():
        while not fut.cancelled():
            ch = chref()
            if ch is None:
                return  # the channel was dropped: nobody can see READY
            state = ch.get_state(try_to_connect=True)
            del ch  # do not pin the channel across the sleep
            if state is ChannelConnectivity.READY:
                if fut.set_running_or_notify_cancel():
                    fut.set_result(None)
                return
            if state is ChannelConnectivity.SHUTDOWN:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(
                        RpcError(StatusCode.UNAVAILABLE, "channel closed"))
                return
            time.sleep(0.02)

    threading.Thread(target=watch, daemon=True,
                     name="tpurpc-channel-ready").start()
    return fut


def insecure_channel(target: str, **kwargs) -> Channel:
    """grpcio-shaped constructor."""
    return Channel(target, **kwargs)


def secure_channel(target: str, credentials, **kwargs) -> Channel:
    """grpcio-shaped constructor: pass
    :func:`tpurpc_torch.rpc.credentials.ssl_channel_credentials`'s result."""
    return Channel(target, credentials=credentials, **kwargs)
