"""Endpoint: the swappable byte-pipe seam, and the factory that swaps it.

A trimmed copy of ``tpurpc/core/endpoint.py`` (no native raw hook, which
comes with the C core, ROADMAP A7 (a)). Its observability hooks carry the
reference's names: the ``wire`` lens hop of a socket write, the ``wire``
and ``poller-wait`` profiler stages, the ``accept_shed`` counter and the
``ACCEPT_SHED`` flight event under ``accept:<port>``. One
blocking endpoint interface with the byte-pipe
chosen by ``GRPC_PLATFORM_TYPE`` at connection time — ``TcpEndpoint`` for
TCP, ``RingEndpoint`` (a pooled :class:`Pair`) for the ring platforms, and
``TpuRingEndpoint`` (a ring endpoint with a device receive ring) for
``TPU``. ``read_into`` fills ≥1 byte, returns 0 once at clean EOF, or raises
:class:`EndpointError`; ``read`` is the same as bytes; ``write`` accepts the
whole buffer or raises. A ring endpoint's pair may park while idle
(``core/pair.py``): its reads keep waiting through a park, and its writes
wake the peer. ``MockEndpoint`` and :func:`passthru_endpoint_pair` are the
scriptable in-memory endpoints the tests and ``inproc_channel`` build on.

:class:`EndpointListener` accepts in bursts of up to ``accept_burst`` per
wakeup, consults an admission probe for each accepted socket before any
handshake work, and bounds the bootstrap handshakes in flight: a shed
connection costs one accept and one close.

TLS sits under the factory: :func:`connect_endpoint` (``ssl_context=``) and
:class:`EndpointListener` (``ssl_context=``) handshake BEFORE the platform
dispatch, so a ring bootstrap and its notify channel ride the encrypted
socket, and a client that fails the handshake reaches no protocol layer.
``peer_cert`` reads the peer's certificate through whichever lock guards
the socket's SSL object (OpenSSL forbids concurrent use of one ``SSL*``).
"""

from __future__ import annotations

import contextlib
import queue
import select
import socket
import ssl
import threading
import time
from typing import Callable, Optional, Tuple

from tpurpc_torch.core.pair import Pair, PairState
from tpurpc_torch.core.poller import PairPool, Poller, wait_readable, wait_writable
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import lens as _lens
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.utils.config import Platform, get_config

# on the framed (h2-over-TCP) plane the `wire` hop is the socket write; the
# pair plane's is Pair.send (core/pair.py)
_LENS_WIRE_BYTES, _LENS_WIRE_NS, _LENS_WIRE_COPY = _lens.hop_counters("wire")

_LENS_STAGES = {
    "write": "wire",
    "_ssl_send_all": "wire",
    "read": "wire",
    "read_into": "wire",
    "_await_readable": "poller-wait",
}
_profiler.register_stages(__file__, _LENS_STAGES)


class EndpointError(ConnectionError):
    """Transport-level failure; the RPC layer maps it to UNAVAILABLE."""


class ReadTimeout(TimeoutError):
    pass


class Endpoint:
    """Blocking byte-pipe contract."""

    def read_into(self, dst, timeout: Optional[float] = None) -> int:
        """Read ≥1 byte directly into ``dst``; 0 exactly once at clean EOF."""
        raise NotImplementedError

    def read(self, max_bytes: int = 1 << 20,
             timeout: Optional[float] = None) -> bytes:
        """Read ≥1 byte, at most ``max_bytes``; ``b""`` once at clean EOF."""
        buf = bytearray(max_bytes)
        n = self.read_into(buf, timeout=timeout)
        del buf[n:]
        return bytes(buf)

    def write(self, data) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def peer(self) -> str:
        raise NotImplementedError

    @property
    def local_address(self) -> str:
        return "unknown:?"

    def peer_cert(self) -> "Optional[dict]":
        """The peer's TLS certificate (``SSLSocket.getpeercert()``'s dict;
        ``{}`` when the peer sent none), None on a plaintext transport."""
        return None


def _cert_of(sock) -> dict:
    """A TLS socket's peer certificate; ``{}`` when the peer sent none.
    (``getpeercert()`` gives None there on a server that asked for no
    certificate, and the reference passes that on, so its certless TLS
    context reads as plaintext: ROADMAP C.)"""
    cert = sock.getpeercert()
    return {} if cert is None else cert


def _fmt_addr(sock: socket.socket, peer: bool) -> str:
    try:
        addr = sock.getpeername() if peer else sock.getsockname()
    except OSError:
        return "unknown:?"
    if isinstance(addr, tuple):
        return f"ipv4:{addr[0]}:{addr[1]}" if len(addr) == 2 else f"ipv6:[{addr[0]}]:{addr[1]}"
    return f"unix:{addr or '(unnamed)'}"


# ---------------------------------------------------------------------------
# TCP endpoint (the fallback pipe and the bootstrap carrier).
# ---------------------------------------------------------------------------

class TcpEndpoint(Endpoint):
    def __init__(self, sock: socket.socket, preread: bytes = b""):
        self._sock = sock
        #: bytes already consumed by the listener's protocol peek
        self._preread = bytearray(preread)
        #: TLS only: serializes every OpenSSL call on this socket. CPython
        #: releases the GIL around SSL_read/SSL_write and OpenSSL forbids
        #: concurrent use of one SSL*: a reader and a writer racing corrupt
        #: records. Every locked call is non-blocking, and readiness waits
        #: happen outside the lock, so neither direction holds up the other.
        self._ssl_lock = (threading.Lock()
                          if hasattr(sock, "pending") else None)
        # The socket stays blocking; read deadlines are a poll() ahead of
        # the recv (settimeout is per-socket state a writer would clobber;
        # a TLS socket flips it, but only under _ssl_lock).
        sock.setblocking(True)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # unix sockets
        self._peer = _fmt_addr(sock, peer=True)
        self._local = _fmt_addr(sock, peer=False)
        self._closed = False

    def _await_readable(self, timeout: Optional[float]) -> None:
        if timeout is None:
            return
        try:
            p = select.poll()
            p.register(self._sock.fileno(), select.POLLIN)
            r = p.poll(max(0.0, timeout) * 1000.0)
        except (OSError, ValueError) as exc:
            raise EndpointError(f"tcp read failed: {exc}") from exc
        if not r:
            raise ReadTimeout()

    def _ssl_call(self, fn):
        """One non-blocking SSL call under the lock: ``(result, 0)``, or
        ``(None, event)`` when OpenSSL needs the fd ready for ``event``
        (``POLLIN`` or ``POLLOUT``) first. Never blocks inside the lock: a
        reader parked there would hold up every write (the reference parks
        a read there for up to 0.1 s, which delays each reply over TLS on
        TCP by that much at each end: ROADMAP C)."""
        with self._ssl_lock:
            if self._closed:
                raise EndpointError("endpoint closed")
            self._sock.settimeout(0.0)
            try:
                return fn(), 0
            except ssl.SSLWantReadError:
                return None, select.POLLIN
            except (ssl.SSLWantWriteError, BlockingIOError):
                return None, select.POLLOUT
            finally:
                try:
                    self._sock.settimeout(None)
                except OSError:
                    pass

    def _ssl_wait(self, event: int, slice_s: float) -> None:
        """Wait off the lock for the fd to be ready for ``event``."""
        try:
            p = select.poll()
            p.register(self._sock.fileno(), event)
            p.poll(max(0.0, slice_s) * 1000.0)
        except (OSError, ValueError) as exc:
            raise EndpointError(f"tcp failed: {exc}") from exc

    def _ssl_recv(self, fn, timeout: Optional[float]):
        """One serialized SSL read: a locked non-blocking read first
        (decrypted bytes buffered in OpenSSL are invisible to the raw fd),
        then a wait for the fd OUTSIDE the lock, so an idle reader holds
        nothing and a writer is never held up."""
        deadline = (None if timeout is None
                    else time.monotonic() + max(0.0, timeout))
        while True:
            got, event = self._ssl_call(fn)
            if not event:
                return got
            slice_s = 5.0
            if deadline is not None:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise ReadTimeout()
                slice_s = min(remain, slice_s)
            self._ssl_wait(event, slice_s)

    def read_into(self, dst, timeout: Optional[float] = None) -> int:
        if self._closed:
            raise EndpointError("read on closed endpoint")
        if self._preread:
            dst = memoryview(dst).cast("B")
            n = min(len(dst), len(self._preread))
            dst[:n] = self._preread[:n]
            del self._preread[:n]
            return n
        try:
            if self._ssl_lock is not None:
                return self._ssl_recv(lambda: self._sock.recv_into(dst),
                                      timeout)
            self._await_readable(timeout)
            return self._sock.recv_into(dst)
        except ReadTimeout:
            raise  # a TimeoutError, so an OSError: not a transport failure
        except OSError as exc:
            raise EndpointError(f"tcp read failed: {exc}") from exc

    def _ssl_send_all(self, data) -> None:
        """Serialized SSL write in chunks, each a non-blocking call under
        the lock. A chunk OpenSSL could not take must be retried with the
        SAME buffer position, so ``pos`` moves only on success; the wait for
        room happens off the lock, so the reader can drain meanwhile."""
        view = memoryview(data).cast("B")
        pos = 0
        while pos < len(view):
            sent, event = self._ssl_call(
                lambda: self._sock.send(view[pos:pos + 65536]))
            if event:
                self._ssl_wait(event, 1.0)
            else:
                pos += sent

    def write(self, data) -> None:
        if self._closed:
            raise EndpointError("write on closed endpoint")
        t0 = time.monotonic_ns()
        total = 0
        try:
            if self._ssl_lock is not None:
                # an SSLSocket has no sendmsg: TLS re-frames into records
                # anyway, so one join costs what the TLS layer would
                blob = (b"".join(data) if isinstance(data, (list, tuple))
                        else data)
                total = len(blob)
                self._ssl_send_all(blob)
            elif isinstance(data, (list, tuple)):
                # sendmsg may place partially and takes ≤1024 iovecs per
                # call: loop until every byte is on the wire
                views = [memoryview(s).cast("B") for s in data if len(s)]
                total = sum(len(v) for v in views)
                while views:
                    sent = self._sock.sendmsg(views[:1024])
                    while sent:
                        if sent >= len(views[0]):
                            sent -= len(views[0])
                            views.pop(0)
                        else:
                            views[0] = views[0][sent:]
                            sent = 0
            else:
                total = len(memoryview(data).cast("B"))
                self._sock.sendall(data)
        except OSError as exc:
            raise EndpointError(f"tcp write failed: {exc}") from exc
        finally:
            # the `wire` hop: socket bytes and the nanoseconds the kernel
            # handoff took (a full socket buffer is wire time)
            dt = time.monotonic_ns() - t0
            _LENS_WIRE_NS.inc(dt)
            _LENS_WIRE_BYTES.inc(total)
            _LENS_WIRE_COPY.inc(total)

    def close(self) -> None:
        # a TLS socket closes under its lock, so no SSL call is running on
        # the fd: OpenSSL keeps the fd number, and a read still inside it
        # would go on reading whatever connection the number is given to
        # next, and corrupt it
        with self._ssl_lock or contextlib.nullcontext():
            if self._closed:
                return
            self._closed = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()

    @property
    def peer(self) -> str:
        return self._peer

    @property
    def local_address(self) -> str:
        return self._local

    def peer_cert(self) -> "Optional[dict]":
        if self._ssl_lock is None:
            return None  # plaintext
        try:
            with self._ssl_lock:
                return _cert_of(self._sock)
        except (OSError, ValueError):
            return None


def device_ring_of(endpoint: Endpoint):
    """The endpoint's device receive ring, or None off the TPU platform.
    Checks the class attribute first so other endpoints pay nothing."""
    if isinstance(getattr(type(endpoint), "device_ring", None), property):
        return endpoint.device_ring
    return None


# ---------------------------------------------------------------------------
# Ring endpoint.
# ---------------------------------------------------------------------------

class RingEndpoint(Endpoint):
    """A pooled Pair fronted by the Endpoint contract: gather writes map to
    the pair's slice-gather send; reads drain the ring and surface
    close/error."""

    def __init__(self, sock: socket.socket, *, discipline: str,
                 pool_key: str, preread: bytes = b""):
        self.discipline = discipline
        self.pool_key = pool_key
        self._peer_desc = _fmt_addr(sock, peer=True)
        self._local_desc = _fmt_addr(sock, peer=False)
        self.pair: Pair = PairPool.get().take(pool_key)
        try:
            self.pair.connect_over_socket(sock, preread=preread)
        except Exception:
            self.pair.destroy()  # failed bootstrap: release the rings now
            raise
        self._registered = discipline == "hybrid"
        if self._registered:
            Poller.get().add_pollable(self.pair)
        self._closed = False
        #: in-flight read/write count: close() must not return the pair to
        #: the pool while a reader or writer is still inside it
        self._ops_lock = threading.Lock()
        self._ops = 0
        self._ops_idle = threading.Event()
        self._ops_idle.set()

    def _op_enter(self) -> None:
        with self._ops_lock:
            if self._closed:
                raise EndpointError("endpoint closed")
            self._ops += 1
            self._ops_idle.clear()

    def _op_exit(self) -> None:
        with self._ops_lock:
            self._ops -= 1
            if self._ops == 0:
                self._ops_idle.set()

    def read_into(self, dst, timeout: Optional[float] = None) -> int:
        self._op_enter()
        try:
            return self._read_into_locked(dst, timeout)
        finally:
            self._op_exit()

    def _read_into_locked(self, dst, timeout: Optional[float]) -> int:
        dst = memoryview(dst).cast("B")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                n = self.pair.recv_into(dst)
            except ConnectionError as exc:
                raise EndpointError(str(exc)) from exc
            if n:
                return n
            if self._closed:
                raise EndpointError("endpoint closed")
            state = self.pair.get_status()
            if state is PairState.HALF_CLOSED:
                # the peer's final write races its exit flag: drain once more
                try:
                    return self.pair.recv_into(dst)
                except ConnectionError:
                    return 0
            if state in (PairState.ERROR, PairState.DISCONNECTED):
                raise EndpointError(
                    f"ring endpoint unavailable: {state.value}"
                    + (f" ({self.pair.error})" if self.pair.error else ""))
            remain = None if deadline is None else deadline - time.monotonic()
            if remain is not None and remain <= 0:
                raise ReadTimeout()
            wait_readable(self.pair, timeout=remain, discipline=self.discipline)

    def write(self, data) -> None:
        self._op_enter()
        try:
            slices = list(data) if isinstance(data, (list, tuple)) else [data]
            total = sum(len(memoryview(s).cast("B")) for s in slices)
            sent = 0
            while sent < total:
                try:
                    sent += self.pair.send(slices, byte_idx=sent)
                except BrokenPipeError as exc:
                    raise EndpointError(str(exc)) from exc
                if sent < total:
                    if self._closed:
                        raise EndpointError("endpoint closed")
                    # stalled for credits; wait for the peer to drain
                    wait_writable(self.pair, timeout=30,
                                  discipline=self.discipline)
                    if self.pair.get_status() is not PairState.CONNECTED:
                        raise EndpointError(
                            f"peer went away mid-write ({self.pair.state.value})")
        finally:
            self._op_exit()

    def close(self) -> None:
        """Out of the poller, disconnect, wake blocked ops, wait for them to
        drain, back to the pool."""
        with self._ops_lock:
            if self._closed:
                return
            self._closed = True
        if self._registered:
            Poller.get().remove_pollable(self.pair)
        self.pair.disconnect()
        self.pair.kick()  # blocked waiters observe DISCONNECTED
        if not self._ops_idle.wait(timeout=10):
            # an op is wedged past every wake path: never hand this pair to
            # a new owner
            self.pair.destroy()
            return
        PairPool.get().putback(self.pool_key, self.pair)

    @property
    def peer(self) -> str:
        return self._peer_desc

    @property
    def local_address(self) -> str:
        return self._local_desc

    def peer_cert(self) -> "Optional[dict]":
        # a ring keeps the (possibly TLS) bootstrap socket as its pair's
        # notify channel, whose SSL object the pair's notify lock guards;
        # the device-ring endpoint inherits this
        pair = self.pair
        sock = pair.notify_sock
        if sock is None or not hasattr(sock, "getpeercert"):
            return None
        try:
            with pair._notify_lock:
                return _cert_of(sock)
        except (OSError, ValueError):
            return None


# ---------------------------------------------------------------------------
# Test endpoints.
# ---------------------------------------------------------------------------

class _QueueReadEndpoint(Endpoint):
    """Reads of a queue-fed test endpoint: the tail of a chunk larger than
    the read is kept for the next one, and an injected ``b""`` is a sticky
    EOF."""

    def __init__(self, rx: "queue.Queue[bytes]"):
        self._rx = rx
        self._pending = bytearray()
        self._closed = False
        self._eof = False

    def read(self, max_bytes: int = 1 << 20,
             timeout: Optional[float] = None) -> bytes:
        if self._closed:
            raise EndpointError("read on closed endpoint")
        if self._pending:
            out = bytes(self._pending[:max_bytes])
            del self._pending[:max_bytes]
            return out
        if self._eof:
            return b""
        try:
            data = self._rx.get(timeout=timeout)
        except queue.Empty:
            raise ReadTimeout() from None
        if data == b"":
            self._eof = True
        self._pending += data[max_bytes:]
        return data[:max_bytes]

    def read_into(self, dst, timeout: Optional[float] = None) -> int:
        dst = memoryview(dst).cast("B")
        data = self.read(len(dst), timeout=timeout)
        dst[:len(data)] = data
        return len(data)

    def close(self) -> None:
        self._closed = True


class MockEndpoint(_QueueReadEndpoint):
    """Scriptable endpoint: the test injects reads and captures writes."""

    def __init__(self, peer: str = "mock:peer"):
        super().__init__(queue.Queue())
        self.written = bytearray()
        self._peer_name = peer

    def inject(self, data: bytes) -> None:
        self._rx.put(data)

    def inject_eof(self) -> None:
        self._rx.put(b"")

    def write(self, data) -> None:
        if self._closed:
            raise EndpointError("write on closed endpoint")
        slices = data if isinstance(data, (list, tuple)) else [data]
        for s in slices:
            self.written += bytes(s)

    @property
    def peer(self) -> str:
        return self._peer_name

    @property
    def local_address(self) -> str:
        return "mock:local"


class _PassthruHalf(_QueueReadEndpoint):
    """One end of :func:`passthru_endpoint_pair`."""

    def __init__(self, rx: queue.Queue, tx: queue.Queue, name: str):
        super().__init__(rx)
        self._tx, self._name = tx, name

    def write(self, data) -> None:
        if self._closed:
            raise EndpointError("write on closed endpoint")
        slices = data if isinstance(data, (list, tuple)) else [data]
        payload = b"".join(bytes(s) for s in slices)
        if payload:
            self._tx.put(payload)

    def close(self) -> None:
        if not self._closed:
            super().close()
            self._tx.put(b"")

    @property
    def peer(self) -> str:
        return f"passthru:{self._name}:peer"

    @property
    def local_address(self) -> str:
        return f"passthru:{self._name}:local"


def passthru_endpoint_pair() -> Tuple[Endpoint, Endpoint]:
    """Two endpoints joined by in-memory queues (the in-process transport);
    a close is the other end's EOF."""
    q1: queue.Queue = queue.Queue()
    q2: queue.Queue = queue.Queue()
    return _PassthruHalf(q1, q2, "a"), _PassthruHalf(q2, q1, "b")


# ---------------------------------------------------------------------------
# The factory + connectors.
# ---------------------------------------------------------------------------

def create_endpoint(sock: socket.socket, *, is_server: bool,
                    pool_key: Optional[str] = None,
                    platform: Optional[Platform] = None) -> Endpoint:
    """Wrap a just-connected socket in the platform-selected byte pipe. A
    ring-platform server reads the first 4 bytes: ring peers open with the
    TRB1 bootstrap magic, anything else gets a TCP endpoint carrying them."""
    platform = platform or get_config().platform
    if platform is Platform.TCP:
        return TcpEndpoint(sock)
    preread = b""
    if is_server:
        from tpurpc_torch.core.pair import _BOOTSTRAP_MAGIC, peek_protocol

        preread = peek_protocol(sock)
        if preread != _BOOTSTRAP_MAGIC:
            return TcpEndpoint(sock, preread=preread)
    key = pool_key or _fmt_addr(sock, peer=True)
    if platform is Platform.TPU:
        from tpurpc_torch.tpu.endpoint import TpuRingEndpoint

        return TpuRingEndpoint(sock, pool_key=key, preread=preread)
    return RingEndpoint(sock, discipline=platform.discipline, pool_key=key,
                        preread=preread)


def tls_client_handshake(sock: socket.socket, ssl_context,
                         server_hostname: str) -> socket.socket:
    """Client-side TLS wrap with one failure mode (shared by the endpoint
    factory and the h2 client): the socket is closed and
    :class:`EndpointError` raised; nothing is ever sent in plaintext."""
    try:
        return ssl_context.wrap_socket(sock, server_hostname=server_hostname)
    except (OSError, ValueError) as exc:
        sock.close()
        raise EndpointError(f"TLS handshake failed: {exc}") from exc


def connect_endpoint(host: str, port: int,
                     timeout: Optional[float] = 30,
                     ssl_context=None,
                     server_hostname: Optional[str] = None) -> Endpoint:
    """Client side: TCP-connect, TLS-wrap with ``ssl_context`` (verifying
    ``server_hostname``, default ``host``), then let the factory pick the
    pipe. The handshake comes BEFORE the platform dispatch, so a ring's
    address exchange and notify channel ride the encrypted stream."""
    sock = socket.create_connection((host, port), timeout=timeout)
    if ssl_context is not None:
        sock = tls_client_handshake(sock, ssl_context,
                                    server_hostname or host)
    sock.settimeout(None)
    return create_endpoint(sock, is_server=False, pool_key=f"{host}:{port}")


#: a server-side TLS handshake that takes longer is abandoned
TLS_HANDSHAKE_TIMEOUT_S = 20.0


#: connections closed at the accept gate before any handshake work
_ACCEPT_SHED = _metrics.counter("accept_shed")


class EndpointListener:
    """Accept loop feeding the factory. The listener accepts only once
    ``ready`` is set (grpcio semantics: the port is bound at add_port,
    served at start). ``reuseport`` lets listeners of several processes
    share one port (``SO_REUSEPORT``). With ``ssl_context`` every
    connection handshakes (within :data:`TLS_HANDSHAKE_TIMEOUT_S`) before
    the factory sees it; one that fails is closed there.

    A reconnect storm lands a whole listen backlog at once. Two defenses,
    both before any handshake work is spent on a connection:

    * burst accepts: each wakeup takes up to ``accept_burst`` queued
      connections (one blocking accept, then non-blocking ones), so the
      backlog clears in a few sweeps while ``close()`` stays responsive;
    * admission pushback: ``admission()`` (None admits, an int is a
      pushback in ms; the RPC server wires its admission gate's
      connection-level face here) is consulted per accepted socket, and
      the bootstrap handshakes in flight are bounded. A shed connection is
      closed at once and counted in :attr:`shed`.

    Each admitted socket bootstraps on its own thread, so one silent
    client cannot stall the others."""

    def __init__(self, host: str, port: int,
                 on_endpoint: Callable[[Endpoint], None],
                 ready: "Optional[threading.Event]" = None,
                 reuseport: bool = False,
                 ssl_context=None,
                 admission: "Optional[Callable[[], Optional[int]]]" = None):
        self._ssl_context = ssl_context
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuseport:
            # listener sharding: N worker processes listen on the SAME port
            # and the kernel spreads accepted connections across them. Every
            # sharing socket sets the flag before bind; a dead worker's
            # socket closes with it, so the kernel stops routing there.
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._on_endpoint = on_endpoint
        self._admission = admission
        self._burst = max(1, get_config().accept_burst)
        #: bootstrap handshakes in flight, bounded so that a storm cannot
        #: start unbounded handshake threads; guarded by _handshakes_mu
        self._handshakes = 0
        self._max_handshakes = max(self._burst * 4, 64)
        self._handshakes_mu = threading.Lock()
        #: connections closed at the accept gate, and the largest burst one
        #: wakeup took
        self.shed = 0
        self.max_burst = 0
        self._ftag = _flight.tag_for(f"accept:{self.port}")
        self._ready = ready
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"tpurpc-accept-{self.port}")
        self._thread.start()

    def _loop(self) -> None:
        # periodic timeout so close() from another thread is observed
        self._sock.settimeout(0.2)
        if self._ready is not None:
            while not self._stopped and not self._ready.wait(timeout=0.2):
                pass
        while not self._stopped:
            try:
                sock, addr = self._sock.accept()
                sock.settimeout(None)
            except socket.timeout:
                continue
            except OSError:
                if self._stopped:
                    return
                time.sleep(0.05)  # transient (EMFILE...): keep accepting
                continue
            # the rest of the backlog is in the kernel's queue right now:
            # take up to accept_burst of it in this sweep
            batch = [(sock, addr)]
            self._sock.settimeout(0)
            try:
                while len(batch) < self._burst and not self._stopped:
                    try:
                        s2, a2 = self._sock.accept()
                    except (BlockingIOError, socket.timeout):
                        break
                    except OSError:
                        break
                    s2.settimeout(None)
                    batch.append((s2, a2))
            finally:
                self._sock.settimeout(0.2)
            self.max_burst = max(self.max_burst, len(batch))
            for s, a in batch:
                self._dispatch(s, a)

    def _dispatch(self, sock: socket.socket, addr) -> None:
        """The admission gate, then a bootstrap off the accept thread.
        Shedding happens here, before TLS, the protocol sniff or any
        endpoint state."""
        pushback = None
        if self._admission is not None:
            try:
                pushback = self._admission()
            except Exception:
                pushback = None  # a broken probe never sheds
        with self._handshakes_mu:
            inflight = self._handshakes
            if pushback is None and inflight >= self._max_handshakes:
                # the handshake plane itself is the bottleneck: shed with a
                # nominal pushback rather than queue threads unboundedly
                pushback = 50
            if pushback is None:
                self._handshakes = inflight + 1
            else:
                self.shed += 1
        if pushback is not None:
            pushback = int(pushback)
            _ACCEPT_SHED.inc()
            _flight.emit(_flight.ACCEPT_SHED, self._ftag, inflight,
                         pushback)
            try:
                sock.close()
            except OSError:
                pass
            return
        threading.Thread(target=self._bootstrap, args=(sock, addr),
                         daemon=True,
                         name=f"tpurpc-bootstrap-{self.port}").start()

    def _bootstrap(self, sock: socket.socket, addr) -> None:
        try:
            self._bootstrap_inner(sock, addr)
        finally:
            with self._handshakes_mu:
                self._handshakes = max(0, self._handshakes - 1)

    def _bootstrap_inner(self, sock: socket.socket, addr) -> None:
        try:
            if self._ssl_context is not None:
                # the handshake comes before the platform sniff, which then
                # reads decrypted bytes; a plaintext client or a bad
                # certificate fails here and reaches no protocol layer
                sock.settimeout(TLS_HANDSHAKE_TIMEOUT_S)
                sock = self._ssl_context.wrap_socket(sock, server_side=True)
                sock.settimeout(None)
            # servers key pooled pairs by peer host
            ep = create_endpoint(sock, is_server=True,
                                 pool_key=f"peer:{addr[0]}")
        except Exception:
            sock.close()
            return
        if self._stopped:
            ep.close()
            return
        self._on_endpoint(ep)

    def close(self) -> None:
        self._stopped = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._thread.join(timeout=5)
        try:
            self._sock.close()
        except OSError:
            pass
