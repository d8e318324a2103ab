"""Endpoint: the swappable byte-pipe seam, and the factory that swaps it.

A trimmed copy of ``tpurpc/core/endpoint.py`` (no TLS, no h2 sniff, no
accept-storm admission): one blocking endpoint interface with the byte-pipe
chosen by ``GRPC_PLATFORM_TYPE`` at connection time — ``TcpEndpoint`` for
TCP, ``RingEndpoint`` (a pooled :class:`Pair`) for the ring platforms, and
``TpuRingEndpoint`` (a ring endpoint with a device receive ring) for
``TPU``. ``read_into`` fills ≥1 byte, returns 0 once at clean EOF, or raises
:class:`EndpointError`; ``write`` accepts the whole buffer or raises.
"""

from __future__ import annotations

import select
import socket
import threading
import time
from typing import Callable, Optional

from tpurpc_torch.core.pair import Pair, PairState
from tpurpc_torch.core.poller import PairPool, Poller, wait_readable, wait_writable
from tpurpc_torch.utils.config import Platform, get_config


class EndpointError(ConnectionError):
    """Transport-level failure; the RPC layer maps it to UNAVAILABLE."""


class ReadTimeout(TimeoutError):
    pass


class Endpoint:
    """Blocking byte-pipe contract."""

    def read_into(self, dst, timeout: Optional[float] = None) -> int:
        """Read ≥1 byte directly into ``dst``; 0 exactly once at clean EOF."""
        raise NotImplementedError

    def write(self, data) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def peer(self) -> str:
        raise NotImplementedError


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
        # The socket stays blocking; read deadlines are a poll() ahead of
        # the recv (settimeout is per-socket state a writer would clobber).
        sock.setblocking(True)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # unix sockets
        self._peer = _fmt_addr(sock, peer=True)
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
            self._await_readable(timeout)
            return self._sock.recv_into(dst)
        except OSError as exc:
            raise EndpointError(f"tcp read failed: {exc}") from exc

    def write(self, data) -> None:
        if self._closed:
            raise EndpointError("write on closed endpoint")
        try:
            if isinstance(data, (list, tuple)):
                # sendmsg may place partially and takes ≤1024 iovecs per
                # call: loop until every byte is on the wire
                views = [memoryview(s).cast("B") for s in data if len(s)]
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
                self._sock.sendall(data)
        except OSError as exc:
            raise EndpointError(f"tcp write failed: {exc}") from exc

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()

    @property
    def peer(self) -> str:
        return self._peer


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


def connect_endpoint(host: str, port: int,
                     timeout: Optional[float] = 30) -> Endpoint:
    """Client side: TCP-connect, then let the factory pick the pipe."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    return create_endpoint(sock, is_server=False, pool_key=f"{host}:{port}")


class EndpointListener:
    """Accept loop feeding the factory. Each accepted socket bootstraps on
    its own thread, so one silent client cannot stall other accepts; the
    listener accepts only once ``ready`` is set (grpcio semantics: the port
    is bound at add_port, served at start). ``reuseport`` lets listeners of
    several processes share one port (``SO_REUSEPORT``)."""

    def __init__(self, host: str, port: int,
                 on_endpoint: Callable[[Endpoint], None],
                 ready: "Optional[threading.Event]" = None,
                 reuseport: bool = False):
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
            threading.Thread(target=self._bootstrap, args=(sock, addr),
                             daemon=True,
                             name=f"tpurpc-bootstrap-{self.port}").start()

    def _bootstrap(self, sock: socket.socket, addr) -> None:
        try:
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
