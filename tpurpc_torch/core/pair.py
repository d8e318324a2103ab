"""Pair: one connection's data plane — a receive ring the peer writes into,
a status page for credits and the close flag, and a notify socket.

A trimmed copy of ``tpurpc/core/pair.py`` (pure Python; no idle parking, no
native spin or waiter-advertisement words — every send notifies):

* the peer one-sided-writes messages into our receive ring and its consumed
  head (credit) and ``peer_exit`` flag into our status page;
* a :class:`MemoryDomain` implements the one-sided write: in-process buffers
  (``local``), POSIX shared memory (``shm``, the default) or records over a
  socket to the peer process (``tcp_window``, ``core/tcpw.py``, registered
  on first use);
* bootstrap swaps :class:`Address` blobs over an already-connected socket,
  which then stays as the notify/liveness channel. The socket may be an
  ``ssl.SSLSocket``: the exchange then reads decrypted bytes, every SSL call
  on it is serialized under ``_notify_lock`` (OpenSSL forbids concurrent use
  of one ``SSL*``), and the non-consuming probe uses ``pending()`` and a
  readiness check, since ``MSG_PEEK`` is refused on an ``SSLSocket``. TLS
  guards the bootstrap and the notify channel; ring payloads stay in the
  memory domain, as the reference's stay in registered memory;
* the lifecycle is ``UNINITIALIZED → INITIALIZED → CONNECTED →
  HALF_CLOSED/DISCONNECTED/ERROR``, and ``init()`` revives pooled pairs.
"""

from __future__ import annotations

import contextlib
import enum
import json
import os
import select
import socket
import ssl
import struct
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence

from tpurpc_torch.core import transport as _transport
from tpurpc_torch.core.ring import RingCorruption, RingReader, RingWriter
from tpurpc_torch.utils.config import get_config

_U64 = struct.Struct("<Q")

#: status page: the peer-written words (credit head, peer_exit)
STATUS_BYTES = 128
_STATUS_HEAD_OFF = 0
_STATUS_EXIT_OFF = 8


class PairState(enum.Enum):
    UNINITIALIZED = "uninitialized"
    INITIALIZED = "initialized"
    CONNECTED = "connected"
    HALF_CLOSED = "half_closed"      # peer wrote peer_exit and stopped sending
    DISCONNECTED = "disconnected"
    ERROR = "error"


# ---------------------------------------------------------------------------
# Memory domains: who implements the one-sided write.
# ---------------------------------------------------------------------------

def retry_buffer_op(fn: Callable[[], None], timeout_s: float = 2.0) -> None:
    """Run a release/unmap that may transiently hit BufferError while another
    thread still holds an exported view."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            fn()
            return
        except BufferError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.001)


class Region:
    """A chunk of memory owned by this side that the peer writes into."""

    __slots__ = ("handle", "buf", "_close", "on_write")

    def __init__(self, handle: str, buf, close: Callable[[], None] = lambda: None):
        self.handle = handle
        self.buf = memoryview(buf)
        self._close = close
        #: post-apply hook of an asynchronous domain (tcp_window): called
        #: by its applier after landing peer bytes here. The peer's notify
        #: token rides another socket and can arrive before the bytes, so
        #: this kick is what closes the lost-wakeup window. Synchronous
        #: domains never call it.
        self.on_write: Optional[Callable[[], None]] = None

    def close(self) -> None:
        retry_buffer_op(self.buf.release)
        retry_buffer_op(self._close)


class Window:
    """A write handle onto the *peer's* region; ``view`` is its mapped
    memory, or None for a domain that is not host-addressable from this
    side (``tcp_window``)."""

    __slots__ = ("write", "view", "_close")

    def __init__(self, write: Callable[[int, bytes], None],
                 close: Callable[[], None] = lambda: None,
                 view: "Optional[memoryview]" = None):
        self.write = write  # write(offset, data) — one-sided
        self.view = view
        self._close = close

    def close(self) -> None:
        self._close()


class MemoryDomain:
    """Allocates local regions and opens windows onto peer regions."""

    kind = "abstract"

    def alloc(self, nbytes: int) -> Region:
        raise NotImplementedError

    def open_window(self, handle: str, nbytes: int) -> Window:
        raise NotImplementedError


class LocalDomain(MemoryDomain):
    """In-process domain: regions live in a process-wide registry."""

    kind = "local"
    _registry: Dict[str, bytearray] = {}
    _lock = threading.Lock()

    def alloc(self, nbytes: int) -> Region:
        handle = f"local:{uuid.uuid4().hex}"
        buf = bytearray(nbytes)
        with self._lock:
            self._registry[handle] = buf

        def _close():
            with self._lock:
                self._registry.pop(handle, None)

        return Region(handle, buf, _close)

    def open_window(self, handle: str, nbytes: int) -> Window:
        with self._lock:
            buf = self._registry[handle]
        mv = memoryview(buf)

        def write(off: int, data) -> None:
            mv[off:off + len(data)] = data

        return Window(write, mv.release, view=mv)


class ShmDomain(MemoryDomain):
    """Cross-process domain over POSIX shared memory."""

    kind = "shm"

    # The allocator unlinks explicitly (Region.close); Python's
    # resource_tracker would otherwise unlink from every process that ever
    # mapped the segment, so registration is suppressed. Re-entrant: a
    # SharedMemory constructed inside the block can trigger a garbage
    # collection whose weakref callback closes a recycled window, which
    # takes the block again on the same thread (the reference's plain lock
    # deadlocks there).
    _track_mu = threading.RLock()

    @staticmethod
    @contextlib.contextmanager
    def _untracked():
        from multiprocessing import resource_tracker

        with ShmDomain._track_mu:
            orig_reg = resource_tracker.register
            orig_unreg = resource_tracker.unregister

            def _skip_reg(name, rtype):
                if rtype != "shared_memory":
                    orig_reg(name, rtype)

            def _skip_unreg(name, rtype):
                if rtype != "shared_memory":
                    orig_unreg(name, rtype)

            resource_tracker.register = _skip_reg
            resource_tracker.unregister = _skip_unreg
            try:
                yield
            finally:
                resource_tracker.register = orig_reg
                resource_tracker.unregister = orig_unreg

    def alloc(self, nbytes: int) -> Region:
        from multiprocessing import shared_memory

        with self._untracked():
            shm = shared_memory.SharedMemory(create=True, size=nbytes)

        def _close():
            # the name goes first: a mapping still pinned by an alias
            # (shm.close raises BufferError) must not leave it in /dev/shm
            with self._untracked():
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass
            shm.close()

        return Region(f"shm:{shm.name}", shm.buf, _close)

    def open_window(self, handle: str, nbytes: int) -> Window:
        from multiprocessing import shared_memory

        assert handle.startswith("shm:")
        with self._untracked():
            shm = shared_memory.SharedMemory(name=handle[4:])
        mv = shm.buf

        def write(off: int, data) -> None:
            mv[off:off + len(data)] = data

        def _close():
            mv.release()
            shm.close()

        return Window(write, _close, view=mv)


_DOMAINS: Dict[str, Callable[[], MemoryDomain]] = {
    "local": LocalDomain,
    "shm": ShmDomain,
}

#: domains whose module registers itself on first use: ``tcp_window``
#: starts a record server, so importing it is deferred until asked for
_LAZY_DOMAINS = {"tcp_window": "tpurpc_torch.core.tcpw"}


def register_domain(kind: str, factory: Callable[[], MemoryDomain]) -> None:
    """Add a domain to the ``TPURPC_RING_DOMAIN`` dispatch."""
    _DOMAINS[kind] = factory


def make_domain(kind: str) -> MemoryDomain:
    """Instantiate a domain by name (the ``TPURPC_RING_DOMAIN`` dispatch);
    a lazy domain's module is imported, and registers it, on first use."""
    if kind not in _DOMAINS and kind in _LAZY_DOMAINS:
        import importlib

        importlib.import_module(_LAZY_DOMAINS[kind])
    factory = _DOMAINS.get(kind)
    if factory is None:
        raise ValueError(f"unknown ring domain {kind!r} "
                         f"(have {sorted(_DOMAINS)})")
    # called outside the lookup: a KeyError raised inside a factory must
    # surface as itself, not as "unknown ring domain"
    return factory()


# ---------------------------------------------------------------------------
# Address: what gets exchanged at bootstrap.
# ---------------------------------------------------------------------------

class Address:
    """Serializable bootstrap blob: tag, domain, ring size and the handles of
    the receive ring and status page. ``caps`` are capability strings: this
    package advertises ``rdv`` (rendezvous on, ``core/rendezvous.py``) and
    reads only that of the peer's."""

    def __init__(self, tag: str, domain_kind: str, ring_size: int,
                 ring_handle: str, status_handle: str,
                 caps: "Optional[Sequence[str]]" = None):
        self.tag = tag
        self.domain_kind = domain_kind
        self.ring_size = ring_size
        self.ring_handle = ring_handle
        self.status_handle = status_handle
        self.caps = frozenset(caps or ())

    def to_bytes(self) -> bytes:
        return json.dumps({
            "tag": self.tag,
            "domain": self.domain_kind,
            "ring_size": self.ring_size,
            "ring": self.ring_handle,
            "status": self.status_handle,
            "caps": sorted(self.caps),
        }).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Address":
        d = json.loads(raw.decode())
        return cls(d["tag"], d["domain"], d["ring_size"], d["ring"],
                   d["status"], d.get("caps", ()))


#: Bootstrap frame magic: a peer on another platform (a TCP client hitting a
#: ring server) fails here with a clear error instead of hanging.
_BOOTSTRAP_MAGIC = b"TRB1"
_MAX_BLOB = 1 << 16
BOOTSTRAP_TIMEOUT_S = 20.0


def _send_blob(sock: socket.socket, blob: bytes) -> None:
    sock.sendall(_BOOTSTRAP_MAGIC + struct.pack("<I", len(blob)) + blob)


def _recv_blob(sock: socket.socket, preread: bytes = b"") -> bytes:
    magic = preread + _recv_exact(sock, 4 - len(preread))
    if magic != _BOOTSTRAP_MAGIC:
        raise ConnectionError(
            f"bad bootstrap magic {magic!r}: peer is not speaking the ring "
            f"bootstrap protocol (GRPC_PLATFORM_TYPE mismatch between peers?)")
    need = struct.unpack("<I", _recv_exact(sock, 4))[0]
    if need > _MAX_BLOB:
        raise ConnectionError(f"bootstrap blob implausibly large ({need} bytes)")
    return _recv_exact(sock, need)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("peer closed during address exchange")
        out += chunk
    return out


def peek_protocol(sock: socket.socket, timeout: float = BOOTSTRAP_TIMEOUT_S
                  ) -> bytes:
    """Server-side protocol dispatch: consume and return the first 4 bytes
    (ring clients open with the TRB1 bootstrap magic)."""
    old = sock.gettimeout()
    sock.settimeout(timeout)
    try:
        return _recv_exact(sock, 4)
    finally:
        try:
            sock.settimeout(old)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# The Pair.
# ---------------------------------------------------------------------------

#: notify tokens carried on the notify socket
NOTIFY_DATA = b"d"
NOTIFY_CREDIT = b"c"
NOTIFY_EXIT = b"x"


class ContentAssertion:
    """Single-entrant tripwire on send/recv: two threads inside one side at
    once is a caller bug, raised loudly rather than corrupting a ring."""

    def __init__(self, name: str):
        self._name = name
        self._flag = False
        self._lock = threading.Lock()

    def __enter__(self):
        with self._lock:
            if self._flag:
                raise AssertionError(f"concurrent entry into {self._name}")
            self._flag = True

    def __exit__(self, *exc):
        with self._lock:
            self._flag = False
        return False


class Pair:
    """One connection's data plane. One sender thread + one receiver thread
    at a time (enforced by :class:`ContentAssertion`); any thread may poll."""

    def __init__(self, domain: Optional[MemoryDomain] = None,
                 ring_size: Optional[int] = None, tag: Optional[str] = None):
        cfg = get_config()
        self.domain = domain or LocalDomain()
        self.ring_size = ring_size or cfg.ring_buffer_size
        self.tag = tag or uuid.uuid4().hex[:12]
        self.state = PairState.UNINITIALIZED
        self.error: Optional[str] = None

        self.recv_region: Optional[Region] = None
        self.status_region: Optional[Region] = None
        self.reader: Optional[RingReader] = None
        self.writer: Optional[RingWriter] = None
        self._peer_ring: Optional[Window] = None
        self._peer_status: Optional[Window] = None
        #: the peer's capability strings from its bootstrap Address
        self.peer_caps: frozenset = frozenset()

        #: peer-driven event channel (notify tokens + liveness)
        self.notify_sock: Optional[socket.socket] = None
        #: local wakeup pipes, one per waiter role: a role's pipe is only
        #: consumed by its own waiter, so a kick is never stolen
        self._wake_r: Dict[str, int] = {"read": -1, "write": -1}
        self._wake_w: Dict[str, int] = {"read": -1, "write": -1}
        self._selectors: Dict[str, object] = {}

        self._send_guard = ContentAssertion("Pair.send")
        self._recv_guard = ContentAssertion("Pair.recv")
        self._credit_lock = threading.Lock()
        self._published_head_mirror = 0
        self.want_write = False  # a sender is stalled waiting for credits
        #: adaptive-hybrid activity score (see core/poller.py)
        self.activity_ewma = 1.0
        self._notify_lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def init(self) -> None:
        """Allocate fresh rings and reset state. Regions are always NEW
        allocations: a previous peer still holding a window onto the old
        region must land stale writes there, not in this connection's."""
        self._release_channels()
        self._release_regions()
        self.recv_region = self.domain.alloc(self.ring_size)
        self.status_region = self.domain.alloc(STATUS_BYTES)
        # an asynchronous domain's applier wakes the waiters: data landing
        # in the ring wakes readers, credits or exit in the status page wake
        # stalled writers
        self.recv_region.on_write = self.kick
        self.status_region.on_write = self.kick
        self.reader = RingReader(self.recv_region.buf, self.ring_size)
        self.writer = None  # created at connect, once the peer ring is known
        self._published_head_mirror = 0
        self.error = None
        self.want_write = False
        self.activity_ewma = 1.0
        for role in ("read", "write"):
            r, w = os.pipe()
            os.set_blocking(r, False)
            os.set_blocking(w, False)
            self._wake_r[role] = r
            self._wake_w[role] = w
        self.state = PairState.INITIALIZED

    def local_address(self) -> Address:
        assert self.state in (PairState.INITIALIZED, PairState.CONNECTED)
        # rendezvous arms at connect time on a ring plane: no hello round
        # trip for the first bulk payload to race. The switch is read here
        # because rendezvous imports this module.
        caps = []
        if os.environ.get("TPURPC_RENDEZVOUS", "1").lower() not in (
                "0", "off", "false"):
            caps.append("rdv")
        return Address(self.tag, self.domain.kind, self.ring_size,
                       self.recv_region.handle, self.status_region.handle,
                       caps=caps)

    def connect_over_socket(self, sock: socket.socket,
                            preread: bytes = b"") -> None:
        """Bootstrap over an already-connected socket: both sides swap
        Address blobs, then open one-sided windows. The socket stays as the
        notify/liveness channel. Bounded by ``BOOTSTRAP_TIMEOUT_S``."""
        if self.state is not PairState.INITIALIZED:
            raise RuntimeError(f"connect in state {self.state}")
        sock.settimeout(BOOTSTRAP_TIMEOUT_S)
        try:
            _send_blob(sock, self.local_address().to_bytes())
            peer = Address.from_bytes(_recv_blob(sock, preread))
        except socket.timeout as exc:
            raise ConnectionError(
                f"pair bootstrap timed out after {BOOTSTRAP_TIMEOUT_S}s "
                "(peer not speaking the ring bootstrap protocol?)") from exc
        finally:
            try:
                sock.settimeout(None)
            except OSError:
                pass
        self._attach_peer(peer)
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not a TCP socket
        self.notify_sock = sock

    def _attach_peer(self, peer: Address) -> None:
        if peer.domain_kind != self.domain.kind:
            raise ValueError(f"domain mismatch: {peer.domain_kind} vs {self.domain.kind}")
        self._peer_ring = self.domain.open_window(peer.ring_handle, peer.ring_size)
        self._peer_status = self.domain.open_window(peer.status_handle, STATUS_BYTES)
        self.peer_caps = peer.caps
        self.writer = RingWriter(peer.ring_size, self._peer_ring.write)
        self.state = PairState.CONNECTED

    # -- notify channel -------------------------------------------------------

    def _notify(self, token: bytes) -> None:
        _transport.dispatch("frame", self, self._notify_raw, token)

    def _notify_raw(self, token: bytes) -> None:
        sock = self.notify_sock
        if sock is None:
            return
        try:
            # locked on every socket: on a TLS one, OpenSSL forbids
            # concurrent use of one SSL* (a one-byte record either goes
            # whole or not at all, so a dropped token stays best-effort)
            with self._notify_lock:
                sock.send(token)
        except (ssl.SSLWantWriteError, ssl.SSLWantReadError):
            pass  # TLS record stalled: as a saturated channel
        except (BlockingIOError, InterruptedError):
            pass  # channel saturated — a token is already pending
        except OSError:
            # usually the peer already left (EPIPE after its graceful
            # close); the authoritative death signals are peer_exit and the
            # receive-side probe
            pass

    def drain_notifications(self) -> bytes:
        """Non-blocking drain of the notify channel; returns the tokens seen.
        An empty read (peer closed) folds the status words, then flips the
        pair to ERROR unless the peer closed gracefully."""
        sock = self.notify_sock
        if sock is None:
            return b""
        is_tls = hasattr(sock, "pending")
        out = b""
        while True:
            try:
                if is_tls:
                    # serialized with the token sends; the recv is
                    # non-blocking, so the hold is microseconds
                    with self._notify_lock:
                        chunk = sock.recv(65536)
                else:
                    chunk = sock.recv(65536)
            except (BlockingIOError, InterruptedError,
                    ssl.SSLWantReadError, ssl.SSLWantWriteError):
                break  # nothing decryptable yet: EAGAIN on a plain socket
            except OSError:
                # a stale caller may hold a socket from a previous life of
                # this pooled pair: its EBADF must not poison the new one
                if sock is self.notify_sock and sock.fileno() != -1:
                    self._mark_error("notify channel read failed")
                break
            if chunk == b"":
                if sock is self.notify_sock:
                    self._on_notify_closed()
                break
            out += chunk
            if len(chunk) < 65536:
                break
        return out

    def _on_notify_closed(self) -> None:
        """Peer's end of the notify socket closed. A graceful close writes
        peer_exit BEFORE closing, so fold the status words first; only an
        unexplained closure is an ERROR."""
        if self.state is PairState.CONNECTED:
            self.process_credits()  # may observe peer_exit -> HALF_CLOSED
        if self.state is PairState.CONNECTED:
            self._mark_error("peer vanished (notify socket closed)")

    def peek_events(self) -> bool:
        """Non-consuming probe of the notify channel: True if tokens are
        pending or the peer died (the poller must not steal tokens)."""
        sock = self.notify_sock
        if sock is None:
            return False
        if hasattr(sock, "pending"):
            # an SSLSocket refuses MSG_PEEK (ValueError) and a record
            # stream has nothing to peek at: decrypted bytes pending, or
            # ciphertext readable on the fd, is hint enough (a spurious
            # True makes the owner drain and find nothing)
            with self._notify_lock:
                if sock.pending():
                    return True
            try:
                # poll, not select: select fails for fds >= FD_SETSIZE
                p = select.poll()
                p.register(sock.fileno(), select.POLLIN)
                return bool(p.poll(0))
            except (OSError, ValueError):
                return True  # racing close: the owner's drain resolves it
        try:
            chunk = sock.recv(1, socket.MSG_PEEK)
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            if sock is self.notify_sock and sock.fileno() != -1:
                self._mark_error("notify channel read failed")
                return True
            return False
        if chunk == b"" and sock is self.notify_sock:
            self._on_notify_closed()
        return True

    # -- wakeup fds -----------------------------------------------------------

    def kick(self, exclude: Optional[str] = None) -> None:
        """Wake every blocked waiter (one byte into each role's pipe; a full
        pipe already holds a pending byte). ``exclude`` skips one role."""
        for role in ("read", "write"):
            if role == exclude:
                continue
            fd = self._wake_w[role]
            if fd >= 0:
                try:
                    os.write(fd, b"\x01")
                except OSError:
                    pass

    def consume_wakeup(self, role: str = "read") -> None:
        fd = self._wake_r[role]
        if fd < 0:
            return
        try:
            while os.read(fd, 64):
                pass
        except OSError:
            pass

    def waiter_selector(self, role: str):
        """The role's persistent selector over (notify socket, role pipe)."""
        import selectors

        sel = self._selectors.get(role)
        if sel is None:
            sel = selectors.DefaultSelector()
            try:
                if self.notify_sock is not None:
                    sel.register(self.notify_sock, selectors.EVENT_READ)
                fd = self._wake_r[role]
                if fd >= 0:
                    sel.register(fd, selectors.EVENT_READ)
            except (OSError, ValueError, KeyError):
                pass  # racing close; the waiter's predicate re-check handles it
            self._selectors[role] = sel
        return sel

    # -- status / credits -----------------------------------------------------

    def process_credits(self) -> None:
        """Fold the peer-written status page into local writer state."""
        w = self.writer
        region = self.status_region
        if w is None or region is None:
            return
        with self._credit_lock:
            try:
                head = _U64.unpack_from(region.buf, _STATUS_HEAD_OFF)[0]
                peer_exit = _U64.unpack_from(region.buf, _STATUS_EXIT_OFF)[0]
            except ValueError:
                return  # region released under us (teardown race)
            if head > w.remote_head:
                w.update_remote_head(head)
        if peer_exit and self.state is PairState.CONNECTED:
            self.state = PairState.HALF_CLOSED

    def _publish_credits_if_due(self, force: bool = False) -> None:
        """One-sided-write our head into the peer's status page after
        consuming a quarter ring, then notify the peer's writer."""
        reader = self.reader
        win = self._peer_status
        if win is None or reader is None:
            return
        if force or reader.should_publish_head():
            head = reader.take_publish()
            if head != self._published_head_mirror:
                self._published_head_mirror = head
                try:
                    win.write(_STATUS_HEAD_OFF, _U64.pack(head))
                except ValueError:
                    return  # window closed under us
                self._notify(NOTIFY_CREDIT)

    # -- data plane -----------------------------------------------------------

    def send(self, slices: Sequence, byte_idx: int = 0) -> int:
        """Send as much of ``slices[byte_idx:]`` as flow control allows;
        returns bytes accepted (partial sends are normal — the caller waits
        for credits). Payloads are chunked to ``send_chunk_size`` per ring
        message."""
        if self.state is not PairState.CONNECTED:
            raise BrokenPipeError(f"pair {self.tag} not sendable: {self.state}"
                                  + (f" ({self.error})" if self.error else ""))
        cfg = get_config()
        with self._send_guard:
            views: List[memoryview] = []
            skip = byte_idx
            for s in slices:
                v = memoryview(s).cast("B")
                if skip >= len(v):
                    skip -= len(v)
                    continue
                views.append(v[skip:] if skip else v)
                skip = 0
            self.process_credits()
            total = 0
            while views:
                # batch every chunk the current credits admit into one
                # write_many (one bulk placement + one header per chunk)
                budget = self.writer.writable_payload()
                if budget == 0:
                    self.want_write = True
                    break
                chunks: List[List[memoryview]] = []
                n = 0
                while views and n < budget:
                    chunk: List[memoryview] = []
                    c = 0
                    room = min(cfg.send_chunk_size, budget - n)
                    while views and c < room:
                        v = views[0]
                        take = min(len(v), room - c)
                        chunk.append(v[:take])
                        if take == len(v):
                            views.pop(0)
                        else:
                            views[0] = v[take:]
                        c += take
                    chunks.append(chunk)
                    n += c
                    # every chunk's framing eats writable payload
                    budget = max(0, budget - (c + 24))
                wrote_msgs, wrote_bytes = self.writer.write_many(chunks)
                total += wrote_bytes
                if wrote_msgs < len(chunks):
                    # credits moved under us: re-queue the unwritten chunks
                    views[0:0] = [seg for ch in chunks[wrote_msgs:]
                                  for seg in ch]
                    self.want_write = True
                    break
            if not views:
                self.want_write = False
            if total:
                self._notify(NOTIFY_DATA)  # one event per send call
            return total

    def recv_into(self, dst) -> int:
        """Drain the receive ring into ``dst``; publishes credits as a side
        effect."""
        with self._recv_guard:
            reader = self.reader
            if reader is None:
                raise ConnectionError("pair is closed")
            try:
                n, _ = reader.drain_into(dst)
            except (RingCorruption, ValueError) as exc:
                if "released" in str(exc):
                    raise ConnectionError("pair is closed") from None
                raise
            self._publish_credits_if_due()
            return n

    def has_message(self) -> bool:
        reader = self.reader
        try:
            return reader is not None and reader.has_message()
        except ValueError:
            return False  # ring released under a racing poller

    def has_pending_writes(self) -> bool:
        """True when a sender stalled for credits and space has appeared."""
        if not self.want_write or self.writer is None:
            return False
        self.process_credits()
        return self.writer.writable_payload() > 0

    def spin(self, role: str, timeout_us: int) -> bool:
        """One busy-poll slice. Pure Python has no GIL-free spin, so this
        yields the core once; the caller re-checks its predicate."""
        time.sleep(0)
        return True

    # -- close / liveness ------------------------------------------------------

    def get_status(self) -> PairState:
        if self.state is PairState.CONNECTED:
            self.process_credits()
        return self.state

    def disconnect(self) -> None:
        """Graceful close: publish credits, one-sided-write ``peer_exit=1``
        into the peer's status page, notify, stop sending."""
        if self.state in (PairState.CONNECTED, PairState.HALF_CLOSED):
            self._publish_credits_if_due(force=True)
            try:
                self._peer_status.write(_STATUS_EXIT_OFF, _U64.pack(1))
                self._notify(NOTIFY_EXIT)
            except Exception:
                pass
        self.state = PairState.DISCONNECTED
        self.want_write = False

    def _mark_error(self, why: str) -> None:
        if self.state is not PairState.DISCONNECTED:
            self.state = PairState.ERROR
        if self.error is None:
            self.error = why
        self.kick()  # the state change is the waiters' wake condition

    def _release_channels(self) -> None:
        """Per-connection state: peer windows, notify socket, wakeup pipes,
        reader view. Kick FIRST so a waiter blocked on these fds wakes."""
        # detach the asynchronous applier's hook before the wake fds
        # close: a record landing mid-teardown must not kick a closed (and
        # possibly reused) fd number
        for region in (self.recv_region, self.status_region):
            if region is not None:
                region.on_write = None
        self.kick()
        sels, self._selectors = self._selectors, {}
        for sel in sels.values():
            try:
                sel.close()
            except OSError:
                pass
        if self.reader is not None:
            retry_buffer_op(self.reader.release)
            self.reader = None
        self.writer = None
        for attr in ("_peer_ring", "_peer_status"):
            w = getattr(self, attr)
            if w is not None:
                setattr(self, attr, None)
                retry_buffer_op(w.close)
        sock = self.notify_sock
        if sock is not None:
            # a TLS socket closes under the notify lock, so that no SSL
            # call is still running on its fd (OpenSSL would go on reading
            # the fd number, given to the next connection, and corrupt it)
            with (self._notify_lock if hasattr(sock, "pending")
                  else contextlib.nullcontext()):
                try:
                    sock.close()
                except OSError:
                    pass
                self.notify_sock = None
        for pipes in (self._wake_r, self._wake_w):
            for role, fd in pipes.items():
                if fd >= 0:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
                    pipes[role] = -1

    def _release_regions(self) -> None:
        for attr in ("recv_region", "status_region"):
            r = getattr(self, attr)
            if r is not None:
                setattr(self, attr, None)
                r.close()

    def destroy(self) -> None:
        """Release everything per-connection, ring regions included; a later
        ``init()`` revives the object."""
        if self.state in (PairState.CONNECTED, PairState.HALF_CLOSED):
            self.disconnect()
        self._release_channels()
        self._release_regions()
        self.state = PairState.UNINITIALIZED
