"""Pair: one connection's data plane — a receive ring the peer writes into,
a status page for credits and the close flag, and a notify socket.

A trimmed copy of ``tpurpc/core/pair.py``. With the port's native library
(``core/_native.py``) a pair advertises the ``waitflag`` capability at
bootstrap and publishes waiter-advertisement words in its status page, so
a peer that negotiated it skips the notify byte while no waiter sleeps; it
spins on its watched words in C with the GIL released
(:meth:`Pair.spin`), and a send is one fused C call (credit fold, chunked
gather-encode and the notify decision, ``tpr_send_fast``). Without the
library (``TPURPC_NATIVE=0``), or against a peer that did not advertise
``waitflag``, every send notifies. It carries the
reference's observability hooks under the reference's names: the
``pairs_connected``, ``pairs_write_stalled``, ``pairs_msg_waiting``,
``pairs_parked`` and ``pair_resident_bytes_est`` fleet gauges, the pool's
``ring_pool_*`` gauges and counters, ``pair_park``,
``pair_park_requested`` and ``pair_unpark``, the ``PAIR_*``,
``WRITE_STALL_*``, ``CREDIT_STARVE_*`` and ``PEER_DEATH`` flight edges
under ``pair:<tag>``, the ``send-lease`` span, the ``pair_send`` profile,
the ``ring_write`` and ``ring_drain`` batch histograms, the ``wire`` lens
hop and the ``pair-send``, ``ring-read`` and ``poller-wait`` stages:

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
* idle-pair parking: a pair quiet for ``pair_park_s`` asks its peer to
  close its windows into our rings (PARK/ACK on the notify stream), then
  hands its receive ring and status page to the process-wide
  :class:`RingPool` and keeps a stub; the next byte either way re-arms it
  on freshly leased rings (WAKE/REARM). The tokens and the REARM blob are
  the reference's bytes, so a port pair and a reference pair park against
  each other. Only host regions park: a device ring above the pair
  (``tpu/hbm_ring.py``) stays allocated and keeps its tail;
* the lifecycle is ``UNINITIALIZED → INITIALIZED → CONNECTED →
  HALF_CLOSED/DISCONNECTED/ERROR``, and ``init()`` revives pooled pairs.
"""

from __future__ import annotations

import contextlib
import ctypes
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpurpc_torch.core import _native
from tpurpc_torch.core import transport as _transport
from tpurpc_torch.core.ring import (_BYTES_OUT, _LENS_SR_BYTES, _LENS_SR_COPY,
                                    _LENS_SR_NS, _MSGS_OUT, RingCorruption,
                                    RingReader, RingWriter,
                                    truncate_after_read)
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import lens as _lens
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.obs import tracing as _tracing
from tpurpc_torch.tpu import ledger as ring_ledger
from tpurpc_torch.utils import stats as _stats
from tpurpc_torch.utils.config import get_config
from tpurpc_torch.utils.trace import trace_ring

# fleet gauges, evaluated at scrape time over the weakly referenced live
# pairs: the hot path pays nothing for them
_PAIRS_CONNECTED = _metrics.fleet(
    "pairs_connected", lambda p: 1.0 if p.state.name == "CONNECTED" else 0.0)
_PAIRS_WRITE_STALLED = _metrics.fleet(
    "pairs_write_stalled",
    # CONNECTED only: a pair that died mid-stall is not evidence
    lambda p: 1.0 if (p.want_write and p.state.name == "CONNECTED")
    else 0.0)
#: a CONNECTED pair with a complete message undrained: the watchdog's
#: poller-wake evidence
_PAIRS_MSG_WAITING = _metrics.fleet(
    "pairs_msg_waiting",
    lambda p: 1.0 if (p.state.name == "CONNECTED" and p.has_message())
    else 0.0)
_PAIRS_PARKED = _metrics.fleet(
    "pairs_parked", lambda p: 1.0 if p._parked else 0.0)
_PAIR_RESIDENT = _metrics.fleet(
    "pair_resident_bytes_est", lambda p: float(p.resident_bytes_est()))

# the `wire` lens hop on this plane is Pair.send's one-sided placement
# (credit fold, chunking and ring encode included)
_LENS_WIRE_BYTES, _LENS_WIRE_NS, _LENS_WIRE_COPY = _lens.hop_counters("wire")

_LENS_STAGES = {
    "send": "pair-send",
    "_send_inner": "pair-send",
    "recv_into": "ring-read",
    "recv": "ring-read",
    "spin": "poller-wait",
}
_profiler.register_stages(__file__, _LENS_STAGES)

_U64 = struct.Struct("<Q")

#: status page: the peer-written words (credit head, peer_exit)
STATUS_BYTES = 128
_STATUS_HEAD_OFF = 0
_STATUS_EXIT_OFF = 8
#: "a read-waiter is blocked on the notify fd": senders skip the notify
#: syscall when 0 (the receiver is spinning or mid-drain). A futex-style
#: protocol; its fences are in tpurpc_torch/native/src/ring.cc
#: (tpr_store_u64_seqcst).
#: The words sit on the second cache line, which only this side writes.
_STATUS_RXWAIT_OFF = 64
#: the same, for a credit-stalled writer blocked on the notify fd
_STATUS_WXWAIT_OFF = 72
_WAIT_OFF = {"read": _STATUS_RXWAIT_OFF, "write": _STATUS_WXWAIT_OFF}


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
# The shared ring-region pool.
# ---------------------------------------------------------------------------

_POOL_LEASED_BYTES = _metrics.gauge("ring_pool_leased_bytes")
_POOL_FREE_BYTES = _metrics.gauge("ring_pool_free_bytes")


class RingPool:
    """Process-wide free list of ring and status regions keyed by
    ``(domain kind, byte size)``: mostly idle pairs share a few size
    classes of allocations instead of pinning one ring each.

    A region enters the free list only once no peer window onto it can
    still write: the park handshake's ACK (the peer closed its windows) is
    that proof. Free regions are zeroed before shelving, so that a fresh
    :class:`~tpurpc_torch.core.ring.RingReader` never reads a previous
    tenant's frame headers. Only plain host domains (``local``, ``shm``)
    are pooled; any other region is closed on release. A pair's regions
    are leased here at ``init()`` and at unpark; teardown closes them and
    :meth:`forget` drops their accounting."""

    _instance: "Optional[RingPool]" = None
    _instance_lock = threading.Lock()

    _POOLABLE = frozenset({"local", "shm"})
    _MAX_FREE_BYTES = 256 << 20
    _MAX_FREE_PER_CLASS = 4096

    @classmethod
    def get(cls) -> "RingPool":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = RingPool()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._instance_lock:
            inst, cls._instance = cls._instance, None
        if inst is not None:
            inst.drain()

    def __init__(self):
        self._free: Dict[Tuple[str, int], List[Region]] = {}
        self._free_bytes = 0
        #: id(region) -> nbytes of the regions handed out by lease(): a
        #: release of a region the pool never leased does not count twice
        self._out: Dict[int, int] = {}
        self._lock = threading.Lock()

    def lease(self, domain: MemoryDomain, nbytes: int) -> Region:
        """A writer-free region of exactly ``nbytes``: from the free list
        when its size class has one, else a fresh allocation. A caller
        pairs every lease with a :meth:`release` (or :meth:`forget` before
        it closes the region) on its failure paths."""
        key = (domain.kind, nbytes)
        region = None
        with self._lock:
            bucket = self._free.get(key)
            if bucket:
                region = bucket.pop()
                self._free_bytes -= nbytes
        if region is None:
            region = domain.alloc(nbytes)
            _stats.counter_inc("ring_pool_alloc")
        else:
            _stats.counter_inc("ring_pool_hit")
        with self._lock:
            self._out[id(region)] = nbytes
            _POOL_LEASED_BYTES.set(float(sum(self._out.values())))
            _POOL_FREE_BYTES.set(float(self._free_bytes))
        return region

    def release(self, region: Optional[Region]) -> None:
        """Return a region to the free list, or close it when its domain is
        not pooled or the list is full. The caller asserts that no peer
        window onto it can still write."""
        if region is None:
            return
        region.on_write = None
        try:
            nbytes = len(region.buf)
        except ValueError:
            nbytes = 0  # already released: nothing to pool
        kind = region.handle.split(":", 1)[0]
        with self._lock:
            self._out.pop(id(region), None)
            poolable = (nbytes > 0 and kind in self._POOLABLE
                        and self._free_bytes + nbytes <= self._MAX_FREE_BYTES
                        and len(self._free.get((kind, nbytes), ()))
                        < self._MAX_FREE_PER_CLASS)
        if poolable:
            try:
                # the next tenant's reader starts at head 0 and must never
                # see this tenant's frame headers
                np.frombuffer(region.buf, dtype=np.uint8).fill(0)
            except (ValueError, TypeError):
                poolable = False
        if not poolable:
            try:
                region.close()
            except Exception:
                pass
            with self._lock:
                _POOL_LEASED_BYTES.set(float(sum(self._out.values())))
            return
        with self._lock:
            self._free.setdefault((kind, nbytes), []).append(region)
            self._free_bytes += nbytes
            _POOL_LEASED_BYTES.set(float(sum(self._out.values())))
            _POOL_FREE_BYTES.set(float(self._free_bytes))

    def forget(self, region: Optional[Region]) -> None:
        """Drop the lease accounting of a region its owner closes itself
        (teardown: no window-close ack proves it writer-free, so it must
        not enter the free list)."""
        if region is None:
            return
        with self._lock:
            if self._out.pop(id(region), None) is not None:
                _POOL_LEASED_BYTES.set(float(sum(self._out.values())))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"free_bytes": self._free_bytes,
                    "free_regions": sum(len(b) for b in self._free.values()),
                    "leased_bytes": sum(self._out.values()),
                    "leased_regions": len(self._out)}

    def drain(self) -> None:
        """Close every free region."""
        with self._lock:
            regions = [r for b in self._free.values() for r in b]
            self._free.clear()
            self._free_bytes = 0
            _POOL_FREE_BYTES.set(0.0)
        for r in regions:
            try:
                r.close()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# Address: what gets exchanged at bootstrap.
# ---------------------------------------------------------------------------

class Address:
    """Serializable bootstrap blob: tag, domain, ring size and the handles of
    the receive ring and status page. ``caps`` are capability strings: this
    package advertises ``rdv`` (rendezvous on, ``core/rendezvous.py``) and
    ``park`` (it answers the park protocol), and reads those of the
    peer's."""

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
#: the park protocol's tokens, on the same stream. PARK asks the peer to
#: close its one-sided windows into our regions and answer ACK: only that
#: ack proves no stale writer remains, which lets the regions enter the
#: shared RingPool. NACK aborts (the peer is mid-send). WAKE asks a parked
#: peer to re-arm because we have bytes for it; REARM prefixes a framed
#: Address blob advertising fresh (or, on a park abort, retained) rings.
NOTIFY_PARK = b"p"
NOTIFY_PARK_ACK = b"q"
NOTIFY_PARK_NACK = b"n"
NOTIFY_WAKE = b"w"
#: "r": re-arm onto freshly leased rings (unpark); the peer builds a writer
#: at position zero. "R": re-arm onto retained rings (park abort, repair);
#: the peer restores its saved writer position. The frame must say which:
#: the pool can hand the same region straight back to the same pair, so a
#: handle cannot tell a fresh lease from retained rings.
NOTIFY_REARM = b"r"
NOTIFY_REARM_KEEP = b"R"
_CLASSIC_TOKENS = b"dcx"


class _ParkBusy(Exception):
    """Raised inside the send guard when a park episode owns the write
    side. ``Pair.send`` catches it, resolves the episode outside the guard
    (lock order: ``_park_lock`` before ``_send_guard``) and retries."""


class ContentAssertion:
    """Single-entrant tripwire on send/recv: two threads inside one side at
    once is a caller bug, raised loudly rather than corrupting a ring.

    The park protocol's handlers need the guard too, but run on a drain or
    poller thread: a send or recv racing one of them is no caller bug.
    :meth:`maintenance` marks such a hold, so that a regular entrant gets
    the retryable :class:`_ParkBusy` instead of the tripwire."""

    def __init__(self, name: str):
        self._name = name
        self._flag = False
        self._maint = False
        self._lock = threading.Lock()

    def __enter__(self):
        with self._lock:
            if self._flag:
                if self._maint:
                    raise _ParkBusy
                raise AssertionError(f"concurrent entry into {self._name}")
            self._flag = True

    def __exit__(self, *exc):
        with self._lock:
            self._flag = False
            self._maint = False
        return False

    @contextlib.contextmanager
    def maintenance(self):
        """Guard entry for a park-protocol handler: excludes an in-flight
        send/recv as regular entry does (AssertionError on conflict: the
        handler aborts or NACKs), but a racing regular entrant gets
        :class:`_ParkBusy`."""
        with self._lock:
            if self._flag:
                raise AssertionError(f"concurrent entry into {self._name}")
            self._flag = True
            self._maint = True
        try:
            yield self
        finally:
            self.__exit__()


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
        #: cached (np array, address) pins of the status pages for the
        #: waiter-advertisement words; nulled before any close or pool return
        self._status_np = None
        self._peer_status_np = None

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
        #: monotonic byte counters of the data plane
        self.total_sent = 0
        self.total_recv = 0
        # serializes notify-socket writes: one-byte tokens and the
        # multi-byte re-arm frame (a token inside a frame would corrupt the
        # peer's parser)
        self._notify_lock = threading.Lock()
        # idle-pair parking. Lock order where both are held: _park_lock
        # before _send_guard (send paths check the park flags inside the
        # guard and retry outside it, never taking _park_lock under it)
        self._park_lock = threading.Lock()
        #: serializes drain_notifications end to end, so that the park
        #: parser sees the token stream in order
        self._drain_mu = threading.Lock()
        self._parked = False          # own regions pooled; a stub remains
        self._park_pending = False    # PARK sent, ack/nack not yet seen
        self._park_sent_at = 0.0
        self._peer_parked = False     # peer's regions gone; writer is None
        #: (peer ring handle, tail, seq, remote_head) saved when a peer's
        #: PARK closes our writer, restored if it aborts with the same rings
        self._saved_wstate: Optional[Tuple[str, int, int, int]] = None
        self._peer_ring_handle = ""
        self._notify_buf = b""        # partial re-arm frame reassembly
        self.last_activity = time.monotonic()
        self.parked_epochs = 0        # completed park -> unpark round trips
        #: interned flight tag (plain ints on the hot path), the open
        #: credit-starvation edge and the poller's adaptive mode: all
        #: edge-triggered, so a healthy pair emits nothing per message
        self._ftag = _flight.tag_for("pair:" + self.tag)
        self._starve_open = False
        self._flight_mode = "bp"
        _PAIRS_CONNECTED.track(self)
        _PAIRS_WRITE_STALLED.track(self)
        _PAIRS_MSG_WAITING.track(self)
        _PAIRS_PARKED.track(self)
        _PAIR_RESIDENT.track(self)

    # -- lifecycle ----------------------------------------------------------

    def init(self) -> None:
        """Lease rings and reset state. Never this pair's old regions: a
        previous peer still holding a window onto one must land stale
        writes there, not in this connection's. Teardown closes them, and
        only regions a park's ACK proved writer-free are in the pool."""
        self._release_channels()
        self._release_regions()
        pool = RingPool.get()
        ring = pool.lease(self.domain, self.ring_size)
        try:
            status = pool.lease(self.domain, STATUS_BYTES)
        except BaseException:
            pool.release(ring)  # never advertised: no peer window onto it
            raise
        self.recv_region, self.status_region = ring, status
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
        # park state never survives a re-init (a fresh connection)
        self._parked = False
        self._park_pending = False
        self._peer_parked = False
        self._saved_wstate = None
        self._notify_buf = b""
        self.last_activity = time.monotonic()
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
        # because rendezvous imports this module. "waitflag": this side
        # publishes the waiter-advertisement words (the native fences are
        # present), so its peer may skip notifies while nobody waits.
        caps = ["waitflag"] if _native.load() is not None else []
        if os.environ.get("TPURPC_RENDEZVOUS", "1").lower() not in (
                "0", "off", "false"):
            caps.append("rdv")
        # park is two-sided (the peer must ack the window close and honor
        # WAKE/REARM): maybe_park initiates only against a peer that says so
        caps.append("park")
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
        self._peer_ring_handle = peer.ring_handle
        self.peer_caps = peer.caps
        self.writer = RingWriter(peer.ring_size, self._peer_ring.write,
                                 mapped=self._peer_ring.view)
        self.writer.flight_tag = self._ftag
        self.state = PairState.CONNECTED
        _flight.emit(_flight.PAIR_CONNECT, self._ftag, peer.ring_size)
        trace_ring.log("pair %s connected (peer tag %s, ring %d)",
                       self.tag, peer.tag, peer.ring_size)

    # -- waiter advertisement (futex-style sleep handshake) -------------------

    def _status_pin(self):
        """Cached (array, addr) pin of our status page, or None. The array
        holds a buffer export, so the region cannot unmap under a native
        call that took the pin into a local (teardown nulls the cache
        first, then Region.close retries its release)."""
        pin = self._status_np
        if pin is None:
            region = self.status_region
            if region is None:
                return None
            try:
                pin = _native.pin(region.buf, writable=True)
            except (ValueError, TypeError):
                return None  # racing teardown
            self._status_np = pin
            if self.status_region is not region:
                # teardown nulled the attribute between our read and the
                # cache store; a cached export would wedge Region.close's
                # retry. Our local still pins safely for this one call.
                self._status_np = None
                return None
        return pin

    def _peer_status_pin(self):
        pin = self._peer_status_np
        if pin is None:
            win = self._peer_status
            if win is None or win.view is None:
                return None
            try:
                pin = _native.pin(win.view, writable=False)
            except (ValueError, TypeError):
                return None
            self._peer_status_np = pin
            if self._peer_status is not win:  # see _status_pin
                self._peer_status_np = None
                return None
        return pin

    def set_waiting(self, role: str, flag: bool) -> None:
        """Publish "this role is blocked on the notify fd" in our status
        page, where the peer's producer reads it. A seq_cst store: the full
        fence the sleep protocol's Dekker argument needs (ring.cc). A no-op
        without the native library: then this side never advertised
        ``waitflag`` and its peer notifies unconditionally."""
        lib = _native.load()
        if lib is None:
            return
        pin = self._status_pin()
        if pin is None:
            return  # racing teardown; waiters re-check state and exit
        lib.tpr_store_u64_seqcst(pin[1] + _WAIT_OFF[role], 1 if flag else 0)

    def _peer_waiting(self, role: str) -> bool:
        """Is the peer's ``role`` waiter blocked on its notify fd? True also
        when we cannot tell (no native fences, window gone): the caller then
        sends the notify byte. The fenced load after our stores is the
        producer half of the sleep protocol. Negotiated: only a peer that
        advertised ``waitflag`` publishes the words; any other leaves them
        at 0 forever, which would read as "nobody waits" and hang it."""
        lib = _native.load()
        if lib is None or "waitflag" not in self.peer_caps:
            return True
        pin = self._peer_status_pin()
        if pin is None:
            return True
        return bool(lib.tpr_load_u64_fenced(pin[1] + _WAIT_OFF[role]))

    # -- notify channel -------------------------------------------------------

    def _notify(self, token: bytes) -> None:
        _transport.dispatch("frame", self, self._notify_raw, token)

    def _notify_raw(self, token: bytes) -> None:
        sock = self.notify_sock
        if sock is None:
            return
        try:
            # locked on every socket: the stream also carries multi-byte
            # re-arm frames, and on TLS OpenSSL forbids concurrent use of
            # one SSL* (a one-byte send goes whole or not at all, so a
            # dropped token stays best-effort)
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

    def _send_frame(self, payload: bytes, timeout_s: float = 5.0) -> bool:
        """Ship a multi-byte park-protocol frame over the notify stream,
        contiguously (the lock excludes token sends) and whole (a partial
        frame would corrupt the peer's parser, so a full socket is retried
        to a deadline, never dropped)."""
        return bool(_transport.dispatch("frame", self, self._send_frame_raw,
                                        payload, timeout_s))

    def _send_frame_raw(self, payload: bytes, timeout_s: float = 5.0) -> bool:
        sock = self.notify_sock
        if sock is None:
            return False
        deadline = time.monotonic() + timeout_s
        sent = 0
        with self._notify_lock:
            while sent < len(payload):
                try:
                    sent += sock.send(payload[sent:])
                except (BlockingIOError, InterruptedError,
                        ssl.SSLWantWriteError, ssl.SSLWantReadError):
                    if time.monotonic() >= deadline:
                        return False
                    try:
                        p = select.poll()
                        p.register(sock.fileno(), select.POLLOUT)
                        p.poll(50)
                    except (OSError, ValueError):
                        return False
                except OSError:
                    return False
        return True

    def drain_notifications(self) -> bytes:
        """Non-blocking drain of the notify channel; returns the classic
        tokens seen (data, credit, exit). Park-protocol bytes are acted on
        here and stripped. Serialized end to end, since a re-arm frame must
        be parsed in stream order. An empty read (peer closed) folds the
        status words, then flips the pair to ERROR unless the peer closed
        gracefully."""
        with self._drain_mu:
            raw = self._drain_raw()
            if not raw and not self._notify_buf:
                return raw
            if not self._notify_buf and not raw.translate(None,
                                                          _CLASSIC_TOKENS):
                return raw  # classic tokens only
            return self._fold_park_tokens(raw)

    def _drain_raw(self) -> bytes:
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

    # -- idle-pair parking -------------------------------------------------

    def _fold_park_tokens(self, raw: bytes) -> bytes:
        """Act on and strip park-protocol bytes; return the classic tokens.
        The caller holds ``_drain_mu``. A re-arm frame split across reads
        waits in ``_notify_buf``: its sender shipped it whole, so the rest
        is already in flight."""
        data = self._notify_buf + raw
        self._notify_buf = b""
        out = bytearray()
        i = 0
        n = len(data)
        while i < n:
            tok = data[i:i + 1]
            if tok == NOTIFY_PARK:
                i += 1
                self._handle_park_request()
            elif tok == NOTIFY_PARK_ACK:
                i += 1
                self._complete_park()
            elif tok == NOTIFY_PARK_NACK:
                i += 1
                with self._park_lock:
                    self._park_pending = False
            elif tok == NOTIFY_WAKE:
                i += 1
                self._handle_wake_request()
            elif tok in (NOTIFY_REARM, NOTIFY_REARM_KEEP):
                frame = data[i + 1:]
                if len(frame) < 8:
                    self._notify_buf = data[i:]
                    break
                if frame[:4] != _BOOTSTRAP_MAGIC:
                    self._mark_error("corrupt re-arm frame on notify stream")
                    break
                blen = struct.unpack("<I", frame[4:8])[0]
                if blen > _MAX_BLOB:
                    self._mark_error("re-arm frame implausibly large")
                    break
                if len(frame) < 8 + blen:
                    self._notify_buf = data[i:]
                    break
                self._handle_rearm(frame[8:8 + blen],
                                   retained=(tok == NOTIFY_REARM_KEEP))
                i += 1 + 8 + blen
            else:
                out += tok
                i += 1
        return bytes(out)

    def _close_peer_windows(self) -> None:
        """Drop the writer and close our windows into the peer's regions.
        The caller holds the send guard."""
        self.writer = None
        for attr in ("_peer_ring", "_peer_status"):
            win = getattr(self, attr)
            if win is not None:
                setattr(self, attr, None)
                self._peer_status_np = None
                retry_buffer_op(win.close)

    def _handle_park_request(self) -> None:
        """The peer will park: close our windows into its regions (after
        this no stale write of ours can land there), save the writer's
        position for an abort, and ack."""
        with self._park_lock:
            if self.state is not PairState.CONNECTED or self.want_write:
                self._notify(NOTIFY_PARK_NACK)
                return
            try:
                # excludes an in-flight send; a send entering after us gets
                # the retryable _ParkBusy, not the caller-bug tripwire
                with self._send_guard.maintenance():
                    if self.want_write:
                        self._notify(NOTIFY_PARK_NACK)
                        return
                    w = self.writer
                    if w is not None:
                        self._saved_wstate = (self._peer_ring_handle, w.tail,
                                              w.seq, w.remote_head)
                    self._close_peer_windows()
                    self._peer_parked = True
            except AssertionError:
                # a sender is inside send() right now: the pair is not idle
                self._notify(NOTIFY_PARK_NACK)
                return
        self._notify(NOTIFY_PARK_ACK)

    def _complete_park(self) -> None:
        """The peer acked our PARK: its windows into our regions are
        closed, so the regions are writer-free and may enter the pool.
        Bytes that landed between our park decision and the peer's window
        close abort the park instead. Only the receive ring and the status
        page go; the notify socket, the wake pipes and the waiter selectors
        stay, so a waiter asleep on them is woken by the unpark."""
        released = 0
        aborted = False
        with self._park_lock:
            if not self._park_pending:
                return
            self._park_pending = False
            if self.state is not PairState.CONNECTED:
                return
            try:
                # a receiver mid-drain means the pair is not idle: abort;
                # a receiver racing us retries as an empty read
                with self._recv_guard.maintenance():
                    if self.readable() or self.has_message():
                        aborted = True
                    else:
                        pool = RingPool.get()
                        if self.reader is not None:
                            retry_buffer_op(self.reader.release)
                            self.reader = None
                        self._status_np = None
                        for attr in ("recv_region", "status_region"):
                            region = getattr(self, attr)
                            if region is not None:
                                setattr(self, attr, None)
                                try:
                                    released += len(region.buf)
                                except ValueError:
                                    pass
                                pool.release(region)
                        self._published_head_mirror = 0
                        self._parked = True
                        self.parked_epochs += 1
            except AssertionError:
                aborted = True
        if aborted:
            # our rings are untouched: re-arm the peer's write side against
            # the same handles (its saved writer state restores)
            self._send_rearm(retained=True)
            self.kick()
            return
        _flight.emit(_flight.PAIR_PARK, self._ftag, released)
        _stats.counter_inc("pair_park")
        from tpurpc_torch.core.poller import Poller

        Poller.note_parked(self)
        trace_ring.log("pair %s parked (%d ring bytes pooled)",
                       self.tag, released)

    def unpark(self, *, remote: bool = False) -> None:
        """Re-arm a parked pair: lease fresh rings from the pool, rebuild
        the receive side, and ship the new Address to the peer. Callers'
        sends and recvs resume on the fresh rings."""
        leased = 0
        with self._park_lock:
            if not self._parked:
                return
            if self.state is not PairState.CONNECTED:
                return  # dying while parked; teardown forgets the stub
            pool = RingPool.get()
            ring = pool.lease(self.domain, self.ring_size)
            try:
                status = pool.lease(self.domain, STATUS_BYTES)
            except BaseException:
                pool.release(ring)
                raise
            try:
                self.recv_region = ring
                self.status_region = status
                self.recv_region.on_write = self.kick
                self.status_region.on_write = self.kick
                self.reader = RingReader(self.recv_region.buf, self.ring_size)
                self._published_head_mirror = 0
                self._parked = False
            except BaseException:
                # a failed re-arm returns both rings to the pool
                self.recv_region = None
                self.status_region = None
                self.reader = None
                pool.release(ring)
                pool.release(status)
                raise
            leased = self.ring_size + STATUS_BYTES
            self._send_rearm()
        _flight.emit(_flight.PAIR_UNPARK, self._ftag, leased,
                     1 if remote else 0)
        _stats.counter_inc("pair_unpark")
        from tpurpc_torch.core.poller import Poller

        Poller.note_unparked(self)
        self.kick()

    def _send_rearm(self, *, retained: bool = False) -> None:
        """Frame our current Address over the notify stream: the peer
        reopens windows onto these rings and rebuilds its writer."""
        if (self.recv_region is None or self.status_region is None
                or self.state not in (PairState.INITIALIZED,
                                      PairState.CONNECTED)):
            return
        blob = self.local_address().to_bytes()
        tok = NOTIFY_REARM_KEEP if retained else NOTIFY_REARM
        frame = tok + _BOOTSTRAP_MAGIC + struct.pack("<I", len(blob)) + blob
        if not self._send_frame(frame):
            self._mark_error("re-arm frame could not be delivered")

    def _handle_wake_request(self) -> None:
        """The peer has bytes for us and believes our rings are parked:
        re-arm. When we are not parked (the WAKE crossed our re-arm, or an
        overdue ack made the peer give up on a park we did honor), re-send
        the current Address: the peer ignores a duplicate, and it repairs
        a peer left with its windows closed."""
        if self._parked:
            try:
                self.unpark(remote=True)
            except Exception:
                pass  # pool exhaustion or a racing teardown: state shows it
        elif self.state is PairState.CONNECTED:
            self._send_rearm(retained=True)
            self.kick()

    def _handle_rearm(self, blob: bytes, *, retained: bool = False) -> None:
        """The peer advertised fresh or retained rings: rebuild our write
        side. A re-arm for rings we already write is ignored: rebuilding a
        live writer would reset its position mid-stream."""
        try:
            peer = Address.from_bytes(blob)
        except Exception:
            self._mark_error("undecodable re-arm frame")
            return
        with self._park_lock:
            saved, self._saved_wstate = self._saved_wstate, None
            if self.writer is not None:
                if self._peer_ring_handle == peer.ring_handle:
                    return  # duplicate
                # stale windows onto rings the peer replaced: close first
                try:
                    with self._send_guard.maintenance():
                        self._close_peer_windows()
                except AssertionError:
                    self._mark_error("re-arm raced an in-flight send")
                    return
            try:
                self._peer_ring = self.domain.open_window(peer.ring_handle,
                                                          peer.ring_size)
                self._peer_status = self.domain.open_window(
                    peer.status_handle, STATUS_BYTES)
            except Exception as exc:
                self._mark_error(f"re-arm window open failed: {exc!r}")
                return
            self._peer_ring_handle = peer.ring_handle
            self.writer = RingWriter(peer.ring_size, self._peer_ring.write,
                                     mapped=self._peer_ring.view)
            self.writer.flight_tag = self._ftag
            if retained:
                # park abort or repair: the peer kept its rings and its
                # reader position, so restore our exact write position
                if saved is not None and saved[0] == peer.ring_handle:
                    _, self.writer.tail, self.writer.seq, rh = saved
                    self.writer.remote_head = rh
                else:
                    # any guess at the write position corrupts the stream
                    self._mark_error("retained re-arm without writer state")
                    return
            elif self.status_region is not None:
                # fresh peer rings: its reader restarts at head 0, so the
                # stale published head in OUR status region must never fold
                # into the fresh writer (the peer publishes only after
                # reading data, and none flows until this writer exists)
                try:
                    self.status_region.buf[
                        _STATUS_HEAD_OFF:_STATUS_HEAD_OFF + 8] = bytes(8)
                except (ValueError, TypeError):
                    pass  # racing teardown; the state checks surface it
            self._peer_parked = False
        if self.want_write:
            self.process_credits()
        self.kick()

    def maybe_park(self, now: float, park_s: float) -> bool:
        """The poller sweep's hook: start (or progress) a park episode of an
        idle pair. True when a PARK was sent."""
        if (self._parked or self.notify_sock is None
                or "park" not in self.peer_caps):
            return False
        if self._park_pending:
            if now - self._park_sent_at > 2.0:
                with self._park_lock:
                    self._park_pending = False  # ack lost or peer gone
            # an ownerless idle pair has no waiter to read the ack: drain
            # here (and kick: a stolen token is safe only with a kick)
            if self.drain_notifications():
                self.kick()
            return False
        if (self.state is not PairState.CONNECTED or self.want_write
                or self.has_message() or self.readable()
                or now - self.last_activity < park_s):
            return False
        with self._park_lock:
            if self._park_pending or self._parked:
                return False
            try:
                with self._send_guard.maintenance():
                    if self.want_write or self.has_message():
                        return False
                    # visible to any sender entering the guard after us: no
                    # write can race the peer's window close
                    self._park_pending = True
                    self._park_sent_at = now
            except AssertionError:
                return False  # a sender is mid-flight: not idle
        self._notify(NOTIFY_PARK)
        _stats.counter_inc("pair_park_requested")
        return True

    def resident_bytes_est(self) -> int:
        """Host bytes this pair pins: its rings while live, a stub while
        parked."""
        n = 256  # object and bookkeeping stub
        if self.recv_region is not None:
            n += self.ring_size
        if self.status_region is not None:
            n += STATUS_BYTES
        return n

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
                # wake the peer's credit-stalled writer only if one sleeps;
                # a spinning writer watches the head word natively
                if force or self._peer_waiting("write"):
                    self._notify(NOTIFY_CREDIT)

    # -- data plane -----------------------------------------------------------

    def send(self, slices: Sequence, byte_idx: int = 0) -> int:
        """Send as much of ``slices[byte_idx:]`` as flow control allows;
        returns bytes accepted (partial sends are normal — the caller waits
        for credits). Payloads are chunked to ``send_chunk_size`` per ring
        message. A park episode is resolved here: a parked pair unparks, a
        parked peer is sent a WAKE and the send reports 0 accepted."""
        if self.state is not PairState.CONNECTED:
            raise BrokenPipeError(f"pair {self.tag} not sendable: {self.state}"
                                  + (f" ({self.error})" if self.error else ""))
        t0 = time.monotonic_ns()
        while True:
            try:
                if _tracing.LIVE and _tracing.current() is not None:
                    # a traced call on this thread: the ring-encode interval
                    # is its "send-lease" span
                    with _tracing.span("send-lease"):
                        n = self._send_traced(slices, byte_idx)
                else:
                    n = self._send_traced(slices, byte_idx)
                break
            except _ParkBusy:
                n = self._resolve_park_for_send()
                if n is not None:
                    break  # peer parked: 0 accepted, the wake in flight
        # the `wire` hop: bytes accepted across the transport boundary and
        # the nanoseconds the placement took, one set of bumps per send
        dt = time.monotonic_ns() - t0
        _LENS_WIRE_NS.inc(dt)
        _LENS_WIRE_BYTES.inc(n)
        _LENS_WIRE_COPY.inc(n)
        return n

    def _resolve_park_for_send(self) -> Optional[int]:
        """Resolve the park episode that made ``_send_inner`` raise
        :class:`_ParkBusy`, outside the send guard (lock order). Returns a
        byte count for ``send`` (peer parked: 0 accepted, the WAKE in
        flight, and the caller waits for credits), or None to retry."""
        with self._park_lock:
            peer_parked = self._peer_parked
            parked = self._parked
            pending = self._park_pending
        if peer_parked:
            # each retry re-sends the wake: idempotent, and a lost token is
            # survived (the endpoint's wait_writable has a timeout)
            self._notify(NOTIFY_WAKE)
            self.want_write = True
            return 0
        if parked:
            self.unpark()
            return None
        if pending:
            # our own PARK is in flight: drain for the ack or nack, bounded
            # so that a dead peer cannot wedge senders
            deadline = time.monotonic() + 2.5
            while time.monotonic() < deadline:
                if self.drain_notifications():
                    self.kick()  # stolen tokens: waiters re-check
                with self._park_lock:
                    if not (self._park_pending or self._parked
                            or self._peer_parked):
                        return None
                    if self._parked or self._peer_parked:
                        return None  # resolved; the retry takes that branch
                if self.state is not PairState.CONNECTED:
                    return None  # the retry surfaces the state error
                time.sleep(0.001)
            with self._park_lock:
                self._park_pending = False  # ack overdue; peer likely gone
        return None

    def _send_traced(self, slices: Sequence, byte_idx: int = 0) -> int:
        if _stats.profiling_on():
            with _stats.profile("pair_send"):
                return self._send_profiled(slices, byte_idx)
        return self._send_profiled(slices, byte_idx)

    def _send_profiled(self, slices: Sequence, byte_idx: int = 0) -> int:
        # want_write EDGES only (stall begin and end): the compare in the
        # finally is the whole per-send cost
        was_stalled = self.want_write
        try:
            return self._send_inner(slices, byte_idx)
        finally:
            now_stalled = self.want_write
            if now_stalled != was_stalled:
                if now_stalled:
                    _flight.emit(_flight.WRITE_STALL_BEGIN, self._ftag)
                    # a stall with zero writable payload is a starvation
                    # edge, not just a partial send re-armed
                    w = self.writer
                    if (w is not None and not self._starve_open
                            and w.writable_payload() == 0):
                        self._starve_open = True
                        _flight.emit(_flight.CREDIT_STARVE_BEGIN,
                                     self._ftag, w.tail - w.remote_head)
                else:
                    _flight.emit(_flight.WRITE_STALL_END, self._ftag)
                    if self._starve_open:
                        self._starve_open = False
                        _flight.emit(_flight.CREDIT_STARVE_END, self._ftag)

    def _send_inner(self, slices: Sequence, byte_idx: int = 0) -> int:
        cfg = get_config()
        with self._send_guard:
            if self._parked or self._park_pending or self._peer_parked:
                # checked inside the guard, which park initiation and the
                # ack handler also hold: a sender entering after a park
                # decision always sees the flag
                raise _ParkBusy
            views: List[memoryview] = []
            skip = byte_idx
            for s in slices:
                v = memoryview(s).cast("B")
                if skip >= len(v):
                    skip -= len(v)
                    continue
                views.append(v[skip:] if skip else v)
                skip = 0
            fast = self._send_fast(views, cfg)
            if fast is not None:
                return fast
            self.process_credits()
            total = 0
            while views:
                # batch every chunk the current credits admit into one
                # write_many (one bulk placement + one header per chunk)
                budget = self.writer.writable_payload()
                if budget == 0:
                    self.want_write = True
                    if not self._starve_open:
                        self._starve_open = True
                        _flight.emit(_flight.CREDIT_STARVE_BEGIN, self._ftag,
                                     self.writer.tail
                                     - self.writer.remote_head)
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
                if wrote_msgs:
                    _stats.batch_hist("ring_write").record(wrote_msgs)
                total += wrote_bytes
                if wrote_msgs < len(chunks):
                    # credits moved under us: re-queue the unwritten chunks
                    views[0:0] = [seg for ch in chunks[wrote_msgs:]
                                  for seg in ch]
                    self.want_write = True
                    break
            if not views:
                self.want_write = False
            self.total_sent += total
            # one completion event per send call, and only while the
            # receiver sleeps on its notify fd: a spinning receiver sees the
            # header land, so the BP/BPEV send makes no syscall (the waiting
            # flag and the fences make the skip lossless, ring.cc)
            if total:
                self.last_activity = time.monotonic()
                if self._peer_waiting("read"):
                    self._notify(NOTIFY_DATA)
            return total

    def _send_fast(self, views: "List[memoryview]", cfg) -> "Optional[int]":
        """Fused native send (``tpr_send_fast``): the credit fold, the
        chunked gather-encode and the sleep-protocol notify decision in one
        GIL-held C call. Returns the bytes accepted, or None when the fast
        path does not apply (no native library, an unmapped ring, teardown
        racing)."""
        lib = _native.load()
        writer = self.writer
        if (lib is None or writer is None or writer._nat is None
                or not views):
            return None
        status_pin = self._status_pin()
        if status_pin is None:
            return None
        peer_rxwait = 0
        if "waitflag" in self.peer_caps:
            peer_pin = self._peer_status_pin()
            if peer_pin is not None:
                peer_rxwait = peer_pin[1] + _STATUS_RXWAIT_OFF
        # small gather lists coalesce into ONE buffer first: an address
        # costs a numpy construction per segment, more than the memcpy of a
        # few hundred bytes. Large payloads keep true scatter-gather.
        small_total = sum(len(v) for v in views)
        if len(views) > 1 and small_total <= 4096:
            staged = bytearray(small_total)
            pos = 0
            for v in views:
                staged[pos:pos + len(v)] = v
                pos += len(v)
            views = [memoryview(staged)]
        n = len(views)
        # locals pin every view for the call's duration
        seg_ptrs = (ctypes.c_void_p * n)(
            *[_native.addr_of(v, writable=False) for v in views])
        seg_lens = (ctypes.c_uint64 * n)(*[len(v) for v in views])
        tail = ctypes.c_uint64(writer.tail)
        seq = ctypes.c_uint64(writer.seq)
        rh = ctypes.c_uint64(writer.remote_head)
        notify = ctypes.c_int(0)
        # The credit lock spans the CALL and the writeback: the peer can
        # consume freshly written bytes and publish a head beyond our stale
        # writer.tail the instant the C call's stores land, and a concurrent
        # process_credits() folding that head against the not-yet-written-
        # back tail would raise a spurious RingCorruption. The call is
        # GIL-held and bounded, so the hold is short.
        seq_before = writer.seq
        t0 = time.monotonic_ns()
        with self._credit_lock:
            got = lib.tpr_send_fast(
                writer._nat_addr, writer.layout.capacity,
                ctypes.byref(tail), ctypes.byref(seq),
                status_pin[1] + _STATUS_HEAD_OFF, ctypes.byref(rh),
                peer_rxwait or None, seg_ptrs, seg_lens, n,
                cfg.send_chunk_size, ctypes.byref(notify))
            writer.tail = tail.value
            writer.seq = seq.value
            if rh.value > writer.remote_head:
                writer.remote_head = rh.value
        dt = time.monotonic_ns() - t0
        if writer.seq > seq_before:  # ring messages this one C call encoded
            _stats.batch_hist("ring_write").record(writer.seq - seq_before)
            # the fused C path bypasses RingWriter.writev, so the registry
            # totals and the send_ring hop counters are bumped here
            _MSGS_OUT.inc(writer.seq - seq_before)
            _BYTES_OUT.inc(got)
            _LENS_SR_BYTES.inc(got)
            _LENS_SR_NS.inc(dt)
            _LENS_SR_COPY.inc(got)
        ring_ledger.host_copy(got)
        self.total_sent += got
        if got:
            self.last_activity = time.monotonic()
        total_len = sum(len(v) for v in views)
        self.want_write = got < total_len
        # the fast path folds only the credit word; peer_exit must still
        # flip the state
        if self.state is PairState.CONNECTED and self.status_region is not None:
            try:
                if _U64.unpack_from(self.status_region.buf,
                                    _STATUS_EXIT_OFF)[0]:
                    self.state = PairState.HALF_CLOSED
            except ValueError:
                pass  # racing teardown; caller's state checks surface it
        if notify.value:
            self._notify(NOTIFY_DATA)
        return got

    def recv_into(self, dst) -> int:
        """Drain the receive ring into ``dst``; publishes credits as a side
        effect. A parked pair reads 0: parked is not closed, and the peer's
        first byte arrives as a WAKE that re-arms us."""
        try:
            return self._recv_into_guarded(dst)
        except _ParkBusy:
            # a park completion owns the read side this instant: it aborts
            # (rings intact, a kick wakes us) or parks (which reads 0)
            return 0

    def _recv_into_guarded(self, dst) -> int:
        with self._recv_guard:
            reader = self.reader
            if reader is None:
                if self._parked:
                    return 0
                raise ConnectionError("pair is closed")
            try:
                n, nmsgs = reader.drain_into(dst)
            except (RingCorruption, ValueError) as exc:
                if "released" in str(exc):
                    raise ConnectionError("pair is closed") from None
                raise
            if nmsgs:
                _stats.batch_hist("ring_drain").record(nmsgs)
            self.total_recv += n
            if n:
                self.last_activity = time.monotonic()
            self._publish_credits_if_due()
            return n

    def recv(self, max_bytes: int = 1 << 20) -> bytes:
        """Drain up to ``max_bytes`` (at most one ring) as bytes."""
        cap = self.reader.layout.capacity if self.reader is not None else 0
        buf = bytearray(min(max_bytes, cap))
        n = self.recv_into(buf)
        truncate_after_read(buf, n)  # in place: bytes(buf[:n]) copies twice
        return bytes(buf)

    def has_message(self) -> bool:
        reader = self.reader
        try:
            return reader is not None and reader.has_message()
        except ValueError:
            return False  # ring released under a racing poller

    def readable(self) -> int:
        reader = self.reader
        try:
            return reader.readable() if reader is not None else 0
        except ValueError:
            return 0  # ring released under a racing poller

    def has_pending_writes(self) -> bool:
        """True when a sender stalled for credits and space has appeared."""
        if not self.want_write or self.writer is None:
            return False
        self.process_credits()
        return self.writer.writable_payload() > 0

    def spin(self, role: str, timeout_us: int) -> bool:
        """Bounded native spin on the role's watched words, GIL released.

        ``read`` watches the local receive ring for a complete message
        (its header and footer words); ``write`` watches the status page's
        head word the peer one-sided-writes credits into. Returns True when
        the watched condition fired OR the spin is impossible (no native
        library, memory released): the caller re-checks its full predicate
        in Python either way. False means the slice timed out quietly.

        The buffer is pinned by an exported view for the call's duration;
        Region.close retries its unmap until spinners unpin (at most one
        slice)."""
        spin = _native.load_spin()
        if spin is None:
            # pure-Python fallback: no bounded native spin exists, so yield
            # the core each lap and let the caller's ready() check
            time.sleep(0)
            return True
        if role == "read":
            reader = self.reader
            if reader is None or reader._msg_len:
                return True
            pin = reader._nat_pin  # local ref pins the ring across the call
            if pin is None:
                try:
                    pin, addr = _native.pin(reader.buf, writable=True)
                except (ValueError, TypeError):
                    return True  # ring released; predicate will surface it
            else:
                addr = reader._nat_addr
            r = spin.tpr_ring_wait_message(
                addr, reader.layout.capacity, reader.head,
                reader.seq, timeout_us)
            return r != 0
        writer = self.writer
        if writer is None:
            return True
        pin = self._status_pin()  # local ref pins across the GIL-free call
        if pin is None:
            return True
        # Watch for divergence from the last FOLDED credit value, not from the
        # word's current value: a credit that landed between the caller's
        # predicate check and this call returns immediately instead of
        # spinning a whole slice past it.
        r = spin.tpr_spin_u64_change(
            pin[1] + _STATUS_HEAD_OFF, writer.remote_head, timeout_us)
        return r != 0

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
            _flight.emit(_flight.PAIR_DISCONNECT, self._ftag)
        self.state = PairState.DISCONNECTED
        if self.want_write:
            # a dead pair's stall is over: an unclosed begin would keep the
            # watchdog naming credit starvation after the peer is gone
            _flight.emit(_flight.WRITE_STALL_END, self._ftag)
        self.want_write = False

    def _mark_error(self, why: str) -> None:
        if self.state is not PairState.DISCONNECTED:
            self.state = PairState.ERROR
            _flight.emit(_flight.PEER_DEATH, self._ftag)
            if self.want_write:
                # peer death mid-stall ends the stall, as in disconnect()
                _flight.emit(_flight.WRITE_STALL_END, self._ftag)
        if self.error is None:
            self.error = why
        self.kick()  # the state change is the waiters' wake condition
        trace_ring.log("pair %s -> ERROR: %s", self.tag, why)

    def _release_channels(self) -> None:
        """Per-connection state: peer windows, notify socket, wakeup pipes,
        reader view. Kick FIRST so a waiter blocked on these fds wakes."""
        # detach the asynchronous applier's hook before the wake fds
        # close: a record landing mid-teardown must not kick a closed (and
        # possibly reused) fd number
        for region in (self.recv_region, self.status_region):
            if region is not None:
                region.on_write = None
        if self._parked or self._park_pending:
            # a pair dying while parked drops its parked-watcher slot
            self._parked = False
            self._park_pending = False
            from tpurpc_torch.core.poller import Poller

            Poller.forget_parked(self)
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
        # the attribute first (new pins become impossible), then the cache,
        # then the close; a pin held in a local is covered by the retry
        for attr in ("_peer_ring", "_peer_status"):
            w = getattr(self, attr)
            if w is not None:
                setattr(self, attr, None)
                self._peer_status_np = None
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
        # teardown never pools a region (no window-close ack proves it
        # writer-free): its lease is forgotten and it closes
        for attr in ("recv_region", "status_region"):
            r = getattr(self, attr)
            if r is not None:
                setattr(self, attr, None)
                self._status_np = None
                RingPool.get().forget(r)
                r.close()

    def destroy(self) -> None:
        """Release everything per-connection, ring regions included; a later
        ``init()`` revives the object."""
        if self.state in (PairState.CONNECTED, PairState.HALF_CLOSED):
            self.disconnect()
        self._release_channels()
        self._release_regions()
        self.state = PairState.UNINITIALIZED


def create_loopback_pair(ring_size: int = 1 << 16,
                         domain: Optional[MemoryDomain] = None
                         ) -> Tuple[Pair, Pair]:
    """Two connected in-process pairs over a unix socketpair."""
    domain = domain or LocalDomain()
    a = Pair(domain, ring_size)
    b = Pair(domain, ring_size)
    a.init()
    b.init()
    sa, sb = socket.socketpair()
    done: List[Optional[BaseException]] = [None]

    def _bside():
        try:
            b.connect_over_socket(sb)
        except BaseException as exc:  # surfaced below
            done[0] = exc

    t = threading.Thread(target=_bside, daemon=True)
    t.start()
    a.connect_over_socket(sa)
    t.join(timeout=10)
    if done[0] is not None:
        raise done[0]
    return a, b
