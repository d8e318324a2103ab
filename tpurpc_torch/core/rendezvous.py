"""Rendezvous: one-sided transfers for bulk tensor payloads.

A trimmed copy of ``tpurpc/core/rendezvous.py``. A MESSAGE payload over a
size bar does not ride the framed connection: the sender writes it, in one
placement, into a landing region the receiver granted, and the connection
carries only small control frames:

    sender                                  receiver
    ------                                  --------
    OFFER(req, nbytes, kinds)  ──────────►  lease a landing region
                               ◄──────────  CLAIM(req, lease, region)
    write every gather segment
    into the region (one
    memoryview copy per segment)
    COMPLETE(lease, nbytes, flags) ───────► deliver a view of the region
                                            (the decode aliases it)

Control ops ride the framed connection, or the connection's descriptor
rings (``core/ctrlring.py``), whose records carry the sender's frame count
so that they keep frame order with the small MESSAGEs around them. A peer
that never said hello never sees one.

Invariants:

* the sender writes a region only between CLAIM and COMPLETE/RELEASE;
* a region is reused only after COMPLETE and the death of every consumer
  alias (a ``weakref.finalize`` on the delivered wrapper), or after an
  explicit RELEASE;
* peer death with a claimed region releases it (``RdvLink.close``), and the
  region is destroyed, never re-leased.

Steady state: after each delivery the receiver keeps up to
``_PREGRANT_DEPTH`` STANDING grants of the stream's size class outstanding
(request id 0). A standing region is reused with no claim round trip: the
receiver's consumer-freed count sits in a doorbell word behind the region,
and the sender reads it through its open window before writing again.

Lifetime: a delivered payload is a memoryview over a numpy wrapper of the
region. Every consumer alias (the codec's decoded arrays and the torch
tensors over them) holds the wrapper, so the finalize fires only when no
consumer can read the memory any more.

Block-granular grants (:class:`BlockGrant`, :class:`GrantWriter`): the
KV plane's unit is the block, so a grant names a scatter of block offsets
inside one registered arena region, and the sender writes each block
straight into place through a window it keeps open per region.

Control ops leave through :meth:`RdvLink._ctrl_send`: into the peer's
descriptor ring when the connection armed one (``ctrl_post``, bound by the
connection from ``core/ctrlring.py``; zero frames), else framed through
:class:`_CtrlFrameCoalescer`, which writes a burst of ops queued behind an
in-flight write as one multi-frame send (``send_ops``). ``ctrl_drain``
lets a waiting sender consume its own ring for standing-grant top-ups.

Inline-pump transports (the channel's pump mode) hand the link
``pump(pred, deadline)``: a sender waiting for its CLAIM drives the
connection's reader itself, since no reader thread will.

Observability, under the reference's names: the ``rendezvous`` and
``ctrl`` lens hops, the ``rendezvous`` profiler stage, the process-wide
``rdv_transfers_sent``/``_received``, ``rdv_fallbacks``,
``rdv_claims_refused``, ``rdv_ctrl_frames`` and ``rdv_window_share_hits``
counters, the ``ctrl_coalesce`` histogram, and the ``RDV_OFFER``,
``RDV_CLAIM``, ``RDV_WRITE``, ``RDV_COMPLETE`` and ``RDV_RELEASE`` flight
edges of solicited transfers under ``rdv:<name>`` (standing-grant reuse is
traffic and stays silent). Each link also counts its own transfers in
:meth:`RdvLink.stats` (``ctrl_frames``: control ops this side framed;
``ctrl_posts``: those it posted into the peer's ring).

Env knobs: ``TPURPC_RENDEZVOUS`` (default on), ``TPURPC_RENDEZVOUS_MIN_KB``
(size bar, default 256), ``TPURPC_RENDEZVOUS_POOL_MB`` (landing pool budget
per domain, default 256), ``TPURPC_RENDEZVOUS_CLAIM_TIMEOUT_S`` (claim wait
before falling back to the framed path, default 5).
"""

from __future__ import annotations

import atexit
import itertools
import os
import struct
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpurpc_torch.core import pair as _pair
from tpurpc_torch.core import transport as _transport
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import lens as _lens
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.tpu import ledger as _ledger
from tpurpc_torch.utils import stats as _stats
from tpurpc_torch.utils.trace import trace_endpoint

__all__ = [
    "LandingPool", "RegionLease", "RdvLink", "landing_pool",
    "link_for_endpoint", "enabled", "min_bytes", "size_class",
    "OP_OFFER", "OP_CLAIM", "OP_COMPLETE", "OP_RELEASE", "HELLO_PAYLOAD",
]

# the one-sided bulk write is its own lens hop: the bytes that no longer
# flow through wire/send_ring show up here
_LENS_RDV_BYTES, _LENS_RDV_NS, _LENS_RDV_COPY = _lens.hop_counters(
    "rendezvous")

_LENS_STAGES = {
    "send_message": "rendezvous",
    "_rdv_write": "rendezvous",
    "rdv_claim": "rendezvous",
    "on_offer": "rendezvous",
    "on_complete": "rendezvous",
}
_profiler.register_stages(__file__, _LENS_STAGES)

#: transfers negotiated, completed and fallen back: whether the bulk plane
#: carries traffic at all
_RDV_SENT = _metrics.counter("rdv_transfers_sent")
_RDV_RECV = _metrics.counter("rdv_transfers_received")
_RDV_FALLBACK = _metrics.counter("rdv_fallbacks")
_RDV_REFUSED = _metrics.counter("rdv_claims_refused")
#: control ops that rode the framed path (a descriptor-ring link in steady
#: state holds it flat)
_RDV_CTRL_FRAMES = _metrics.counter("rdv_ctrl_frames")

# framed control sends are control-plane busy time, the same hop as the
# descriptor rings' posts and drains (core/ctrlring.py)
_LENS_CTRL_BYTES, _LENS_CTRL_NS, _LENS_CTRL_COPY = _lens.hop_counters(
    "ctrl")

# control ops (small ints; the framing maps them onto frame types 8..11)
OP_OFFER = 1
OP_CLAIM = 2
OP_COMPLETE = 3
OP_RELEASE = 4

#: capability hello: a PING with this payload. Any peer echoes it in a
#: PONG; only a rendezvous-capable peer also arms its link.
HELLO_PAYLOAD = b"\x00tpurpc-rdv1"

_OFFER = struct.Struct("<QQ")       # req_id, nbytes (+ kinds utf8 tail)
_CLAIM_HDR = struct.Struct("<QQB")  # req_id, lease_id, ok
_CLAIM_REG = struct.Struct("<QQ16sB")  # offset, capacity, nonce, standing
_COMPLETE = struct.Struct("<QQB")   # lease_id, nbytes, flags
_RELEASE = struct.Struct("<QQ")     # lease_id (0 = none), req_id
_DOORBELL = struct.Struct("<Q")     # consumer-freed count

_MIN_CLASS = 64 * 1024
_ALIGN = 64
_NONCE_BYTES = 16
_MAX_TRANSFER = 1 << 30  # sanity bound on one offer
_WINDOW_CACHE = 64       # open peer-region windows kept per link
#: standing grants per (link, size class): enough that a sender with a few
#: messages in flight never waits a claim round trip in steady state
_PREGRANT_DEPTH = 4

_SENTINEL_PENDING = object()
_SENTINEL_REFUSED = object()


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def enabled() -> bool:
    return _env("TPURPC_RENDEZVOUS", "1").lower() not in ("0", "off",
                                                          "false")


def min_bytes() -> int:
    """The size bar: payloads at or above it rendezvous, smaller ones are
    framed. Read live."""
    try:
        return max(1, int(_env("TPURPC_RENDEZVOUS_MIN_KB", "256"))) * 1024
    except ValueError:
        return 256 * 1024


def _pool_budget() -> int:
    try:
        return max(1, int(_env("TPURPC_RENDEZVOUS_POOL_MB", "256"))) << 20
    except ValueError:
        return 256 << 20


def _claim_timeout() -> float:
    try:
        return float(_env("TPURPC_RENDEZVOUS_CLAIM_TIMEOUT_S", "5"))
    except ValueError:
        return 5.0


def size_class(nbytes: int) -> int:
    """A transfer size rounded up to its pool size class (a power of two,
    at least 64 KiB): regions pool and pre-grants match at this grain."""
    if nbytes > _MAX_TRANSFER:
        raise ValueError(f"transfer of {nbytes} bytes exceeds the "
                         f"{_MAX_TRANSFER} rendezvous bound")
    c = _MIN_CLASS
    while c < nbytes:
        c <<= 1
    return c


def _alloc_bytes(capacity: int) -> int:
    return capacity + _ALIGN + _NONCE_BYTES + _DOORBELL.size


# ---------------------------------------------------------------------------
# Landing pool: the regions a receiver grants.
# ---------------------------------------------------------------------------

class _PoolRegion:
    """One landing region: the domain Region, the 64-byte alignment offset
    of its payload span, the nonce and the doorbell word behind it (layout
    ``[pad][payload capacity][nonce 16][doorbell 8]``)."""

    __slots__ = ("region", "offset", "capacity", "nonce")

    def __init__(self, region: _pair.Region, offset: int, capacity: int,
                 nonce: bytes):
        self.region = region
        self.offset = offset
        self.capacity = capacity
        self.nonce = nonce

    def doorbell_store(self, value: int) -> None:
        """Publish the consumer-freed count into the region, where the
        sender reads it through its open window: the "region reusable"
        signal with no control frame. The count only grows, and the sender
        writes its payload after reading it."""
        _DOORBELL.pack_into(self.region.buf,
                            self.offset + self.capacity + _NONCE_BYTES,
                            value)


class RegionLease:
    """A pool region claimed for transfers on one link.

    A one-shot lease (a solicited claim) delivers once and recycles when
    the delivered wrapper's last alias dies. A STANDING lease (the
    steady-state grant) stays claimed across transfers: each wrapper's
    death rings the doorbell instead, and the sender reuses the region."""

    __slots__ = ("pool", "pr", "lease_id", "cls", "kind", "pregrant",
                 "standing", "delivered", "_freed", "_retired", "_recycled",
                 "_discard", "_lock")

    def __init__(self, pool: "LandingPool", pr: _PoolRegion, lease_id: int,
                 cls: int):
        self.pool = pool
        self.pr = pr
        self.lease_id = lease_id
        self.cls = cls
        self.kind = pool.kind
        self.pregrant = False
        self.standing = False
        self.delivered = 0
        self._freed = 0
        self._retired = False
        self._recycled = False
        self._discard = False
        self._lock = threading.Lock()

    def _maybe_recycle_locked(self) -> bool:
        """The one recycle rule: a region returns to the pool once, when no
        further delivery can happen (retired, or a one-shot lease already
        delivered) and no delivered wrapper is still aliased."""
        if self._recycled:
            return False
        done = self._retired or (self.delivered > 0 and not self.standing)
        if done and self._freed == self.delivered:
            self._recycled = True
            return True
        return False

    def claim_fields(self) -> Tuple[str, str, int, int, bytes, bool]:
        pr = self.pr
        return (self.kind, pr.region.handle, pr.offset, pr.capacity,
                pr.nonce, self.standing)

    def deliver(self, nbytes: int):
        """The received payload as a writable memoryview of the region. The
        region's reuse waits for the wrapper's death: every consumer alias
        holds it."""
        with self._lock:
            if self._retired or (self.delivered and not self.standing):
                raise RuntimeError("lease already settled")
            if nbytes > self.pr.capacity:
                raise ValueError(f"complete of {nbytes} exceeds leased "
                                 f"capacity {self.pr.capacity}")
            if self.standing and self.delivered != self._freed:
                # the sender reused a standing region while its previous
                # delivery is still aliased: refuse a second alias over
                # live memory
                raise RuntimeError("standing region completed while its "
                                   "previous delivery is still aliased")
            self.delivered += 1
            gen = self.delivered
        wrapper = np.frombuffer(self.pr.region.buf, np.uint8, count=nbytes,
                                offset=self.pr.offset)
        weakref.finalize(wrapper, self._on_wrapper_dead, gen)
        # a memoryview over the wrapper (not the ndarray): the stream layer
        # treats message bodies as buffers, and every alias still chains to
        # the wrapper
        return memoryview(wrapper)

    def _on_wrapper_dead(self, gen: int) -> None:
        with self._lock:
            self._freed = max(self._freed, gen)
            recycle = self._maybe_recycle_locked()
            discard = self._discard
            ring = self.standing and not self._retired
        if recycle:
            self.pool._recycle(self.pr, self.cls, discard=discard)
        elif ring:
            self.pr.doorbell_store(gen)

    def release(self, discard: bool = False) -> None:
        """Return the region without (further) delivery. With a delivered
        wrapper still aliased, the recycle waits for its finalize.

        ``discard=True`` (peer death): the region is destroyed, not pooled —
        a straggling sender may still land a late write, which must hit
        orphaned memory and never a region re-leased to a new transfer."""
        with self._lock:
            self._retired = True
            if discard:
                self._discard = True
            recycle = self._maybe_recycle_locked()
            discard = self._discard
        if recycle:
            self.pool._recycle(self.pr, self.cls, discard=discard)


class LandingPool:
    """Per-domain pool of 64-byte-aligned landing regions, by power-of-two
    size class under a byte budget, recycled only when no consumer can
    read them (see :meth:`RegionLease.deliver`)."""

    def __init__(self, kind: str, budget: Optional[int] = None):
        self.kind = kind
        self._domain = _pair.make_domain(kind)
        self._lock = threading.Lock()
        self._free: Dict[int, List[_PoolRegion]] = {}
        #: discarded regions still pinned by consumer aliases: their close
        #: is retried on later pool activity, and they are never re-leased
        self._zombies: List[_PoolRegion] = []
        self._allocated = 0
        self._budget = budget if budget is not None else _pool_budget()
        #: every region of this pool not yet destroyed, by handle
        self._regions: Dict[str, _PoolRegion] = {}

    def _try_close(self, pr: _PoolRegion) -> bool:
        """Destroy a region if nothing pins it; never blocks (a finalizer
        may be the caller)."""
        try:
            pr.region.buf.release()
            pr.region._close()
        except BufferError:
            return False  # still mapped by an alias: retried later
        except Exception:
            pass  # the mapping goes with the process anyway
        with self._lock:
            self._regions.pop(pr.region.handle, None)
        return True

    def unlink_all(self) -> None:
        """At exit: remove every region's name from the system, pinned or
        claimed ones too (their mappings go with the process)."""
        with self._lock:
            regions, self._regions = list(self._regions.values()), {}
        for pr in regions:
            try:
                pr.region._close()
            except Exception:
                pass  # unlinked; the mapping is still exported

    def lease(self, nbytes: int, lease_id: int) -> Optional[RegionLease]:
        """A region of capacity ≥ ``nbytes``, or None when the budget is
        spent (the claim is refused and the sender frames the payload)."""
        cls = size_class(nbytes)
        with self._lock:
            zombies, self._zombies = self._zombies, []
        if zombies:
            still = [pr for pr in zombies if not self._try_close(pr)]
            if still:
                with self._lock:
                    self._zombies.extend(still)
        with self._lock:
            bucket = self._free.get(cls)
            if bucket:
                pr = bucket.pop()
                pr.doorbell_store(0)  # a fresh lease has no consumer history
                return RegionLease(self, pr, lease_id, cls)
            alloc_bytes = _alloc_bytes(cls)
            if self._allocated + alloc_bytes > self._budget:
                return None
            self._allocated += alloc_bytes
        try:
            region = self._domain.alloc(alloc_bytes)
        except Exception:
            with self._lock:
                self._allocated -= alloc_bytes
            return None
        base = np.frombuffer(region.buf, np.uint8)
        offset = int((-base.ctypes.data) % _ALIGN)
        del base
        nonce = os.urandom(_NONCE_BYTES)
        region.buf[offset + cls:offset + cls + _NONCE_BYTES] = nonce
        pr = _PoolRegion(region, offset, cls, nonce)
        with self._lock:
            self._regions[region.handle] = pr
        return RegionLease(self, pr, lease_id, cls)

    def _recycle(self, pr: _PoolRegion, cls: int,
                 discard: bool = False) -> None:
        if discard:
            with self._lock:
                self._allocated -= _alloc_bytes(pr.capacity)
            if not self._try_close(pr):
                with self._lock:
                    self._zombies.append(pr)
            return
        with self._lock:
            self._free.setdefault(cls, []).append(pr)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "allocated_bytes": self._allocated,
                "free_regions": sum(len(v) for v in self._free.values()),
            }

    def trim(self) -> None:
        """Release every pooled free region (exit, test isolation).
        In-flight and alias-pinned regions are untouched."""
        with self._lock:
            buckets, self._free = self._free, {}
            for bucket in buckets.values():
                for pr in bucket:
                    self._allocated -= _alloc_bytes(pr.capacity)
        for bucket in buckets.values():
            for pr in bucket:
                try:
                    pr.region.close()
                except Exception:
                    continue  # an alias raced the trim; it stays mapped
                with self._lock:
                    self._regions.pop(pr.region.handle, None)


_pools: Dict[str, LandingPool] = {}
_pools_lock = threading.Lock()


def landing_pool(kind: str) -> LandingPool:
    """The process-wide landing pool of one domain kind."""
    pool = _pools.get(kind)
    if pool is None:
        with _pools_lock:
            pool = _pools.get(kind)
            if pool is None:
                pool = _pools[kind] = LandingPool(kind)
    return pool


def _trim_pools_atexit() -> None:
    for pool in list(_pools.values()):
        pool.trim()
        pool.unlink_all()
    # Regions still pinned by live aliases cannot close; at teardown each
    # SharedMemory destructor would print an unraisable BufferError for a
    # harmless condition (the OS takes the mappings back). Silence the
    # destructor after the orderly trim.
    try:
        from multiprocessing import shared_memory

        shared_memory.SharedMemory.__del__ = lambda self: None
    except Exception:
        pass


atexit.register(_trim_pools_atexit)


# ---------------------------------------------------------------------------
# Wire payloads of the control messages.
# ---------------------------------------------------------------------------

def _pack_offer(req_id: int, nbytes: int, kinds: Sequence[str]) -> bytes:
    return _OFFER.pack(req_id, nbytes) + ",".join(kinds).encode()


def _unpack_offer(payload) -> Tuple[int, int, List[str]]:
    buf = bytes(payload)
    req_id, nbytes = _OFFER.unpack_from(buf)
    kinds = buf[_OFFER.size:].decode() or ""
    return req_id, nbytes, [k for k in kinds.split(",") if k]


def _pack_claim(req_id: int, lease: Optional[RegionLease]) -> bytes:
    if lease is None:
        return _CLAIM_HDR.pack(req_id, 0, 0)
    kind, handle, offset, capacity, nonce, standing = lease.claim_fields()
    kb = kind.encode()
    return (_CLAIM_HDR.pack(req_id, lease.lease_id, 1)
            + _CLAIM_REG.pack(offset, capacity, nonce, 1 if standing else 0)
            + bytes([len(kb)]) + kb + handle.encode())


class _Claim:
    """The sender's view of a claimed region. A STANDING claim is reused:
    after each COMPLETE the sender bumps ``used`` and writes again only
    once the region's doorbell has caught up with it."""

    __slots__ = ("lease_id", "kind", "handle", "offset", "capacity",
                 "nonce", "standing", "used", "inflight")

    def __init__(self, lease_id, kind, handle, offset, capacity, nonce,
                 standing=False):
        self.lease_id = lease_id
        self.kind = kind
        self.handle = handle
        self.offset = offset
        self.capacity = capacity
        self.nonce = nonce
        self.standing = standing
        self.used = 0
        self.inflight = False  # a sender thread owns this claim right now


def _unpack_claim(payload) -> Tuple[int, Optional[_Claim]]:
    buf = bytes(payload)
    req_id, lease_id, ok = _CLAIM_HDR.unpack_from(buf)
    if not ok:
        return req_id, None
    pos = _CLAIM_HDR.size
    offset, capacity, nonce, standing = _CLAIM_REG.unpack_from(buf, pos)
    pos += _CLAIM_REG.size
    klen = buf[pos]
    pos += 1
    kind = buf[pos:pos + klen].decode()
    handle = buf[pos + klen:].decode()
    return req_id, _Claim(lease_id, kind, handle, offset, capacity, nonce,
                          standing=bool(standing))


# ---------------------------------------------------------------------------
# Shared peer windows.
# ---------------------------------------------------------------------------

#: cross-link window reuse: every hit is an attach not repeated
_WINDOW_SHARE_HITS = _metrics.counter("rdv_window_share_hits")


class _WindowShare:
    """Process-wide refcounted cache of open windows onto peer regions,
    keyed ``(kind, handle)``: links writing into the same peer region share
    one open window (one mmap instead of one per link).

    ``acquire`` bumps a refcount (opening on a miss); ``release`` drops it
    and parks a window nobody holds on a bounded idle list, so the next
    acquirer of that region skips the open. Windows open on the share's own
    domains, so a shared window does not die with the link that opened it.
    A claim leases a region to one transfer at a time, so holders never
    write the same bytes at once."""

    _MAX_IDLE = 64

    def __init__(self):
        self._lock = threading.Lock()
        #: key -> [window, refcount, window_bytes]
        self._entries: Dict[Tuple[str, str], list] = {}
        self._idle: List[Tuple[str, str]] = []  # refcount-0 keys, LRU
        self._domains: Dict[str, _pair.MemoryDomain] = {}

    def _domain(self, kind: str) -> _pair.MemoryDomain:
        with self._lock:
            d = self._domains.get(kind)
            if d is None:
                d = self._domains[kind] = _pair.make_domain(kind)
            return d

    def acquire(self, kind: str, handle: str, nbytes: int) -> _pair.Window:
        key = (kind, handle)
        stale = None
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                if e[2] >= nbytes:
                    if e[1] == 0:
                        try:
                            self._idle.remove(key)
                        except ValueError:
                            pass
                    e[1] += 1
                    _WINDOW_SHARE_HITS.inc()
                    return e[0]
                if e[1] == 0:
                    # undersized and idle: retire it, reopen bigger below
                    stale = self._entries.pop(key)
                    try:
                        self._idle.remove(key)
                    except ValueError:
                        pass
        if stale is not None:
            try:
                stale[0].close()
            except Exception:
                pass
        win = self._domain(kind).open_window(handle, nbytes)
        with self._lock:
            if key not in self._entries:
                self._entries[key] = [win, 1, nbytes]
                return win
        # raced another opener, or an undersized entry is still held: a
        # private window, which release() closes outright
        return win

    def release(self, kind: str, handle: str, win: _pair.Window) -> None:
        key = (kind, handle)
        close_now = []
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e[0] is win:
                if e[1] > 0:
                    e[1] -= 1
                    if e[1] == 0:
                        self._idle.append(key)
                        while len(self._idle) > self._MAX_IDLE:
                            k = self._idle.pop(0)
                            dead = self._entries.pop(k, None)
                            if dead is not None:
                                close_now.append(dead[0])
            else:
                close_now.append(win)  # a private window (see acquire)
        for w in close_now:
            try:
                w.close()
            except Exception:
                pass

_WINDOW_SHARE: Optional[_WindowShare] = None
_WINDOW_SHARE_LOCK = threading.Lock()


def window_share() -> _WindowShare:
    global _WINDOW_SHARE
    with _WINDOW_SHARE_LOCK:
        if _WINDOW_SHARE is None:
            _WINDOW_SHARE = _WindowShare()
        return _WINDOW_SHARE


# ---------------------------------------------------------------------------
# The link: one per framed connection, both roles.
# ---------------------------------------------------------------------------

class _CtrlFrameCoalescer:
    """Self-clocking combiner for framed control ops: the first sender
    writes directly; ops that arrive while a write is in flight queue and
    leave in ONE multi-frame send (``send_ops``), so a burst of COMPLETEs
    from N streams costs one transport write instead of N. An idle link
    waits for no timer. Without ``send_ops`` (the h2 planes) each op is
    sent alone; FIFO order holds either way.

    ``send(..., wait=True)`` returns only once the op has been written,
    by this thread or by the flusher that took it: a COMPLETE must be on
    the wire before its sender writes the stream's next frame (a reply's
    TRAILERS), or the peer closes the stream before the message arrives.
    The reference returns as soon as the op is queued and loses replies
    under concurrent calls (a stated divergence)."""

    def __init__(self, send_op: Callable[[int, int, bytes], None],
                 send_ops: Optional[Callable] = None):
        self._send_op = send_op
        self._send_ops = send_ops
        self._mu = threading.Lock()
        self._done = threading.Condition(self._mu)
        self._pending: List[Tuple[int, int, bytes]] = []
        self._flushing = False
        #: ops queued so far, and ops written (or dropped by a failed
        #: write) so far: a waiter's op is out once ``_out`` reaches it
        self._queued = 0
        self._out = 0

    def send(self, op: int, stream_id: int, payload: bytes,
             wait: bool = False) -> None:
        if self._send_ops is None:
            self._send_op(op, stream_id, payload)
            return
        with self._mu:
            self._pending.append((op, stream_id, payload))
            self._queued += 1
            mine = self._queued
            if self._flushing:
                # the in-flight flusher writes it (or drops it with the
                # connection); it leaves only with the queue empty
                while wait and self._out < mine:
                    self._done.wait()
                return
            self._flushing = True
        while True:
            with self._mu:
                batch, self._pending = self._pending, []
                if not batch:
                    self._flushing = False
                    self._done.notify_all()
                    return
            try:
                if len(batch) == 1:
                    self._send_op(*batch[0])
                else:
                    self._send_ops(batch)
                    _stats.batch_hist("ctrl_coalesce").record(len(batch))
            except BaseException:
                # connection dying: drop the queue (every control path
                # treats sends as best effort; link close releases leases)
                with self._mu:
                    self._out = self._queued
                    self._pending = []
                    self._flushing = False
                    self._done.notify_all()
                raise
            with self._mu:
                self._out += len(batch)
                self._done.notify_all()


class RdvLink:
    """Rendezvous state of one framed connection: the sender role (offer,
    write, complete) and the receiver role (leases, claims, delivery).

    The connection supplies ``send_op(op, stream_id, payload)``, which
    frames one control message, optionally ``send_ops(ops)``, which frames
    several in one write, and ``deliver(stream_id, flags, body)``, which
    hands a completed payload to the stream layer, and optionally
    ``pump(pred, deadline)`` for inline-pump transports, where the waiting
    sender must drive the reader itself."""

    def __init__(self, name: str,
                 send_op: Callable[[int, int, bytes], None],
                 deliver: Callable[[int, int, object], None],
                 pool_kinds: Sequence[str] = ("shm",),
                 open_kinds: Sequence[str] = ("shm", "local"),
                 pump: Optional[Callable] = None,
                 send_ops: Optional[Callable] = None):
        self.name = name
        self._send_op = send_op
        self._coalescer = _CtrlFrameCoalescer(send_op, send_ops)
        #: descriptor-ring seams, bound by the connection when its ring
        #: plane arms: ``ctrl_post(op, sid, payload) -> bool`` places a
        #: control op in the peer's ring (True: the framed path must not
        #: send it too); ``ctrl_drain()`` consumes this side's ring from a
        #: sender thread (standing-grant pickup)
        self.ctrl_post: Optional[Callable[[int, int, bytes], bool]] = None
        self.ctrl_drain: Optional[Callable[[], int]] = None
        self._deliver = deliver
        self._pool_kinds = tuple(pool_kinds)
        self._open_kinds = tuple(open_kinds)
        self._pump = pump
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.negotiated = False
        self.closed = False
        #: the reader thread's ident: a sender there must never wait for a
        #: claim that this same thread would have to deliver
        self.disallowed_thread: Optional[int] = None
        #: the connection's receive limit (None or negative: unlimited).
        #: Offers past it are refused, so the framed path's oversize check
        #: rejects the payload with RESOURCE_EXHAUSTED
        self.recv_limit: Optional[int] = None
        self._req_ids = itertools.count(1)
        self._lease_ids = itertools.count(1)
        self._reqs: Dict[int, dict] = {}            # sender: req -> state
        self._grants: Dict[int, List[_Claim]] = {}  # sender: cls -> claims
        self._leases: Dict[int, RegionLease] = {}   # receiver: id -> lease
        self._req_lease: Dict[int, int] = {}        # receiver: req -> lease
        self._pregrants_out: Dict[int, int] = {}    # receiver: cls -> count
        self._windows: Dict[Tuple[str, str], _pair.Window] = {}
        self._window_order: List[Tuple[str, str]] = []
        #: transfers sent, received, fallen back to the framed path, offers
        #: this side refused, control ops this side framed, and control ops
        #: it posted into the peer's descriptor ring
        self._counts = {"sent": 0, "received": 0, "fallbacks": 0,
                        "refused": 0, "ctrl_frames": 0, "ctrl_posts": 0}
        self._ftag = _flight.tag_for("rdv:" + name)

    def _count(self, key: str) -> None:
        with self._lock:
            self._counts[key] += 1

    # -- negotiation ---------------------------------------------------------

    def on_peer_hello(self, payload: bytes = b"") -> None:
        """The peer speaks the rendezvous control frames."""
        self.negotiated = True

    def _ctrl_send(self, op: int, stream_id: int, payload: bytes,
                   ring_ok: bool = True) -> None:
        """Send one control op: into the peer's descriptor ring when the
        link armed one (no frame, no wakeup), else framed through the
        coalescer. A ring that is full, closed or too small for the payload
        degrades to the framed path, never a lost op; framed-path transport
        errors propagate.

        ``ring_ok=False`` pins the op to the framed path: a COMPLETE whose
        payload went through an asynchronous landing domain (tcp_window
        records: no host-addressable view) is ordered after the payload
        only by the record stream the framed connection shares; a
        ring-posted COMPLETE could overtake the bytes."""
        post = self.ctrl_post
        if post is not None and ring_ok:
            try:
                if _transport.dispatch("post", self, post, op, stream_id,
                                       payload):
                    self._count("ctrl_posts")
                    return
            except Exception:
                pass  # ring tearing down: the framed path still works
        t0 = time.monotonic_ns()
        _transport.dispatch("frame", self, self._coalescer.send, op,
                            stream_id, payload, wait=op == OP_COMPLETE)
        self._count("ctrl_frames")
        _RDV_CTRL_FRAMES.inc()
        n = len(payload)
        dt = time.monotonic_ns() - t0
        _LENS_CTRL_BYTES.inc(n)
        _LENS_CTRL_NS.inc(dt)

    # -- sender role ---------------------------------------------------------

    def eligible(self, total: int, flags_compressed: bool = False) -> bool:
        return (self.negotiated and not self.closed and enabled()
                and not flags_compressed
                and total >= min_bytes() and total <= _MAX_TRANSFER
                and threading.get_ident() != self.disallowed_thread)

    def send_message(self, stream_id: int, flags: int,
                     segs: Sequence, total: int) -> bool:
        """Move one whole MESSAGE payload by rendezvous. True when the
        payload was placed and COMPLETE sent (the framed path must not send
        it too); False to frame it instead — refused claim, timeout, write
        failure."""
        cls = size_class(total)
        claim = self._take_grant(cls, total)
        if claim is None and self._has_standing(cls, total):
            # every standing region's doorbell is behind: the consumer is
            # still reading. A short yield-poll of the doorbells (draining
            # our descriptor ring for standing-grant top-ups as we go)
            # almost always turns one up, cheaper than a claim round trip.
            deadline = time.monotonic() + 0.002
            drain = self.ctrl_drain
            while claim is None and time.monotonic() < deadline:
                if drain is not None:
                    try:
                        drain()
                    except Exception:
                        drain = None
                time.sleep(0)
                claim = self._take_grant(cls, total)
        if claim is None:
            claim = self.rdv_claim(stream_id, total, cls)
        if claim is None:
            self._count("fallbacks")
            _RDV_FALLBACK.inc()
            return False
        try:
            self._rdv_write(claim, segs, total)
        except BaseException:
            self._drop_grant(claim)
            self.rdv_release(claim)
            self._count("fallbacks")
            _RDV_FALLBACK.inc()
            return False
        self.rdv_complete(claim, stream_id, flags, total)
        self._count("sent")
        _RDV_SENT.inc()
        return True

    def _take_grant(self, cls: int, total: int) -> Optional[_Claim]:
        """A usable cached grant: a one-shot claim is consumed; a standing
        claim is taken (``inflight``) only when its doorbell shows every
        earlier delivery's aliases dead."""
        with self._lock:
            if self.closed:
                return None
            bucket = list(self._grants.get(cls) or ())
        for claim in bucket:
            if claim.capacity < total:
                continue
            if not claim.standing:
                with self._lock:
                    b = self._grants.get(cls)
                    if b is not None and claim in b:
                        b.remove(claim)
                        return claim
                continue
            with self._lock:
                if claim.inflight:
                    continue
                claim.inflight = True
            if self._standing_free(claim):
                return claim
            with self._lock:
                claim.inflight = False
        return None

    def _has_standing(self, cls: int, total: int) -> bool:
        """Any standing grant big enough, busy or not: a freed doorbell is
        worth a moment's wait."""
        with self._lock:
            bucket = self._grants.get(cls) or ()
            return any(c.standing and c.capacity >= total for c in bucket)

    def _standing_free(self, claim: _Claim) -> bool:
        """Has the receiver's consumer freed every earlier use? Read from the
        doorbell word through the sender's window, with no control frame."""
        try:
            win = self._window_for(claim)
        except Exception:
            return False
        view = win.view
        if view is None:
            return False
        db = claim.offset + claim.capacity + _NONCE_BYTES
        try:
            (freed,) = _DOORBELL.unpack_from(view, db)
        except (ValueError, struct.error):
            return False
        return freed == claim.used

    def _drop_grant(self, claim: _Claim) -> None:
        """Forget a cached grant after a failed write: its region is being
        released and must not be reused."""
        with self._lock:
            claim.inflight = False
            b = self._grants.get(size_class(claim.capacity))
            if b is not None and claim in b:
                b.remove(claim)

    def rdv_claim(self, stream_id: int, total: int,
                  cls: int) -> Optional[_Claim]:
        """OFFER the transfer and wait (pumping where the transport needs
        it) for the peer's CLAIM. None when it is refused or times out; a
        timed-out offer is abandoned with a RELEASE so that a claim crossing
        it frees its region."""
        req = next(self._req_ids)
        st = {"claim": _SENTINEL_PENDING}
        with self._lock:
            if self.closed:
                return None
            self._reqs[req] = st
        _flight.emit(_flight.RDV_OFFER, self._ftag, req, total)
        try:
            self._ctrl_send(OP_OFFER, stream_id,
                            _pack_offer(req, total, self._open_kinds))
        except Exception:
            with self._lock:
                self._reqs.pop(req, None)
            return None
        deadline = time.monotonic() + _claim_timeout()

        def pred() -> bool:
            return st["claim"] is not _SENTINEL_PENDING or self.closed

        if self._pump is not None:
            self._pump(pred, deadline)
        else:
            with self._cond:
                while not pred():
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        break
                    self._cond.wait(remain)
        with self._lock:
            self._reqs.pop(req, None)
            claim = st["claim"]
        if claim is _SENTINEL_PENDING:
            # timed out: a claim crossing this release finds no request and
            # is handed back by on_claim
            _flight.emit(_flight.RDV_RELEASE, self._ftag, 0, req)
            try:
                self._ctrl_send(OP_RELEASE, 0, _RELEASE.pack(0, req))
            except Exception:
                pass
            return None
        if claim is _SENTINEL_REFUSED or claim is None:
            return None
        _flight.emit(_flight.RDV_CLAIM, self._ftag, req, claim.lease_id)
        return claim

    def _window_for(self, claim: _Claim) -> _pair.Window:
        key = (claim.kind, claim.handle)
        win = self._windows.get(key)
        if win is not None:
            return win
        win = window_share().acquire(
            claim.kind, claim.handle,
            claim.offset + claim.capacity + _NONCE_BYTES + _DOORBELL.size)
        extra = None
        evict_key = None
        evict_win = None
        with self._lock:
            prev = self._windows.get(key)
            if prev is not None:
                extra, win = win, prev  # raced a sibling sender thread
            else:
                self._windows[key] = win
                self._window_order.append(key)
                if len(self._window_order) > _WINDOW_CACHE:
                    evict_key = self._window_order.pop(0)
                    evict_win = self._windows.pop(evict_key, None)
        if extra is not None:
            window_share().release(claim.kind, claim.handle, extra)
        if evict_win is not None:
            window_share().release(evict_key[0], evict_key[1], evict_win)
        return win

    def _rdv_write(self, claim: _Claim, segs: Sequence, total: int) -> None:
        """The placement: every gather segment lands in the claimed region
        with one copy; no staging join, no landing copy on the other side.
        Into a mapped window the copy is ``numpy.copyto``, which lets go of
        the GIL: a 4 MiB memoryview copy holds it for milliseconds, while
        the receiver's handler in the same process waits to run."""
        t0 = time.monotonic_ns()
        win = self._window_for(claim)
        view = win.view
        if view is not None and claim.nonce and bytes(
                view[claim.offset + claim.capacity:
                     claim.offset + claim.capacity + _NONCE_BYTES]
        ) != claim.nonce:
            raise OSError("rendezvous region nonce mismatch: the claimed "
                          "handle resolves to different memory on this host")

        def _place() -> None:
            off = claim.offset
            for seg in segs:
                sv = memoryview(seg).cast("B")
                if view is not None:
                    np.copyto(np.frombuffer(view, np.uint8, len(sv), off),
                              np.frombuffer(sv, np.uint8))
                else:
                    win.write(off, sv)
                off += len(sv)

        _transport.dispatch("write", self, _place)
        _ledger.rdma_write(total)
        dt = time.monotonic_ns() - t0
        _LENS_RDV_NS.inc(dt)
        _LENS_RDV_BYTES.inc(total)
        _LENS_RDV_COPY.inc(total)

    def rdv_complete(self, claim: _Claim, stream_id: int, flags: int,
                     total: int) -> None:
        if not claim.standing:
            # solicited transfers are edges; standing-region reuse is
            # steady traffic and stays silent
            _flight.emit(_flight.RDV_WRITE, self._ftag, claim.lease_id,
                         total)
            _flight.emit(_flight.RDV_COMPLETE, self._ftag, claim.lease_id,
                         total)
        with self._lock:
            claim.used += 1
            claim.inflight = False
            # a write into a mapped view (shm, local) is visible the moment
            # it returns, so its COMPLETE may ride the ring; an asynchronous
            # domain's bytes are still on the record stream, and only the
            # framed path orders the COMPLETE after them
            win = self._windows.get((claim.kind, claim.handle))
        sync_write = win is not None and win.view is not None
        self._ctrl_send(OP_COMPLETE, stream_id,
                        _COMPLETE.pack(claim.lease_id, total, flags & 0xFF),
                        ring_ok=sync_write)

    def rdv_release(self, claim: _Claim) -> None:
        """Abandon a claimed region without completing: the peer frees it."""
        _flight.emit(_flight.RDV_RELEASE, self._ftag, claim.lease_id, 0)
        try:
            self._ctrl_send(OP_RELEASE, 0, _RELEASE.pack(claim.lease_id, 0))
        except Exception:
            pass

    # -- receiver role -------------------------------------------------------

    def on_op(self, op: int, stream_id: int, payload) -> None:
        """Dispatch one control frame (from the connection's reader). Never
        raises: a malformed control message degrades to a refused or
        ignored transfer, not a dead connection."""
        try:
            if op == OP_OFFER:
                self.on_offer(stream_id, payload)
            elif op == OP_CLAIM:
                self.on_claim(payload)
            elif op == OP_COMPLETE:
                self.on_complete(stream_id, payload)
            elif op == OP_RELEASE:
                self.on_release(payload)
        except Exception:
            trace_endpoint.log("rendezvous control op %d failed", op)

    def on_offer(self, stream_id: int, payload) -> None:
        req, nbytes, kinds = _unpack_offer(payload)
        _flight.emit(_flight.RDV_OFFER, self._ftag, req, nbytes)
        lease = self._lease_for(nbytes, kinds)
        if lease is None:
            self._count("refused")
            _RDV_REFUSED.inc()
            self._ctrl_send(OP_CLAIM, stream_id, _pack_claim(req, None))
            return
        with self._lock:
            if self.closed:
                lease.release()
                return
            self._leases[lease.lease_id] = lease
            self._req_lease[req] = lease.lease_id
        _flight.emit(_flight.RDV_CLAIM, self._ftag, req, lease.lease_id)
        self._ctrl_send(OP_CLAIM, stream_id, _pack_claim(req, lease))

    def _lease_for(self, nbytes: int, kinds: Sequence[str]
                   ) -> Optional[RegionLease]:
        if not enabled() or nbytes > _MAX_TRANSFER:
            return None
        limit = self.recv_limit
        if limit is not None and limit >= 0 and nbytes > limit:
            return None  # refused: framed, then RESOURCE_EXHAUSTED there
        for kind in self._pool_kinds:
            if kind not in kinds:
                continue
            try:
                # ownership passes by return: the caller registers the lease
                # in _leases, and every death path releases it there
                lease = landing_pool(kind).lease(  # tpr: allow(ringpool)
                    nbytes, next(self._lease_ids))
            except Exception:
                continue
            if lease is not None:
                return lease
        return None

    def on_claim(self, payload) -> None:
        req, claim = _unpack_claim(payload)
        if req == 0:
            # unsolicited pre-grant: cache it for the next send of its class
            if claim is not None:
                with self._lock:
                    if not self.closed:
                        self._grants.setdefault(claim.capacity,
                                                []).append(claim)
            return
        with self._lock:
            st = self._reqs.get(req)
            if st is not None:
                st["claim"] = claim if claim is not None \
                    else _SENTINEL_REFUSED
                self._cond.notify_all()
                return
        # the sender already gave up on this request: hand the region back
        if claim is not None:
            try:
                self._ctrl_send(OP_RELEASE, 0,
                                _RELEASE.pack(claim.lease_id, 0))
            except Exception:
                pass

    def on_complete(self, stream_id: int, payload) -> None:
        lease_id, nbytes, flags = _COMPLETE.unpack(bytes(payload))
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is not None and not lease.standing:
                # a one-shot lease is consumed by its completion; standing
                # leases stay claimed for reuse on the doorbell
                del self._leases[lease_id]
                for r, lid in list(self._req_lease.items()):
                    if lid == lease_id:
                        del self._req_lease[r]
        if lease is None:
            return  # already released (crossed a release): drop
        if not lease.pregrant:
            _flight.emit(_flight.RDV_COMPLETE, self._ftag, lease_id, nbytes)
        try:
            wrapper = lease.deliver(nbytes)
        except Exception:
            # protocol violation (oversized complete, reuse while aliased):
            # drop the region, so a confused sender never lands in it again
            with self._lock:
                self._leases.pop(lease_id, None)
                if lease.pregrant:
                    self._pregrants_out[lease.cls] = max(
                        0, self._pregrants_out.get(lease.cls, 1) - 1)
            lease.release(discard=True)
            return
        self._count("received")
        _RDV_RECV.inc()
        cls, kind = lease.cls, lease.kind
        self._deliver(stream_id, flags, wrapper)
        self._maybe_pregrant(cls, kind)

    def _maybe_pregrant(self, cls: int, kind: str) -> None:
        """Keep standing regions granted for the classes the peer streams,
        topped up to ``_PREGRANT_DEPTH``: a standing grant costs one claim
        frame ever, so a steady transfer carries one control frame (its
        COMPLETE) and no claim round trip."""
        while True:
            with self._lock:
                if (self.closed or self._pregrants_out.get(
                        cls, 0) >= _PREGRANT_DEPTH):
                    return
            try:
                lease = landing_pool(kind).lease(cls, next(self._lease_ids))
            except Exception:
                return
            if lease is None:
                return
            lease.pregrant = True
            lease.standing = True
            with self._lock:
                if self.closed:
                    lease.release()
                    return
                self._leases[lease.lease_id] = lease
                self._pregrants_out[cls] = self._pregrants_out.get(cls,
                                                                   0) + 1
            try:
                self._ctrl_send(OP_CLAIM, 0, _pack_claim(0, lease))
            except Exception:
                with self._lock:
                    self._leases.pop(lease.lease_id, None)
                    self._pregrants_out[cls] = max(
                        0, self._pregrants_out.get(cls, 1) - 1)
                lease.release()
                return

    def on_release(self, payload) -> None:
        lease_id, req = _RELEASE.unpack(bytes(payload))
        with self._lock:
            if not lease_id and req:
                lease_id = self._req_lease.pop(req, 0)
            lease = self._leases.pop(lease_id, None)
            if lease is not None and lease.pregrant:
                self._pregrants_out[lease.cls] = max(
                    0, self._pregrants_out.get(lease.cls, 1) - 1)
        if lease is not None:
            _flight.emit(_flight.RDV_RELEASE, self._ftag, lease_id, req)
            lease.release()

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Connection teardown or peer death: every claimed region is
        destroyed (a straggling write must hit orphaned memory), and every
        waiting sender wakes to fall back or fail with the transport."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            leases = list(self._leases.values())
            self._leases.clear()
            self._req_lease.clear()
            self._pregrants_out.clear()
            self._grants.clear()
            windows = list(self._windows.items())
            self._windows.clear()
            self._window_order = []
            self._cond.notify_all()
        for lease in leases:
            # teardown is an edge: every claimed region's release is
            # recorded, standing grants included
            _flight.emit(_flight.RDV_RELEASE, self._ftag,
                         lease.lease_id, 0)
            lease.release(discard=True)
        for (kind, handle), win in windows:
            window_share().release(kind, handle, win)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "negotiated": int(self.negotiated),
                "claimed_leases": len(self._leases),
                "cached_grants": sum(len(v) for v in
                                     self._grants.values()),
                **self._counts,
            }


# ---------------------------------------------------------------------------
# Block-granular standing grants.
# ---------------------------------------------------------------------------

_GRANT_HDR = struct.Struct("<QIIQQ16s")  # grant_id, block_bytes, n_offsets,
#                                          window_bytes, nonce_off, nonce


class BlockGrant:
    """A peer-advertised landing descriptor at block granularity: which
    blocks of which registered region the sender may write, plus the
    anti-mixup nonce stored at ``nonce_off`` inside the region (the writer
    checks it through its window before placing a byte). The wire form is
    byte-equal to the reference's."""

    __slots__ = ("grant_id", "kind", "handle", "block_bytes", "offsets",
                 "window_bytes", "nonce", "nonce_off")

    def __init__(self, grant_id: int, kind: str, handle: str,
                 block_bytes: int, offsets: Sequence[int],
                 window_bytes: int, nonce: bytes, nonce_off: int):
        self.grant_id = int(grant_id)
        self.kind = kind
        self.handle = handle
        self.block_bytes = int(block_bytes)
        self.offsets = tuple(int(o) for o in offsets)
        self.window_bytes = int(window_bytes)
        self.nonce = bytes(nonce)
        self.nonce_off = int(nonce_off)

    @property
    def capacity(self) -> int:
        return self.block_bytes * len(self.offsets)

    def to_wire(self) -> bytes:
        kb = self.kind.encode()
        return (_GRANT_HDR.pack(self.grant_id, self.block_bytes,
                                len(self.offsets), self.window_bytes,
                                self.nonce_off, self.nonce)
                + bytes([len(kb)]) + kb + self.handle.encode()
                + b"\x00" + b"".join(struct.pack("<Q", o)
                                     for o in self.offsets))

    @classmethod
    def from_wire(cls, payload) -> "BlockGrant":
        buf = bytes(payload)
        (grant_id, block_bytes, n, window_bytes, nonce_off,
         nonce) = _GRANT_HDR.unpack_from(buf)
        pos = _GRANT_HDR.size
        klen = buf[pos]
        pos += 1
        kind = buf[pos:pos + klen].decode()
        pos += klen
        end = buf.index(b"\x00", pos)
        handle = buf[pos:end].decode()
        pos = end + 1
        offsets = struct.unpack_from(f"<{n}Q", buf, pos)
        return cls(grant_id, kind, handle, block_bytes, offsets,
                   window_bytes, nonce, nonce_off)


class GrantWriter:
    """The sender half of block grants: opens (and keeps) one window per
    ``(kind, handle)`` through the shared window cache, checks the grant's
    nonce, then places each chunk with a one-sided write. The bytes are
    billed to the ledger's ``rdma_write``, as the bulk path's are."""

    def __init__(self):
        self._windows: Dict[Tuple[str, str], _pair.Window] = {}
        self._lock = threading.Lock()

    def _window(self, grant: BlockGrant) -> _pair.Window:
        key = (grant.kind, grant.handle)
        win = self._windows.get(key)
        if win is not None:
            return win
        win = window_share().acquire(grant.kind, grant.handle,
                                     grant.window_bytes)
        extra = None
        with self._lock:
            prev = self._windows.get(key)
            if prev is not None:
                extra, win = win, prev
            else:
                self._windows[key] = win
        if extra is not None:
            window_share().release(grant.kind, grant.handle, extra)
        return win

    def write_blocks(self, grant: BlockGrant, chunks: Sequence) -> int:
        """Place ``chunks[i]`` (bytes-like, at most ``block_bytes``) at
        ``grant.offsets[i]``; returns the bytes written. Raises on a nonce
        mismatch or an oversized chunk."""
        if len(chunks) > len(grant.offsets):
            raise ValueError(f"{len(chunks)} chunks for a "
                             f"{len(grant.offsets)}-block grant")
        win = self._window(grant)
        view = win.view
        if grant.nonce and view is not None:
            seen = bytes(view[grant.nonce_off:
                              grant.nonce_off + len(grant.nonce)])
            if seen != grant.nonce:
                raise OSError(
                    "block-grant nonce mismatch: the granted handle "
                    "resolves to different memory on this host")
        t0 = time.monotonic_ns()
        total = 0
        placed = []
        for off, chunk in zip(grant.offsets, chunks):
            sv = memoryview(chunk).cast("B")
            if len(sv) > grant.block_bytes:
                raise ValueError(f"chunk of {len(sv)} exceeds the "
                                 f"{grant.block_bytes}-byte block")
            placed.append((off, sv))
            total += len(sv)

        def _place() -> None:
            for off, sv in placed:
                if view is not None:
                    view[off:off + len(sv)] = sv
                else:
                    win.write(off, sv)

        _transport.dispatch("write", self, _place)
        _ledger.rdma_write(total)
        dt = time.monotonic_ns() - t0
        _LENS_RDV_NS.inc(dt)
        _LENS_RDV_BYTES.inc(total)
        _LENS_RDV_COPY.inc(total)
        return total

    def close(self) -> None:
        with self._lock:
            windows = list(self._windows.items())
            self._windows.clear()
        for (kind, handle), win in windows:
            window_share().release(kind, handle, win)


def domains_for_endpoint(endpoint) -> Tuple[Tuple[str, ...],
                                            Tuple[str, ...]]:
    """``(pool_kinds, open_kinds)`` of a connection over ``endpoint``.

    A ring endpoint prefers its pair's own domain (the memory the
    connection already trusts; for ``tcp_window`` the shared ordered record
    stream also sequences the COMPLETE after the payload); anything else
    (plain TCP) uses the shm pool. ``open_kinds`` is what this side's sender can open windows into;
    the receiver picks a pool kind from the offer's list."""
    pair = getattr(endpoint, "pair", None)
    pool: List[str] = []
    if pair is not None:
        kind = pair.domain.kind
        if kind in ("shm", "local", "tcp_window"):
            pool.append(kind)
    if "shm" not in pool:
        pool.append("shm")
    open_kinds = list(dict.fromkeys(pool + ["shm", "local"]))
    return tuple(pool), tuple(open_kinds)


def link_for_endpoint(endpoint, name: str,
                      send_op: Callable[[int, int, bytes], None],
                      deliver: Callable[[int, int, object], None],
                      pump: Optional[Callable] = None,
                      send_ops: Optional[Callable] = None
                      ) -> Optional[RdvLink]:
    """An armed, not yet negotiated link for a new framed connection, or
    None when rendezvous is off. ``send_ops(list_of_(op, sid, payload))``
    is the multi-frame control send the coalescer flushes bursts through
    (the native framing only); ``pump`` is the connection's inline-pump
    wait (pump-mode connections)."""
    if not enabled():
        return None
    pool_kinds, open_kinds = domains_for_endpoint(endpoint)
    return RdvLink(name, send_op, deliver, pool_kinds=pool_kinds,
                   open_kinds=open_kinds, pump=pump, send_ops=send_ops)
