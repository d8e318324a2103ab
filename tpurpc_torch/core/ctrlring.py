"""Shared-memory descriptor rings for the rendezvous control plane.

A copy of ``tpurpc/core/ctrlring.py``, with its observability hooks under
the reference's names: the ``ctrl`` lens hop, the ``ctrl-ring`` profiler
stage, the ``ctrl_ring_posts``, ``_records``, ``_kicks`` and
``_full_fallbacks`` counters, the ``ctrl_ring_backlog`` fleet gauge (the
watchdog's ``ctrl-ring`` evidence), the ``ctrl_ring_batch`` histogram and
the ``CTRL_STALL_*``, ``CTRL_ADOPT``, ``CTRL_SPIN`` and ``CTRL_PARK`` flight
edges under ``ctrl:<name>``. The rendezvous plane moves bulk payloads
one-sided, and what is left per message is control: OFFER, CLAIM, COMPLETE,
RELEASE. Framed, each is a frame encode, a notify and a wakeup of the other
side's reader. Here the control plane rides polled descriptor rings: per
connection and direction one ring carved from the same shared-memory domain
as the landing pool, so a steady-state bulk transfer costs one one-sided
payload write plus one 128-byte slot store per message, with no frame.

Layout: one ring per direction, owned by its CONSUMER (the side that reads
it allocates it and advertises it in the rendezvous hello; the producer
opens a window onto it):

    header (64 B): magic, version, nslots, slot_bytes,
                   cons_head (u64: consumed count, published by the
                   consumer once per drained batch: the doorbell),
                   parked (u32: the consumer is blocked), nonce (16 B)
    slots  (nslots × slot_bytes): seq-stamped records
        [stamp u64][frame_seq u64][stream_id u32][len u16][op u8][flags u8]
        [payload ≤ slot_bytes-24]

Protocol:

* the producer writes a slot's payload and fields FIRST and the ``stamp``
  (seq+1) LAST: a reader that observes the stamp observes a whole record;
* a slot is reused only after the consumer's published ``cons_head``
  covers its previous lap (``seq - cons_head < nslots`` before any store);
  a full ring falls back to the framed control path, never overwrites;
* lost-wakeup close: the producer stores the stamp, THEN reads ``parked``
  and sends one framed ``CTRL_KICK`` when set; the consumer sets
  ``parked``, THEN re-drains once before blocking. Either order of the
  race delivers.

Ordering with the framed path: every record carries ``frame_seq``, the
count of frames its sender had committed when posting, and the consumer
processes a record only once it has dispatched that many frames. A control
op posted after a framed MESSAGE on the same stream lands after it, and
vice versa (the consumer drains the ring before dispatching each frame).

Negotiation rides the rendezvous hello: each side appends its receive
ring's descriptor to the hello payload. Peers that do not advertise one
(the h2 planes, a disabled side), domains that are not host-addressable
and handles that resolve to other memory (nonce mismatch) keep the framed
control path, and every ring failure (full, closed, oversized payload)
degrades to a framed send, never a lost op.

Env knobs: ``TPURPC_CTRL_RING`` (default on), ``TPURPC_CTRL_RING_SLOTS``
(default 64, at least 8).
"""

from __future__ import annotations

import os
import struct
import time
from typing import Callable, Dict, Optional

from tpurpc_torch.analysis.locks import make_lock
from tpurpc_torch.core import pair as _pair
from tpurpc_torch.core import transport as _transport
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import lens as _lens
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.utils import stats as _stats

# a thread polling, draining or posting descriptor rings does control-plane
# work: the `ctrl` hop carries its bytes, these markers its CPU
_LENS_STAGES = {
    "read_frame_polled": "ctrl-ring",
    "drain": "ctrl-ring",
    "post": "ctrl-ring",
}
_profiler.register_stages(__file__, _LENS_STAGES)

__all__ = [
    "CtrlRing", "CtrlPeer", "CtrlPlane", "enabled", "read_frame_polled",
    "TEST_HOOKS", "SLOT_BYTES", "MAX_CTRL_PAYLOAD",
]

# control-plane work (ring posts and drains, and framed control sends) is
# its own lens hop
_LENS_CTRL_BYTES, _LENS_CTRL_NS, _LENS_CTRL_COPY = _lens.hop_counters("ctrl")

_POSTS = _metrics.counter("ctrl_ring_posts")
_RECORDS = _metrics.counter("ctrl_ring_records")
_KICKS = _metrics.counter("ctrl_ring_kicks")
_FULL = _metrics.counter("ctrl_ring_full_fallbacks")

#: scrape-time truth for the watchdog's `ctrl-ring` stage: records posted
#: into peers' rings that their consumers have not yet drained
_BACKLOG = _metrics.fleet("ctrl_ring_backlog", lambda p: p.backlog())

#: test seam: ``freeze_drain`` makes every consumer's drain a no-op, so
#: posted records age in the ring
TEST_HOOKS: Dict[str, object] = {}

_MAGIC = 0x54504352  # 'TPCR'
_VERSION = 1
SLOT_BYTES = 128
_NONCE_BYTES = 16

#: header: magic, version, nslots, slot_bytes, cons_head, parked, pad, nonce
_HDR = struct.Struct("<IIIIQII16s")
_HDR_BYTES = 64
_CONS_HEAD = struct.Struct("<Q")
_CONS_HEAD_OFF = 16
_PARKED = struct.Struct("<I")
_PARKED_OFF = 24
_NONCE_OFF = 32

#: slot record header; the stamp (first u64) is stored SEPARATELY, last
_SLOT_HDR = struct.Struct("<QQIHBB")
_SLOT_HDR_BYTES = _SLOT_HDR.size  # 24
_STAMP = struct.Struct("<Q")
MAX_CTRL_PAYLOAD = SLOT_BYTES - _SLOT_HDR_BYTES

#: hello-blob framing: u16 length prefix + descriptor
_BLOB_LEN = struct.Struct("<H")
_DESC = struct.Struct("<IIQ16sB")  # nslots, slot_bytes, nbytes, nonce, klen


def enabled() -> bool:
    return os.environ.get("TPURPC_CTRL_RING", "1").lower() not in (
        "0", "off", "false")


def _default_slots() -> int:
    try:
        return max(8, int(os.environ.get("TPURPC_CTRL_RING_SLOTS", "64")))
    except ValueError:
        return 64


class CtrlRing:
    """The consumer-owned half: allocates the shm region, drains records,
    publishes ``cons_head`` once per batch, owns the ``parked`` word."""

    #: lint rule `lock`: the drain cursor and closed flag are shared
    #: between whichever thread holds the drain lock and the close path
    _GUARDED_BY = {"head": "_lock", "closed": "_lock"}

    def __init__(self, kind: str = "shm", nslots: Optional[int] = None):
        self.kind = kind
        self.nslots = nslots or _default_slots()
        self.slot_bytes = SLOT_BYTES
        self.nonce = os.urandom(_NONCE_BYTES)
        self._domain = _pair.make_domain(kind)
        self.nbytes = _HDR_BYTES + self.nslots * self.slot_bytes
        self.region = self._domain.alloc(self.nbytes)
        self.head = 0          # consumed count (local truth)
        self._published = 0    # last cons_head stored into the header
        self.closed = False
        self._lock = make_lock("CtrlRing._lock")
        _HDR.pack_into(self.region.buf, 0, _MAGIC, _VERSION, self.nslots,
                       self.slot_bytes, 0,
                       1,  # parked: nobody polls until a reader adopts us
                       0, self.nonce)

    def descriptor(self) -> bytes:
        """The hello-blob descriptor the producer opens a window with."""
        kb = self.kind.encode()
        return (_DESC.pack(self.nslots, self.slot_bytes, self.nbytes,
                           self.nonce, len(kb))
                + kb + self.region.handle.encode())

    # -- consumer side --------------------------------------------------------

    def set_parked(self, parked: bool) -> None:
        with self._lock:
            if self.closed:
                return
            _PARKED.pack_into(self.region.buf, _PARKED_OFF,
                              1 if parked else 0)

    def drain(self, on_op: Callable[[int, int, object], None],
              frames_dispatched: Callable[[], int],
              wait: bool = False) -> int:
        """Consume every ready record in ONE pass (the batched-completion
        fast path: the Python consumer observes completed batches, one
        ``cons_head`` publish per batch).  A record whose ``frame_seq``
        outruns the dispatched-frame count is left in place — the frames it
        must order after are still in flight.  Concurrent drainers skip
        (try-lock): records dispatch in slot order, exactly once.

        ``wait=True`` (the connection's reader, right before it dispatches
        a frame) waits out a concurrent drainer instead of skipping: a
        record that drainer took must be delivered before the reader's
        frame, or a COMPLETE could land after its stream's TRAILERS closed
        the stream. A sender thread's drain keeps the try-lock (the
        reference's only mode)."""
        if TEST_HOOKS.get("freeze_drain"):
            return 0
        if not self._lock.acquire(blocking=wait):
            return 0
        try:
            if self.closed:
                return 0
            buf = self.region.buf
            n = 0
            t0 = time.monotonic_ns()
            nbytes = 0
            while True:
                slot = _HDR_BYTES + (self.head % self.nslots) \
                    * self.slot_bytes
                (stamp,) = _STAMP.unpack_from(buf, slot)
                if stamp != self.head + 1:
                    break
                (_stamp, frame_seq, stream_id, ln, op,
                 _flags) = _SLOT_HDR.unpack_from(buf, slot)
                if frame_seq > frames_dispatched():
                    break  # ordered after frames still in flight
                payload = bytes(buf[slot + _SLOT_HDR_BYTES:
                                    slot + _SLOT_HDR_BYTES + ln])
                # _lock IS held — acquired nonblocking above (the lint's
                # with-statement pattern can't see a try-acquire/finally)
                self.head += 1  # tpr: allow(lock)
                n += 1
                nbytes += ln
                on_op(op, stream_id, payload)
            if n:
                # one doorbell store per drained batch — the consumer-done
                # gate the producer's full-check reads through its window
                _CONS_HEAD.pack_into(buf, _CONS_HEAD_OFF, self.head)
                self._published = self.head
                _RECORDS.inc(n)
                dt = time.monotonic_ns() - t0
                _LENS_CTRL_BYTES.inc(nbytes)
                _LENS_CTRL_NS.inc(dt)
                _stats.batch_hist("ctrl_ring_batch").record(n)
            return n
        finally:
            self._lock.release()

    def close(self) -> None:
        """Link death/teardown.  The region is released on OUR side only —
        a straggling producer still holds its window and may land a late
        slot store, which hits the orphaned mapping (dead memory), never a
        ring re-advertised to a new link: rings are per-connection and
        never pooled (Pair.init's stale-write rule)."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
        try:
            _pair.retry_buffer_op(self.region.buf.release, timeout_s=0.5)
            self.region._close()
        except Exception:
            pass  # the OS reclaims the mapping with the process


class CtrlPeer:
    """The producer half: a window onto the peer's receive ring.  ``post``
    returns 0 (not posted — framed fallback), 1 (posted) or 2 (posted AND
    the consumer is parked — send one framed kick)."""

    _GUARDED_BY = {"seq": "_lock", "closed": "_lock", "_stalled": "_lock"}

    def __init__(self, kind: str, handle: str, nslots: int, slot_bytes: int,
                 nbytes: int, nonce: bytes, ftag: int = 0):
        if slot_bytes != SLOT_BYTES:
            raise ValueError(f"peer ring slot_bytes {slot_bytes} != "
                             f"{SLOT_BYTES}")
        domain = _pair.make_domain(kind)
        self._win = domain.open_window(handle, nbytes)
        view = self._win.view
        if view is None:
            self._win.close()
            raise OSError("ctrl ring needs a host-addressable window "
                          f"(domain {kind!r} has none)")
        (magic, version, r_nslots, r_slot_bytes, _head, _parked, _pad,
         r_nonce) = _HDR.unpack_from(view, 0)
        if (magic != _MAGIC or version != _VERSION or r_nslots != nslots
                or r_slot_bytes != slot_bytes or r_nonce != nonce):
            self._win.close()
            raise OSError("ctrl ring descriptor mismatch: the advertised "
                          "handle resolves to different memory on this "
                          "host")
        self.view = view
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        self.seq = 0        # next record index (stamp = seq+1)
        self.closed = False
        self._stalled = False  # ring-full edge (a flight stall bracket)
        self._ftag = ftag
        self._lock = make_lock("CtrlPeer._lock")
        _BACKLOG.track(self)

    def backlog(self) -> int:
        """Records posted but not yet consumed by the peer (the fleet
        gauge the watchdog's `ctrl-ring` stage reads)."""
        if self.closed:
            return 0
        try:
            (head,) = _CONS_HEAD.unpack_from(self.view, _CONS_HEAD_OFF)
        except (ValueError, struct.error):
            return 0
        return max(0, self.seq - head)

    def post(self, op: int, stream_id: int, payload: bytes,
             frame_seq: int) -> int:
        if len(payload) > MAX_CTRL_PAYLOAD:
            return 0
        with self._lock:
            if self.closed:
                return 0
            view = self.view
            try:
                (head,) = _CONS_HEAD.unpack_from(view, _CONS_HEAD_OFF)
            except (ValueError, struct.error):
                return 0
            if self.seq - head >= self.nslots:
                # ring full: degrade to the framed path (never overwrite an
                # unconsumed slot). The full -> not-full transition is a
                # flight stall bracket: aged open, it is the watchdog's
                # evidence that the consumer stopped draining
                if not self._stalled:
                    self._stalled = True
                    _flight.emit(_flight.CTRL_STALL_BEGIN, self._ftag,
                                 self.seq - head)
                _FULL.inc()
                return 0
            if self._stalled:
                self._stalled = False
                _flight.emit(_flight.CTRL_STALL_END, self._ftag, 0)
            slot = _HDR_BYTES + (self.seq % self.nslots) * self.slot_bytes
            # payload and fields FIRST ...
            view[slot + _SLOT_HDR_BYTES:
                 slot + _SLOT_HDR_BYTES + len(payload)] = payload
            _SLOT_HDR.pack_into(view, slot, 0, frame_seq, stream_id,
                                len(payload), op, 0)
            # ... the stamp LAST: a consumer that observes it observes a
            # whole record
            _STAMP.pack_into(view, slot, self.seq + 1)
            self.seq += 1
            _POSTS.inc()
            # parked is read strictly AFTER the stamp store: either the
            # consumer's park-then-redrain sees our record, or we see its
            # parked flag and kick — the lost-wakeup race has no third leg
            try:
                (parked,) = _PARKED.unpack_from(view, _PARKED_OFF)
            except (ValueError, struct.error):
                parked = 1
            return 2 if parked else 1

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
        try:
            self._win.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# The per-connection plane: rx + tx + the adaptive poll/park state.
# ---------------------------------------------------------------------------

#: consumer-side adaptive gate, the poller's activity-EWMA discipline
#: (core/poller.py) applied to ring polling: drains that find records are
#: hits, empty probes are misses; below the floor the consumer PARKS on the
#: framed path (fd wakeups) and the producer's kick re-heats it.
_EWMA_HIT = 0.5
_EWMA_MISS = 0.7
_EWMA_FLOOR = 0.1


class CtrlPlane:
    """One connection's descriptor-ring control plane: the locally owned
    receive ring (advertised in the hello), the window onto the peer's
    (opened from the peer's hello), and the consumer's hot/parked state.
    ``armed`` flips exactly once, when the peer's descriptor verifies —
    until then (and forever, for un-negotiated peers) every control op
    stays framed."""

    def __init__(self, name: str, kind: str = "shm"):
        self.name = name
        self._ftag = _flight.tag_for("ctrl:" + name)
        self.rx: Optional[CtrlRing] = None
        self.tx: Optional[CtrlPeer] = None
        self.armed = False
        self._ewma = 0.0       # cold start: parked until the first hit
        self._mode_hot = False
        self._closed = False
        try:
            self.rx = CtrlRing(kind=kind)
        except Exception:
            self.rx = None  # no shm on this host: framed control forever

    # -- negotiation ----------------------------------------------------------

    def hello_blob(self) -> bytes:
        """Appended to the rendezvous HELLO_PAYLOAD: this side's receive
        ring descriptor (empty when ring control is off/unavailable)."""
        if self.rx is None or not enabled():
            return b""
        desc = self.rx.descriptor()
        return _BLOB_LEN.pack(len(desc)) + desc

    def on_hello(self, blob: bytes) -> bool:
        """Parse the peer's descriptor and open the submission window.
        Any failure — empty blob (peer predates rings / disabled), a
        handle this host cannot open (cross-host TCP), a nonce mismatch —
        leaves the link framed.  Returns True on adoption."""
        if self.armed or self._closed or not blob or not enabled():
            return False
        try:
            (nslots, slot_bytes, nbytes, nonce,
             klen) = _DESC.unpack_from(blob, _BLOB_LEN.size)
            pos = _BLOB_LEN.size + _DESC.size
            kind = blob[pos:pos + klen].decode()
            handle = blob[pos + klen:].decode()
            self.tx = CtrlPeer(kind, handle, nslots, slot_bytes, nbytes,
                               nonce, ftag=self._ftag)
        except Exception:
            return False
        self.armed = True
        _flight.emit(_flight.CTRL_ADOPT, self._ftag, nslots, slot_bytes)
        return True

    # -- producer face --------------------------------------------------------

    def post(self, op: int, stream_id: int, payload: bytes, frame_seq: int,
             kick: Callable[[], None]) -> bool:
        """Post one control op to the peer's ring; True when placed (the
        framed path must NOT also send it).  A parked consumer gets one
        framed kick — the only frame a cold→hot transition costs."""
        tx = self.tx
        if tx is None or not self.armed:
            return False
        t0 = time.monotonic_ns()
        r = _transport.dispatch("post", self, tx.post, op, stream_id,
                                payload, frame_seq)
        if not r:
            return False
        n = len(payload)
        dt = time.monotonic_ns() - t0
        _LENS_CTRL_BYTES.inc(n)
        _LENS_CTRL_NS.inc(dt)
        if r == 2:
            _KICKS.inc()
            try:
                _transport.dispatch("kick", self, kick)
            except Exception:
                pass  # connection dying; the framed paths surface it
        return True

    # -- consumer face --------------------------------------------------------

    def drain(self, on_op: Callable[[int, int, object], None],
              frames_dispatched: Callable[[], int],
              wait: bool = False) -> int:
        rx = self.rx
        if rx is None:
            return 0
        n = rx.drain(on_op, frames_dispatched, wait)
        if n:
            self._ewma = self._ewma + _EWMA_HIT * (1.0 - self._ewma)
            if not self._mode_hot:
                self._mode_hot = True
                _flight.emit(_flight.CTRL_SPIN, self._ftag, rx.head)
        return n

    def note_miss(self) -> None:
        self._ewma *= _EWMA_MISS

    def hot(self) -> bool:
        return self._ewma >= _EWMA_FLOOR

    def park(self) -> None:
        """About to block on the framed path: raise the parked flag so the
        producer's next post kicks us.  The caller MUST re-drain once
        after this (the lost-wakeup close)."""
        rx = self.rx
        if rx is not None:
            rx.set_parked(True)
        if self._mode_hot:
            self._mode_hot = False
            _flight.emit(_flight.CTRL_PARK, self._ftag,
                         rx.head if rx is not None else 0)

    def unpark(self) -> None:
        rx = self.rx
        if rx is not None:
            rx.set_parked(False)

    def backlog(self) -> int:
        tx = self.tx
        return tx.backlog() if tx is not None else 0

    def close(self) -> None:
        self._closed = True
        self.armed = False
        tx, self.tx = self.tx, None
        if tx is not None:
            tx.close()
        rx, self.rx = self.rx, None
        if rx is not None:
            rx.close()


# ---------------------------------------------------------------------------
# The polled read loop shared by every connection reader/pump.
# ---------------------------------------------------------------------------

#: how long one framed-read probe blocks while the link is HOT — the upper
#: bound on ring-record latency while frames are idle, and the slice that
#: yields the core to the producer on a single-hart host
_HOT_SLICE_S = 0.0005
#: cheap scheduler-yield probes between drain attempts before paying a
#: framed-read slice: a producer mid-memcpy posts within a few yields
_YIELD_SPINS = 8


def read_frame_polled(read_frame, drain: Callable[[], int],
                      plane: CtrlPlane, timeout: Optional[float] = None,
                      should_stop: Optional[Callable[[], bool]] = None):
    """``read_frame`` with the descriptor-ring poll/park discipline.

    HOT (recent drains): alternate ring drains with scheduler yields and
    short framed-read slices — records are consumed in batches with no fd
    wakeups, frames still flow.  COLD (EWMA below floor): raise the parked
    flag, re-drain once, and block on the framed read — the producer's
    kick (or any frame) wakes us.  ``should_stop`` (inline-pump callers:
    "my predicate is satisfied") raises ReadTimeout so the pump re-checks.

    Returns whatever ``read_frame`` returns (Frame/CONSUMED/None); raises
    ReadTimeout past ``timeout``.
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        drained = drain()
        if should_stop is not None and should_stop():
            raise _pair_ReadTimeout()
        if drained or plane.hot():
            if not drained:
                spins = 0
                while spins < _YIELD_SPINS:
                    spins += 1
                    time.sleep(0)
                    if drain():
                        break
                    if should_stop is not None and should_stop():
                        raise _pair_ReadTimeout()
            slice_s = _HOT_SLICE_S
            if deadline is not None:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise _pair_ReadTimeout()
                slice_s = min(slice_s, remain)
            try:
                f = read_frame(timeout=slice_s)
            except TimeoutError:
                plane.note_miss()
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                continue
            # a record posted BEFORE this frame was sent is visible in shm
            # by store order — deliver it first, so per-stream order holds
            # across the ring/framed split
            drain()
            return f
        # cold: park on the framed path (fd wakeups); the mandatory
        # re-drain closes the park/post race — a record posted before our
        # flag store is found here, one posted after sees the flag and
        # kicks
        plane.park()
        try:
            if drain():
                plane.unpark()
                continue
            if should_stop is not None and should_stop():
                raise _pair_ReadTimeout()
            remain = (None if deadline is None
                      else max(0.0, deadline - time.monotonic()))
            f = read_frame(timeout=remain)
            drain()  # ring records posted before this frame deliver first
            return f
        finally:
            plane.unpark()


def _pair_ReadTimeout():
    from tpurpc_torch.core.endpoint import ReadTimeout

    return ReadTimeout()
