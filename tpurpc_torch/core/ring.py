"""The credit-managed, header/footer-framed host receive ring.

A trimmed copy of ``tpurpc/core/ring.py`` (pure Python; the reference's C
fast path is not part of the port yet).

* Wire format per message::

      [8B header = u32 len | u32 seq32][payload, padded to 8B][8B footer]

  The footer is ``seq64 ^ SALT``. A message is complete iff the header's
  seq32 matches the reader's expected sequence AND the footer carries the
  expected 64-bit stamp, so stale bytes from earlier wraps are never taken
  for messages and nothing is zeroed. The writer stores payload → footer →
  header.
* Partial reads carry progress across calls; the head advances only when a
  message is fully consumed.
* A logical span maps to ≤2 physical segments (split at the wrap).
* Credit flow control: the writer stalls when the mirrored ``remote_head``
  says the ring is full (3×8B reserved); the reader publishes its head after
  consuming a quarter of the ring.

Head and tail are monotonic 64-bit counters masked on access.

Observability, under the reference's names: the ``ring_msgs_read``,
``ring_bytes_read``, ``ring_msgs_written`` and ``ring_bytes_written``
counters (one add per batched drain or write), the
``ring_credit_unpublished_bytes`` and ``ring_in_flight_bytes`` fleet
gauges (read at scrape time only), the ``send_ring`` and ``peer_ring`` lens
hops, the ``ring-write`` and ``ring-read`` profiler stages, and the
writer's ``CREDIT_STARVE_BEGIN``/``_END`` flight edges under its owner's
tag. Left out with the C fast path (ROADMAP A7 (a)): ``read``,
``read_into``, ``read_many`` and ``scan_complete``, so their stage markers
too.
"""

from __future__ import annotations

import struct
import time
from typing import Callable, List, Optional, Sequence, Tuple

from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import lens as _lens
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.tpu import ledger

# hot counters are cached module objects: one add per drain or batch. The
# fleet gauges read the attributes the ring keeps anyway, at scrape time.
_MSGS_IN = _metrics.counter("ring_msgs_read")
_BYTES_IN = _metrics.counter("ring_bytes_read")
_MSGS_OUT = _metrics.counter("ring_msgs_written")
_BYTES_OUT = _metrics.counter("ring_bytes_written")
_READERS = _metrics.fleet("ring_credit_unpublished_bytes",
                          lambda r: r.consumed_since_publish)
_WRITERS = _metrics.fleet("ring_in_flight_bytes",
                          lambda w: w.tail - w.remote_head)

# lens hops: ring bytes move by host memcpy, so every byte is a copy byte
_LENS_SR_BYTES, _LENS_SR_NS, _LENS_SR_COPY = _lens.hop_counters("send_ring")
_LENS_PR_BYTES, _LENS_PR_NS, _LENS_PR_COPY = _lens.hop_counters("peer_ring")

_LENS_STAGES = {
    "writev": "ring-write",
    "write_many": "ring-write",
    "drain_into": "ring-read",
}
_profiler.register_stages(__file__, _LENS_STAGES)

ALIGN = 8
HEADER_BYTES = 8
FOOTER_BYTES = 8
#: Salt in the footer stamp (the reference's native ring uses the same).
FOOTER_SALT = 0xA5C3F00D5EEDFACE
#: Reserved slack the writer never fills: header + footer + one 8B gap.
RESERVED_BYTES = HEADER_BYTES + FOOTER_BYTES + ALIGN

_U64 = struct.Struct("<Q")
_U64_MASK = (1 << 64) - 1


def footer_stamp(seq: int) -> int:
    return (seq ^ FOOTER_SALT) & _U64_MASK


def header_stamp(length: int, seq: int) -> int:
    return (length & 0xFFFFFFFF) | ((seq & 0xFFFFFFFF) << 32)


def align_up(n: int) -> int:
    return (n + ALIGN - 1) & ~(ALIGN - 1)


def message_span(payload_len: int) -> int:
    """Total ring bytes one message of ``payload_len`` occupies."""
    return HEADER_BYTES + align_up(payload_len) + FOOTER_BYTES


class RingLayout:
    """Pure offset math shared by reader and writer."""

    __slots__ = ("capacity", "mask")

    def __init__(self, capacity: int):
        if capacity < 64 or capacity & (capacity - 1):
            raise ValueError(f"ring capacity must be a power of two >= 64, got {capacity}")
        self.capacity = capacity
        self.mask = capacity - 1

    def phys(self, abs_off: int) -> int:
        return abs_off & self.mask

    def max_payload(self) -> int:
        """Largest single-message payload this ring can ever carry."""
        return self.capacity - RESERVED_BYTES

    def segments(self, abs_off: int, nbytes: int) -> List[Tuple[int, int]]:
        """Map a contiguous logical span to ≤2 physical (offset, len) segments."""
        assert 0 <= nbytes <= self.capacity
        if nbytes == 0:
            return []
        p = self.phys(abs_off)
        if p + nbytes <= self.capacity:
            return [(p, nbytes)]
        first = self.capacity - p
        return [(p, first), (0, nbytes - first)]


class RingReader:
    """Consumer view over the ring memory this side owns (the peer writes
    into it)."""

    #: credit-publish threshold divisor: publish after capacity/4 consumed
    PUBLISH_DIVISOR = 4

    def __init__(self, buf, capacity: Optional[int] = None):
        self.buf = memoryview(buf)
        cap = capacity if capacity is not None else len(self.buf)
        if len(self.buf) < cap:
            raise ValueError("buffer smaller than declared capacity")
        self.layout = RingLayout(cap)
        self.head = 0  # absolute; phys offset = head & mask
        self.seq = 0   # sequence expected of the next unparsed message
        self._msg_len = 0   # payload length of the in-progress message
        self._msg_read = 0  # payload bytes already handed to the app
        self.consumed_since_publish = 0
        _READERS.track(self)

    # -- completion scanning ------------------------------------------------

    def _word(self, abs_off: int) -> int:
        return _U64.unpack_from(self.buf, self.layout.phys(abs_off))[0]

    def _message_at(self, abs_off: int, seq: int) -> int:
        """Payload length of the complete message stamped ``seq`` at
        ``abs_off``, else 0."""
        hdr = self._word(abs_off)
        if (hdr >> 32) != (seq & 0xFFFFFFFF):
            return 0  # stale bytes or header not yet placed
        ln = hdr & 0xFFFFFFFF
        if ln == 0 or ln > self.layout.max_payload():
            return 0  # stale lookalike; the 64-bit footer still gates
        footer_off = abs_off + HEADER_BYTES + align_up(ln)
        if self._word(footer_off) != footer_stamp(seq):
            return 0  # body still in flight
        return ln

    def has_message(self) -> bool:
        if self._msg_len:
            return True
        return self._message_at(self.head, self.seq) != 0

    def readable(self) -> int:
        """Total payload bytes currently drainable (all complete messages)."""
        total = 0
        off = self.head
        seq = self.seq
        if self._msg_len:  # in-progress message carries seq; next is seq+1
            total += self._msg_len - self._msg_read
            off += message_span(self._msg_len)
            seq += 1
        scanned = 0
        while scanned < self.layout.capacity:
            ln = self._message_at(off, seq)
            if ln == 0:
                break
            total += ln
            span = message_span(ln)
            off += span
            scanned += span
            seq += 1
        return total

    # -- draining -----------------------------------------------------------

    def _copy_out(self, abs_off: int, n: int, dst: memoryview, dst_off: int) -> None:
        for seg_off, seg_len in self.layout.segments(abs_off, n):
            dst[dst_off:dst_off + seg_len] = self.buf[seg_off:seg_off + seg_len]
            dst_off += seg_len

    def drain_into(self, dst) -> Tuple[int, int]:
        """Drain up to ``len(dst)`` payload bytes, message by message with
        partial-message resumption; head/seq/credit state and the ledger
        update once per call. Returns ``(payload_bytes, completed_messages)``."""
        dst = memoryview(dst)
        if dst.readonly:
            raise ValueError("drain_into needs a writable buffer")
        dst = dst.cast("B")
        total = 0
        nmsgs = 0
        head = self.head
        seq = self.seq
        msg_len = self._msg_len
        msg_read = self._msg_read
        t0 = time.monotonic_ns()
        while total < len(dst):
            if msg_len == 0:
                ln = self._message_at(head, seq)
                if ln == 0:
                    break
                msg_len = ln
                msg_read = 0
            n = min(len(dst) - total, msg_len - msg_read)
            self._copy_out(head + HEADER_BYTES + msg_read, n, dst, total)
            msg_read += n
            total += n
            if msg_read == msg_len:
                head += message_span(msg_len)
                msg_len = 0
                msg_read = 0
                seq += 1
                nmsgs += 1
        dt = time.monotonic_ns() - t0
        self.consumed_since_publish += head - self.head
        self.head = head
        self.seq = seq
        self._msg_len = msg_len
        self._msg_read = msg_read
        ledger.host_copy(total)
        _MSGS_IN.inc(nmsgs)
        _BYTES_IN.inc(total)
        _LENS_PR_BYTES.inc(total)
        _LENS_PR_NS.inc(dt)
        _LENS_PR_COPY.inc(total)
        return total, nmsgs

    # -- credits ------------------------------------------------------------

    def should_publish_head(self) -> bool:
        return (self.consumed_since_publish
                >= self.layout.capacity // self.PUBLISH_DIVISOR)

    def take_publish(self) -> int:
        """Consume the pending credit and return the head value to publish."""
        self.consumed_since_publish = 0
        return self.head

    def release(self) -> None:
        """Drop the memoryview so the underlying region can close."""
        self.buf.release()


class RingCorruption(RuntimeError):
    """A framing invariant was violated."""


WriteFn = Callable[[int, "memoryview | bytes"], None]


class RingWriter:
    """Producer view: encodes messages into the *peer's* ring via one-sided
    writes. ``write_fn(phys_offset, data)`` performs the placement; the
    writer learns the consumer's progress only through
    :meth:`update_remote_head` (the credit write)."""

    def __init__(self, capacity: int, write_fn: WriteFn):
        self.layout = RingLayout(capacity)
        self.write_fn = write_fn
        self.tail = 0         # absolute count of ring bytes ever written
        self.seq = 0          # sequence stamp of the next message
        self.remote_head = 0  # mirrored consumer head (credits)
        #: the owner's flight tag, and the open credit-starvation edge: one
        #: event per starve episode and one per recovery, never per message
        self.flight_tag = 0
        self._starved = False
        _WRITERS.track(self)

    # -- flow control -------------------------------------------------------

    def in_flight(self) -> int:
        used = self.tail - self.remote_head
        assert 0 <= used <= self.layout.capacity, (self.tail, self.remote_head)
        return used

    def writable_payload(self) -> int:
        """Largest payload acceptable right now: ``capacity - used - 3×8B``
        (8-aligned, so the 8-byte gap before the consumer's head is never
        touched)."""
        return max(0, self.layout.capacity - self.in_flight() - RESERVED_BYTES)

    def update_remote_head(self, head: int) -> None:
        if head < self.remote_head or head > self.tail:
            raise RingCorruption(
                f"credit head {head} outside [{self.remote_head}, {self.tail}]")
        self.remote_head = head

    # -- encoding -----------------------------------------------------------

    def _put(self, abs_off: int, data) -> None:
        view = memoryview(data).cast("B")
        pos = 0
        for seg_off, seg_len in self.layout.segments(abs_off, len(view)):
            self.write_fn(seg_off, view[pos:pos + seg_len])
            pos += seg_len

    def writev(self, slices: Sequence) -> int:
        """Gather-encode several slices as ONE message; returns payload bytes
        written. The caller chunks to :meth:`writable_payload`."""
        views = [memoryview(s).cast("B") for s in slices]
        payload_len = sum(len(v) for v in views)
        if payload_len == 0:
            return 0
        if payload_len > self.writable_payload():
            if not self._starved:
                self._starved = True
                _flight.emit(_flight.CREDIT_STARVE_BEGIN, self.flight_tag,
                             self.tail - self.remote_head)
            raise RingFull(payload_len, self.writable_payload())
        if self._starved:
            self._starved = False
            _flight.emit(_flight.CREDIT_STARVE_END, self.flight_tag)
        # Order matters for lock-free completion: payload, footer, header.
        t0 = time.monotonic_ns()
        ledger.host_copy(payload_len)
        off = self.tail + HEADER_BYTES
        for v in views:
            self._put(off, v)
            off += len(v)
        footer_off = self.tail + HEADER_BYTES + align_up(payload_len)
        self._put(footer_off, _U64.pack(footer_stamp(self.seq)))
        self._put(self.tail, _U64.pack(header_stamp(payload_len, self.seq)))
        dt = time.monotonic_ns() - t0
        self.tail += message_span(payload_len)
        self.seq += 1
        _MSGS_OUT.inc()
        _BYTES_OUT.inc(payload_len)
        _LENS_SR_BYTES.inc(payload_len)
        _LENS_SR_NS.inc(dt)
        _LENS_SR_COPY.inc(payload_len)
        return payload_len

    def write_many(self, payloads: Sequence) -> Tuple[int, int]:
        """Encode a batch of messages (each a bytes-like or a gather list)
        with one bulk placement: payloads, padding and footers land as one
        span, then one header store per message, in order, after it — the
        headers are the completion gates. As many whole messages as the
        credits allow; returns ``(messages, payload_bytes)``."""
        views_per_msg: List[List[memoryview]] = []
        lens: List[int] = []
        budget = self.writable_payload()
        rejected = False
        for p in payloads:
            segs = ([memoryview(s).cast("B") for s in p]
                    if isinstance(p, (list, tuple))
                    else [memoryview(p).cast("B")])
            ln = sum(len(v) for v in segs)
            if ln == 0:
                continue
            if ln > budget:
                rejected = True
                break
            views_per_msg.append(segs)
            lens.append(ln)
            budget -= message_span(ln)
        if not views_per_msg:
            if rejected and not self._starved:
                # offered messages, accepted none: credit-starved
                self._starved = True
                _flight.emit(_flight.CREDIT_STARVE_BEGIN, self.flight_tag,
                             self.tail - self.remote_head)
            return 0, 0
        if self._starved:
            self._starved = False
            _flight.emit(_flight.CREDIT_STARVE_END, self.flight_tag)
        if len(views_per_msg) == 1:
            return 1, self.writev(views_per_msg[0])
        t0 = time.monotonic_ns()
        total_span = sum(message_span(ln) for ln in lens)
        scratch = memoryview(bytearray(total_span))
        rel = 0
        seq = self.seq
        for segs, ln in zip(views_per_msg, lens):
            pos = rel + HEADER_BYTES
            for v in segs:
                scratch[pos:pos + len(v)] = v
                pos += len(v)
            footer_rel = rel + HEADER_BYTES + align_up(ln)
            scratch[footer_rel:footer_rel + 8] = _U64.pack(footer_stamp(seq))
            rel += message_span(ln)
            seq += 1
        self._put(self.tail, scratch)
        rel = 0
        seq = self.seq
        for ln in lens:
            self._put(self.tail + rel, _U64.pack(header_stamp(ln, seq)))
            rel += message_span(ln)
            seq += 1
        dt = time.monotonic_ns() - t0
        payload_total = sum(lens)
        ledger.host_copy(payload_total)
        self.tail += total_span
        self.seq = seq
        _MSGS_OUT.inc(len(lens))
        _BYTES_OUT.inc(payload_total)
        _LENS_SR_BYTES.inc(payload_total)
        _LENS_SR_NS.inc(dt)
        _LENS_SR_COPY.inc(payload_total)
        return len(lens), payload_total


class RingFull(RuntimeError):
    """Message does not fit the currently writable span; wait for credits."""

    def __init__(self, wanted: int, available: int):
        super().__init__(f"ring full: wanted {wanted} payload bytes, {available} writable")
        self.wanted = wanted
        self.available = available
