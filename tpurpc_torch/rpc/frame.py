"""tpurpc native wire format: multiplexed frames over one byte-pipe endpoint.

A copy of ``tpurpc/rpc/frame.py``, with its ``h2-framing`` profiler stages
and its ``ctrl_call_batch`` and ``resp_coalesce`` batch histograms under
the reference's names. Frame layout, little-endian::

    [u8 type][u8 flags][u32 stream_id][u32 length] [payload: length bytes]

Frame types: HEADERS, MESSAGE, TRAILERS, RST, PING, PONG, GOAWAY, the
rendezvous control frames RDV_OFFER, RDV_CLAIM, RDV_COMPLETE, RDV_RELEASE,
and CTRL_KICK (the wake of a parked descriptor-ring consumer,
``core/ctrlring.py``). A MESSAGE larger than ``MAX_FRAME_PAYLOAD`` is split
into fragments with the MORE flag on all but the last; with the
connection's rendezvous link bound (``FrameWriter.rdv``) a MESSAGE over the
size bar is written into the peer's landing region instead and only its
control ops ride the connection. A MESSAGE sent with ``FLAG_COMPRESSED`` is
gzipped whole by the writer (the flag is cleared when gzip would not make
it smaller) and gunzipped by the receiver at reassembly, with the receive
limit on the inflated size. Metadata: ``u16 count`` then per entry ``u16
keylen, key-utf8, u32 vallen, value``; keys ending in ``-bin`` carry binary
values.

``FrameWriter`` counts the frames it committed (``frames_sent``, the
descriptor ring's ordering gate; unlike the reference's, a direct write
counts under its write lock, so the count never trails the wire), coalesces unary responses across streams
on a ``coalesce=True`` writer (one gathered writev while another is in
flight), and batches one thread's frames into one writev inside
``FrameWriter.batch()``.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

from tpurpc_torch.core.endpoint import Endpoint
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.rpc.status import StatusCode
from tpurpc_torch.tpu import ledger as _ledger
from tpurpc_torch.utils import stats as _stats

# frame encode and the coalescing writev flusher are h2-framing work
_LENS_STAGES = {
    "send": "h2-framing",
    "send_many": "h2-framing",
    "_send_fragmented": "h2-framing",
    "_flush_pending": "h2-framing",
    "encode_frame": "h2-framing",
}
_profiler.register_stages(__file__, _LENS_STAGES)

MAGIC = b"TPURPC\x01\x00"  # connection preface, client → server
MAX_FRAME_PAYLOAD = 1 << 20
HEADER_FMT = struct.Struct("<BBII")

# frame types
HEADERS = 1
MESSAGE = 2
TRAILERS = 3
RST = 4
PING = 5
PONG = 6
GOAWAY = 7
# tpurpc-express rendezvous control frames: the bulk payload
# itself never rides a frame — it is one-sided-written into the receiver's
# advertised landing region; these tiny control messages are all the framed
# connection carries for a rendezvous'd MESSAGE. Only sent after the PING
# capability hello proved the peer speaks them (core/rendezvous.py).
RDV_OFFER = 8
RDV_CLAIM = 9
RDV_COMPLETE = 10
RDV_RELEASE = 11
# tpurpc-pulse: one-shot wake for a PARKED descriptor-ring
# consumer — the only frame a cold→hot control-plane transition costs.
# Carries nothing; the receiver's read loop drains its ring on every
# wakeup, so the frame's arrival IS the delivery. Only ever sent to a
# peer that advertised a ring in the hello (same-build guarantee).
CTRL_KICK = 12

#: canonical rendezvous op <-> native frame type (ops are transport-
#: agnostic small ints; the h2 planes carry them in an extension frame)
RDV_FRAME_OF_OP = {1: RDV_OFFER, 2: RDV_CLAIM, 3: RDV_COMPLETE,
                   4: RDV_RELEASE}
RDV_OP_OF_FRAME = {v: k for k, v in RDV_FRAME_OF_OP.items()}

# flags
FLAG_END_STREAM = 0x01  # sender half-closes this stream (ref: h2 END_STREAM)
FLAG_MORE = 0x02        # this MESSAGE frame is a fragment; more follow
FLAG_COMPRESSED = 0x08  # MESSAGE payload is gzip-compressed (whole message;
#                         set on every fragment). Senders request it by
#                         passing the flag to FrameWriter, which performs
#                         the compression — receivers gunzip at reassembly.
#                         The gRPC wire's per-message compressed-flag
#                         (grpc-encoding) recast for the tpurpc framing.
FLAG_REFUSED = 0x10     # RST only: stream refused at admission — no handler ran,
                        # replay on a fresh connection is safe (h2 REFUSED_STREAM;
                        # C mirror: framing_common.h kFlagRefused)
FLAG_NO_MESSAGE = 0x04  # MESSAGE frame carries no message (pure half-close marker),
                        # distinguishing it from a genuine empty message

#: Sentinel substring in the UNIMPLEMENTED trailer a decompressor-less peer
#: sends when rejecting a FLAG_COMPRESSED stream. The channel's compression
#: negotiation (degrade-to-identity + transparent unary replay) keys on it,
#: so it MUST stay a substring of the native peers' wordings:
#: native/src/tpurpc_server.cc ("compressed messages unsupported here") and
#: native/src/tpurpc_client.cc ("... unsupported by the native client").
COMPRESSED_UNSUPPORTED_SENTINEL = "compressed messages unsupported"

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")


class FrameError(Exception):
    """Protocol violation on the wire; connection-fatal."""


def encode_metadata(md: Sequence[Tuple[str, "str | bytes"]]) -> bytes:
    parts = [_U16.pack(len(md))]
    for key, value in md:
        kb = key.encode("utf-8")
        vb = value if isinstance(value, (bytes, bytearray)) else str(value).encode("utf-8")
        parts.append(_U16.pack(len(kb)))
        parts.append(kb)
        parts.append(_U32.pack(len(vb)))
        parts.append(bytes(vb))
    return b"".join(parts)


def decode_metadata(buf: bytes, offset: int = 0) -> Tuple[List[Tuple[str, "str | bytes"]], int]:
    try:
        (count,) = _U16.unpack_from(buf, offset)
        offset += 2
        out: List[Tuple[str, "str | bytes"]] = []
        for _ in range(count):
            (klen,) = _U16.unpack_from(buf, offset)
            offset += 2
            key = bytes(buf[offset:offset + klen]).decode("utf-8")
            offset += klen
            (vlen,) = _U32.unpack_from(buf, offset)
            offset += 4
            raw = bytes(buf[offset:offset + vlen])
            offset += vlen
            value: "str | bytes" = raw if key.endswith("-bin") else raw.decode("utf-8")
            out.append((key, value))
        return out, offset
    except (struct.error, UnicodeDecodeError) as exc:
        raise FrameError(f"bad metadata block: {exc}") from exc


class Frame:
    __slots__ = ("type", "flags", "stream_id", "payload")

    def __init__(self, type: int, flags: int, stream_id: int, payload: bytes = b""):
        self.type = type
        self.flags = flags
        self.stream_id = stream_id
        self.payload = payload

    def __repr__(self) -> str:
        names = {1: "HEADERS", 2: "MESSAGE", 3: "TRAILERS", 4: "RST",
                 5: "PING", 6: "PONG", 7: "GOAWAY", 8: "RDV_OFFER",
                 9: "RDV_CLAIM", 10: "RDV_COMPLETE", 11: "RDV_RELEASE",
                 12: "CTRL_KICK"}
        return (f"<Frame {names.get(self.type, self.type)} sid={self.stream_id} "
                f"flags={self.flags:#x} len={len(self.payload)}>")


def encode_frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> List[bytes]:
    """Header + payload as separate slices for the endpoint's gather write."""
    out = [HEADER_FMT.pack(ftype, flags, stream_id, len(payload))]
    if payload:
        out.append(payload)
    return out


def headers_payload(path: str, metadata: Sequence[Tuple[str, "str | bytes"]] = (),
                    timeout_us: Optional[int] = None) -> bytes:
    md = [(":path", path)]
    if timeout_us is not None:
        md.append((":timeout-us", str(timeout_us)))
    md.extend(metadata)
    return encode_metadata(md)


def parse_headers(payload: bytes) -> Tuple[str, Optional[int], List[Tuple[str, "str | bytes"]]]:
    md, _ = decode_metadata(payload)
    path = ""
    timeout_us: Optional[int] = None
    user: List[Tuple[str, "str | bytes"]] = []
    for key, value in md:
        if key == ":path":
            path = str(value)
        elif key == ":timeout-us":
            try:
                timeout_us = int(value)
            except ValueError as exc:
                raise FrameError(f"bad :timeout-us {value!r}") from exc
        else:
            user.append((key, value))
    if not path:
        raise FrameError("HEADERS missing :path")
    return path, timeout_us, user


MAX_STATUS_DETAILS = 16 << 10


def trailers_payload(code: StatusCode, details: str = "",
                     metadata: Sequence[Tuple[str, "str | bytes"]] = ()) -> bytes:
    md = [(":status", str(int(code)))]
    if details:
        # Bound the status message (e.g. a handler exception repr) so trailers
        # always fit one control frame.
        md.append((":message", details[:MAX_STATUS_DETAILS]))
    md.extend(metadata)
    return encode_metadata(md)


def parse_trailers(payload: bytes) -> Tuple[StatusCode, str, List[Tuple[str, "str | bytes"]]]:
    md, _ = decode_metadata(payload)
    code = StatusCode.UNKNOWN
    details = ""
    user: List[Tuple[str, "str | bytes"]] = []
    for key, value in md:
        if key == ":status":
            try:
                code = StatusCode(int(value))
            except ValueError as exc:
                raise FrameError(f"bad :status {value!r}") from exc
        elif key == ":message":
            details = str(value)
        else:
            user.append((key, value))
    return code, details, user


def rst_payload(code: StatusCode, details: str = "") -> bytes:
    return trailers_payload(code, details)


parse_rst = parse_trailers


def _compress_segs(segs, total):
    """gzip a MESSAGE payload (FLAG_COMPRESSED contract: the WHOLE message
    is one gzip stream; fragmentation happens after). Returns the segs
    unchanged with ``compressed=False`` when gzip would ENLARGE the
    payload (incompressible data: the gRPC wire clears its per-message
    compressed bit the same way)."""
    import gzip

    joined = b"".join(bytes(s) for s in segs)
    out = gzip.compress(joined, compresslevel=1)  # speed over ratio: this
    # sits on the RPC hot path; level 1 still collapses repetitive tensors
    if len(out) >= total:
        return segs, total, False
    return [memoryview(out)], len(out), True


class DecompressTooLarge(FrameError):
    """FLAG_COMPRESSED payload inflates past the receive limit (a
    gzip-bomb guard — gRPC enforces max_receive_message_length on the
    POST-decompression size, and so do we)."""


def decompress_message(data, limit: "int | None" = None) -> bytes:
    """Receiver-side inverse of FLAG_COMPRESSED. Raises
    :class:`DecompressTooLarge` when the inflated size exceeds ``limit``,
    :class:`FrameError` on a payload that does not gunzip (protocol
    violation, not app data)."""
    import zlib

    d = zlib.decompressobj(31)  # 31 = gzip wrapper
    try:
        if limit is None or limit < 0:  # None/-1 both mean "unlimited"
            out = d.decompress(bytes(data))
        else:
            out = d.decompress(bytes(data), max(1, limit) + 1)
            if len(out) > limit or d.unconsumed_tail:
                raise DecompressTooLarge(
                    f"compressed message inflates past the receive "
                    f"limit ({limit} bytes)")
        if not d.eof:
            raise FrameError("FLAG_COMPRESSED payload is a truncated "
                             "gzip stream")
        return out
    except zlib.error as exc:
        raise FrameError(f"FLAG_COMPRESSED payload does not gunzip: {exc}"
                         ) from exc


class FrameWriter:
    """Serializes frame writes from many threads onto one endpoint.

    The single lock is the moral equivalent of chttp2's write-combiner
    (``chttp2_transport.cc:997`` write_action): one writer at a time, gather slices,
    large messages fragmented so no stream can monopolize the pipe.

    With ``coalesce=True`` (the server's response path),
    ``send_many`` becomes a cross-stream write combiner: responses
    completing close together on one connection flush as ONE gathered
    writev — one transport write/notify for N streams' responses instead
    of N. The flush window is self-clocking: while one thread's writev is
    in flight, later responses queue and the flusher drains them in its
    next writev, so an idle connection pays zero added latency (no timer)
    and a busy one amortizes wakeups. ``max_coalesce_bytes`` caps a single
    gathered writev; the remainder flushes in the next one. Plain
    ``send`` and the fragmenting path stay direct — per-stream frame order
    is preserved because a unary stream's fused response is its only
    coalesced write.
    """

    #: cap on one coalesced writev (gather-list growth bound); responses
    #: past it flush in the flusher's next writev
    MAX_COALESCE_BYTES = 256 << 10

    def __init__(self, endpoint: Endpoint, coalesce: bool = False,
                 max_coalesce_bytes: Optional[int] = None):
        import threading

        self._ep = endpoint
        self._lock = threading.Lock()
        #: tpurpc-pulse: frames this writer has committed to the wire, in
        #: order.  Descriptor-ring control records stamp this count at post
        #: time so the receiver can order them against in-flight frames
        #: (core/ctrlring.py frame_seq gate).  Guarded by its own lock.
        #: The count never trails the wire: a direct write counts its
        #: frames before it lets go of _lock, and a queued (coalesced or
        #: thread-batched) frame is counted before it is written, so a
        #: record posted after a frame is never stamped below it.
        self.frames_sent = 0
        self._fs_lock = threading.Lock()
        #: per-thread frame batch (FrameWriter.batch): frames queue here
        #: and flush as ONE gathered writev at context exit — the
        #: coalesced control path for bursts of small control RPCs
        self._tls = threading.local()
        #: tpurpc-express: the connection's rendezvous link, bound by the
        #: owning connection once constructed. When set, MESSAGE payloads
        #: over the size bar are moved by a one-sided write into the
        #: peer's landing region instead of fragmented frames; everything
        #: below the bar (and every control frame) keeps this path.
        self.rdv = None
        self._coalesce = coalesce
        self._max_coalesce = max_coalesce_bytes or self.MAX_COALESCE_BYTES
        self._pend_lock = threading.Lock()
        #: queued coalescable writes: (nbytes, [segs]) — appended when a
        #: flush is in flight; drained by the flusher (FIFO, so one
        #: stream's queued writes can never reorder)
        self._pending: List = []
        self._flushing = False

    def send(self, ftype: int, flags: int, stream_id: int,
             payload: "bytes | Sequence" = b"") -> None:
        """Write one logical frame.

        MESSAGE payloads may be a gather list of buffers (the tensor codec's
        segment output) — they are fragmented and scatter-written with zero
        joins/copies; the endpoint's gather write (ring slice-send /
        ``sendmsg``) does the placement.
        """
        segs = ([memoryview(s).cast("B") for s in payload]
                if isinstance(payload, (list, tuple)) else
                [memoryview(payload).cast("B")])
        segs = [s for s in segs if len(s)]
        total = sum(len(s) for s in segs)
        rdv = self.rdv
        if (rdv is not None and ftype == MESSAGE and total
                and not (flags & (FLAG_NO_MESSAGE | FLAG_MORE))
                and rdv.eligible(total,
                                 flags_compressed=bool(
                                     flags & FLAG_COMPRESSED))
                and rdv.send_message(stream_id, flags, segs, total)):
            return  # payload one-sided-written; COMPLETE already framed
        if ftype == MESSAGE and flags & FLAG_COMPRESSED:
            segs, total, did = _compress_segs(segs, total)
            if not did:  # incompressible: send as-is, clear the bit
                flags &= ~FLAG_COMPRESSED
        if total <= MAX_FRAME_PAYLOAD:
            tb = getattr(self._tls, "batch", None)
            if tb is not None:
                tb[1].append(memoryview(
                    HEADER_FMT.pack(ftype, flags, stream_id, total)))
                tb[1].extend(segs)
                tb[0] += 1
                self._count_frames(1)
                return
            with self._lock:
                self._ep.write(
                    [HEADER_FMT.pack(ftype, flags, stream_id, total)] + segs)
                self._count_frames(1)
            return
        self._flush_thread_batch()  # oversized frame: preserve order
        if ftype != MESSAGE:
            # Control frames don't fragment; sending one oversized would make
            # the peer tear down the whole multiplexed connection.  Fail just
            # this caller instead.
            raise FrameError(
                f"control frame payload {total} exceeds "
                f"{MAX_FRAME_PAYLOAD}; metadata too large")
        self._send_fragmented(flags, stream_id, segs, total)

    def _send_fragmented(self, flags: int, stream_id: int,
                         segs: List[memoryview], total: int) -> None:
        # Lock per fragment, not per message: fragments carry stream_id +
        # FLAG_MORE so other streams' frames (and PING/PONG, TRAILERS) may
        # interleave — a huge tensor on a credit-stalled ring must not add
        # head-of-line latency to every other stream on the connection.
        sent = 0
        si = 0       # current segment index
        so = 0       # offset within current segment
        while sent < total:
            n = min(MAX_FRAME_PAYLOAD, total - sent)
            frame_segs: List[memoryview] = []
            need = n
            while need:
                seg = segs[si]
                take = min(need, len(seg) - so)
                frame_segs.append(seg[so:so + take])
                so += take
                need -= take
                if so == len(seg):
                    si += 1
                    so = 0
            sent += n
            last = sent >= total
            fl = (flags if last else (flags & ~FLAG_END_STREAM) | FLAG_MORE)
            with self._lock:
                self._ep.write(
                    [HEADER_FMT.pack(MESSAGE, fl, stream_id, n)] + frame_segs)
                self._count_frames(1)

    def send_many(self, frames: Sequence[Tuple[int, int, int, "bytes | Sequence"]]
                  ) -> None:
        """Write several logical frames in ONE endpoint write (one transport
        notify/wakeup instead of one per frame — the unary fast path sends
        HEADERS+MESSAGE / MESSAGE+TRAILERS fused). Frames whose payload
        exceeds MAX_FRAME_PAYLOAD fall back to the fragmenting path in order.
        On a ``coalesce=True`` writer, non-fragmented calls additionally
        combine ACROSS threads (see the class docstring).
        """
        rdv = self.rdv
        if rdv is not None:
            for ftype, flags, _sid, payload in frames:
                if ftype != MESSAGE or flags & (FLAG_NO_MESSAGE | FLAG_MORE):
                    continue
                n = (sum(len(s) for s in payload)
                     if isinstance(payload, (list, tuple)) else len(payload))
                if rdv.eligible(n, flags_compressed=bool(
                        flags & FLAG_COMPRESSED)):
                    # a rendezvous-bound payload in the batch: degrade to
                    # ordered per-frame sends — the bulk member routes via
                    # the one-sided plane, the rest frame normally, and
                    # per-stream order is preserved because the COMPLETE
                    # control frame is itself sent in sequence
                    for f in frames:
                        self.send(*f)
                    return
        # Encode first: oversized-control-frame failures must surface
        # before any byte is written or queued (an aborted half-written
        # batch would corrupt the coalescing queue's FIFO contract).
        encoded: List[Tuple[int, int, int, List[memoryview], int]] = []
        fragment = False
        for ftype, flags, stream_id, payload in frames:
            segs = ([memoryview(s).cast("B") for s in payload]
                    if isinstance(payload, (list, tuple)) else
                    [memoryview(payload).cast("B")])
            segs = [s for s in segs if len(s)]
            total = sum(len(s) for s in segs)
            if ftype == MESSAGE and flags & FLAG_COMPRESSED:
                segs, total, did = _compress_segs(segs, total)
                if not did:  # incompressible: send as-is, clear the bit
                    flags &= ~FLAG_COMPRESSED
            if total > MAX_FRAME_PAYLOAD:
                if ftype != MESSAGE:
                    raise FrameError(
                        f"control frame payload {total} exceeds "
                        f"{MAX_FRAME_PAYLOAD}; metadata too large")
                fragment = True
            encoded.append((ftype, flags, stream_id, segs, total))
        if fragment:
            # Fragmenting calls stay on the direct path whole (their
            # per-stream order must not straddle the pending queue).
            self._flush_thread_batch()
            batch: List[memoryview] = []
            nframes = 0
            for ftype, flags, stream_id, segs, total in encoded:
                if total > MAX_FRAME_PAYLOAD:
                    if batch:
                        with self._lock:
                            self._ep.write(batch)
                            self._count_frames(nframes)
                        batch, nframes = [], 0
                    self._send_fragmented(flags, stream_id, segs, total)
                    continue
                batch.append(memoryview(
                    HEADER_FMT.pack(ftype, flags, stream_id, total)))
                batch.extend(segs)
                nframes += 1
            if batch:
                with self._lock:
                    self._ep.write(batch)
                    self._count_frames(nframes)
            return
        tb = getattr(self._tls, "batch", None)
        batch = tb[1] if tb is not None else []
        nbytes = 0
        for ftype, flags, stream_id, segs, total in encoded:
            batch.append(memoryview(
                HEADER_FMT.pack(ftype, flags, stream_id, total)))
            batch.extend(segs)
            nbytes += HEADER_FMT.size + total
        if tb is not None:  # thread batch: flushed at context exit
            tb[0] += len(encoded)
            self._count_frames(len(encoded))
            return
        if not batch:
            return
        if not self._coalesce:
            with self._lock:
                self._ep.write(batch)
                self._count_frames(len(encoded))
            return
        # counted at queue time: the frames are committed (in order) even
        # though the flusher writes them — a ring record posted after this
        # call must gate on them
        self._count_frames(len(encoded))
        with self._pend_lock:
            self._pending.append((nbytes, batch))
            if self._flushing:
                return  # the in-flight flusher writes it: zero extra wakeups
            self._flushing = True
        self._flush_pending()

    def _count_frames(self, n: int) -> None:
        if not n:
            return
        with self._fs_lock:
            self.frames_sent += n

    # -- per-thread frame batching ---------------------------------------------

    def batch(self):
        """Context manager: non-fragmenting frames written by THIS thread
        inside the block queue and flush as ONE gathered writev at exit —
        a burst of small control RPCs (e.g. a migration drain's N sequence
        handoffs) costs one transport write instead of N.  Oversized/
        fragmenting frames flush the queue first, preserving order; other
        threads' writes are untouched (their order against the batch is
        already unconstrained)."""
        import contextlib

        @contextlib.contextmanager
        def _cm():
            prev = getattr(self._tls, "batch", None)
            self._tls.batch = [0, []]  # [n_frames, gather segs]
            try:
                yield
            finally:
                tb, self._tls.batch = self._tls.batch, prev
                if tb[1]:
                    with self._lock:
                        self._ep.write(tb[1])
                    _stats.batch_hist("ctrl_call_batch").record(
                        max(1, tb[0]))

        return _cm()

    def _flush_thread_batch(self) -> None:
        tb = getattr(self._tls, "batch", None)
        if tb is not None and tb[1]:
            segs = tb[1]
            tb[0], tb[1] = 0, []
            with self._lock:
                self._ep.write(segs)

    def _flush_pending(self) -> None:
        """Drain the coalescing queue, one capped gathered writev at a
        time, until it is empty (then hand back the flusher role). A write
        failure drops the queue — the connection is dying and every server
        response path treats sends as best-effort."""
        while True:
            with self._pend_lock:
                if not self._pending:
                    self._flushing = False
                    return
                take: List[memoryview] = []
                nresp = size = 0
                while self._pending and (
                        not take
                        or size + self._pending[0][0] <= self._max_coalesce):
                    nb, segs = self._pending.pop(0)
                    take.extend(segs)
                    size += nb
                    nresp += 1
            try:
                with self._lock:
                    self._ep.write(take)
            except BaseException:
                with self._pend_lock:
                    self._pending.clear()
                    self._flushing = False
                raise
            _stats.batch_hist("resp_coalesce").record(nresp)

    def send_preface(self) -> None:
        with self._lock:
            self._ep.write(MAGIC)


#: Returned by read_frame when a MESSAGE frame was routed to the sink — the
#: caller's loop just continues; there is no Frame object for bulk payloads.
CONSUMED = object()


class Assembly:
    """Per-stream receive buffer with a WRITABLE TAIL: ring/socket drains land
    directly in message storage, removing the scratch-bounce pass (profiled:
    one full extra memory pass per payload byte on the 4 MiB streaming path).

    Backing store is uninitialized numpy memory grown by 2× (each MESSAGE
    frame reserves its announced length up front, so relocations are
    amortized and over-allocation is bounded at 2× the message — consumers
    alias ``take()``'s view, pinning the whole backing array, so waste is
    resident waste). ``take()`` detaches the filled prefix — consumers may
    alias it indefinitely (the tensor codec's zero-copy decode does), so the
    next message gets fresh storage instead of a reuse-after-free."""

    __slots__ = ("_buf", "_used", "oversized")

    def __init__(self):
        self._buf = None
        self._used = 0
        #: the in-flight message tripped the receive-size limit: remaining
        #: fragments are consumed-and-discarded (framing stays in sync) and
        #: the sink's commit delivers RESOURCE_EXHAUSTED instead of a message
        self.oversized = False

    def __len__(self) -> int:
        return self._used

    def reserve(self, n: int) -> None:
        """Ensure ``n`` more bytes are writable after the filled prefix."""
        import numpy as np

        need = self._used + n
        cap = 0 if self._buf is None else self._buf.nbytes
        if need <= cap:
            return
        new = np.empty(max(need, cap * 2, 4096), np.uint8)
        if self._used:
            new[:self._used] = self._buf[:self._used]
            _ledger.host_copy(self._used)  # relocation is a real copy
        self._buf = new

    def tail(self, n: int) -> memoryview:
        """Writable view of the next ``n`` reserved bytes."""
        return memoryview(self._buf.data)[self._used:self._used + n]

    def advance(self, n: int) -> None:
        self._used += n

    def append(self, data) -> None:
        n = len(data)
        if n:
            self.reserve(n)
            self.tail(n)[:] = data
            self._used += n

    def take(self):
        """Detach and return the filled prefix (memoryview over the storage);
        the assembly resets to empty with fresh backing and a clear
        :attr:`oversized` flag."""
        self.oversized = False
        if self._buf is None:
            return memoryview(b"")
        out = memoryview(self._buf.data)[:self._used]
        self._buf = None
        self._used = 0
        return out


class MessageSink:
    """Destination for MESSAGE payload bytes, bypassing Frame materialization.

    The reader drains each fragment's bytes straight into the per-stream
    :class:`Assembly` (one copy off the wire: transport → message storage —
    the receive-side half of the copy ledger the north star optimizes)."""

    #: Largest acceptable assembled message; None = unlimited. Enforced by
    #: the FrameReader BEFORE buffering (an over-limit message is discarded
    #: in transit, never held in memory) — grpc.max_receive_message_length /
    #: resource_quota.cc's receive-side role.
    max_message_bytes = None

    def buffer_for(self, stream_id: int) -> Assembly:
        raise NotImplementedError

    def commit(self, stream_id: int, flags: int) -> None:
        raise NotImplementedError


class FrameReader:
    """Buffered frame parser over the endpoint's read()/read_into() stream."""

    def __init__(self, endpoint: Endpoint, expect_preface: bool = False):
        self._ep = endpoint
        self._buf = bytearray()
        self._eof = False
        self._need_preface = expect_preface
        self._scratch = bytearray(MAX_FRAME_PAYLOAD)
        self._scratch_mv = memoryview(self._scratch)
        self.sink: Optional[MessageSink] = None
        #: tpurpc-pulse: called right before each sink commit.  The
        #: descriptor-ring consumer hangs its drain here so a control op
        #: posted BEFORE this frame was sent (visible in shm by store
        #: order) delivers first — per-stream order survives the split
        #: control plane even for sink-routed MESSAGEs.
        self.pre_commit = None
        # In-flight sink-routed MESSAGE interrupted by ReadTimeout:
        # (dst, rest, stream_id, flags) — resumed by the next read_frame.
        self._pending_msg: Optional[tuple] = None

    #: Opportunistic read-ahead for control structures. One endpoint read
    #: (syscall / ring drain) usually picks up a whole burst of small frames
    #: — header+metadata+message+trailers of the unary fast path — instead of
    #: one read per deficit (profiled: ~10 ring drains per 64B RPC before).
    #: The cost is bounded: at most this many MESSAGE-payload bytes get
    #: dragged through _buf (then handed to the sink from there), noise next
    #: to a saved syscall on the small path and next to the payload itself on
    #: the bulk path (8 KiB per ≥1 MiB frame ≤ 0.8%).
    READ_AHEAD = 8192

    def _fill(self, need: int, timeout: Optional[float] = None) -> bool:
        """Grow the buffer to ≥ need bytes; False on clean EOF first."""
        while len(self._buf) < need:
            if self._eof:
                return False
            want = max(need - len(self._buf), self.READ_AHEAD)
            n = self._ep.read_into(self._scratch_mv[:want], timeout=timeout)
            if n == 0:
                self._eof = True
                return len(self._buf) >= need
            self._buf += self._scratch_mv[:n]
        return True

    def _drain_message(self, dst: Assembly, rest: int, stream_id: int,
                       flags: int, timeout: Optional[float]):
        """Stream the remaining payload straight into the assembly buffer —
        the transport writes message storage directly (no scratch bounce).

        A ReadTimeout mid-payload parks the progress in ``_pending_msg`` so the
        next read_frame resumes exactly where the wire stopped — the framing
        never desyncs."""
        try:
            while rest:
                if dst.oversized:
                    # consume-and-discard through the scratch: the framing
                    # must stay in sync even for rejected messages
                    n = self._ep.read_into(
                        self._scratch_mv[:min(rest, MAX_FRAME_PAYLOAD)],
                        timeout=timeout)
                else:
                    n = self._ep.read_into(dst.tail(rest), timeout=timeout)
                if n == 0:
                    self._eof = True
                    raise FrameError("truncated frame payload at EOF")
                if not dst.oversized:
                    dst.advance(n)
                    _ledger.host_copy(n)
                rest -= n
        except TimeoutError:
            self._pending_msg = (dst, rest, stream_id, flags)
            raise
        self._pending_msg = None
        if self.pre_commit is not None:
            self.pre_commit()
        self.sink.commit(stream_id, flags)
        return CONSUMED

    def read_frame(self, timeout: Optional[float] = None):
        """Next control Frame, CONSUMED for sink-routed MESSAGE frames, or
        None at clean EOF.  Raises EndpointError/FrameError."""
        if self._pending_msg is not None:
            dst, rest, stream_id, flags = self._pending_msg
            return self._drain_message(dst, rest, stream_id, flags, timeout)
        if self._need_preface:
            if not self._fill(len(MAGIC), timeout):
                return None
            if bytes(self._buf[:len(MAGIC)]) != MAGIC:
                raise FrameError(f"bad connection preface: {bytes(self._buf[:8])!r}")
            del self._buf[:len(MAGIC)]
            self._need_preface = False
        if not self._fill(HEADER_FMT.size, timeout):
            if self._buf:
                raise FrameError("truncated frame header at EOF")
            return None
        ftype, flags, stream_id, length = HEADER_FMT.unpack_from(self._buf)
        if length > MAX_FRAME_PAYLOAD:
            raise FrameError(f"frame length {length} exceeds max {MAX_FRAME_PAYLOAD}")
        hdr = HEADER_FMT.size
        if ftype == MESSAGE and self.sink is not None:
            dst = self.sink.buffer_for(stream_id)
            limit = self.sink.max_message_bytes
            if (limit is not None and not dst.oversized
                    and len(dst) + length > limit):
                dst.take()  # free what was buffered; the message is doomed
                dst.oversized = True  # AFTER take() (take clears the flag)
            have = min(length, len(self._buf) - hdr)
            if dst.oversized:
                del self._buf[:hdr + have]
                return self._drain_message(dst, length - have, stream_id,
                                           flags, timeout)
            dst.reserve(length)  # announced frame length: presize ONCE
            if have:
                dst.append(memoryview(self._buf)[hdr:hdr + have])
                _ledger.host_copy(have)
            del self._buf[:hdr + have]
            return self._drain_message(dst, length - have, stream_id, flags,
                                       timeout)
        if not self._fill(hdr + length, timeout):
            raise FrameError("truncated frame payload at EOF")
        payload = bytes(self._buf[hdr:hdr + length])
        del self._buf[:hdr + length]
        return Frame(ftype, flags, stream_id, payload)
