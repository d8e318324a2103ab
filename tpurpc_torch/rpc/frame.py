"""tpurpc native wire format: multiplexed frames over one byte-pipe endpoint.

A trimmed copy of ``tpurpc/rpc/frame.py`` (no compression, no control-ring
frames, no cross-stream write coalescing). Frame layout, little-endian::

    [u8 type][u8 flags][u32 stream_id][u32 length] [payload: length bytes]

Frame types: HEADERS, MESSAGE, TRAILERS, RST, PING, PONG, GOAWAY, and the
rendezvous control frames RDV_OFFER, RDV_CLAIM, RDV_COMPLETE, RDV_RELEASE. A
MESSAGE larger than ``MAX_FRAME_PAYLOAD`` is split into fragments with the
MORE flag on all but the last; with the connection's rendezvous link bound
(``FrameWriter.rdv``) a MESSAGE over the size bar is written into the peer's
landing region instead and only its control frames ride the connection. Metadata: ``u16 count`` then per entry ``u16 keylen,
key-utf8, u32 vallen, value``; keys ending in ``-bin`` carry binary values.
"""

from __future__ import annotations

import struct
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tpurpc_torch.core.endpoint import Endpoint
from tpurpc_torch.rpc.status import StatusCode
from tpurpc_torch.tpu import ledger as _ledger

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
# rendezvous control frames (core/rendezvous.py): the bulk payload is
# written into the receiver's landing region and these small frames are all
# the connection carries for it. Sent only after the peer's hello.
RDV_OFFER = 8
RDV_CLAIM = 9
RDV_COMPLETE = 10
RDV_RELEASE = 11

#: rendezvous op <-> frame type
RDV_FRAME_OF_OP = {1: RDV_OFFER, 2: RDV_CLAIM, 3: RDV_COMPLETE,
                   4: RDV_RELEASE}
RDV_OP_OF_FRAME = {v: k for k, v in RDV_FRAME_OF_OP.items()}

# flags
FLAG_END_STREAM = 0x01  # sender half-closes this stream
FLAG_MORE = 0x02        # this MESSAGE frame is a fragment; more follow
FLAG_NO_MESSAGE = 0x04  # MESSAGE frame carrying no message (pure half-close)
FLAG_REFUSED = 0x10     # RST only: refused before any handler ran

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
        return (f"<Frame type={self.type} sid={self.stream_id} "
                f"flags={self.flags:#x} len={len(self.payload)}>")


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
        # bound the status message so trailers always fit one control frame
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


def _segments(payload) -> List[memoryview]:
    segs = ([memoryview(s).cast("B") for s in payload]
            if isinstance(payload, (list, tuple)) else
            [memoryview(payload).cast("B")])
    return [s for s in segs if len(s)]


class FrameWriter:
    """Serializes frame writes from many threads onto one endpoint: one
    writer at a time, gather slices, large messages fragmented (a lock per
    fragment, so other streams' frames interleave)."""

    def __init__(self, endpoint: Endpoint):
        self._ep = endpoint
        self._lock = threading.Lock()
        #: the connection's rendezvous link, bound by the owning connection:
        #: a MESSAGE over the size bar is written into the peer's landing
        #: region instead of fragmented frames
        self.rdv = None

    def send(self, ftype: int, flags: int, stream_id: int,
             payload: "bytes | Sequence" = b"") -> None:
        """Write one logical frame; a MESSAGE payload may be a gather list
        (the tensor codec's segments), scatter-written with no joins."""
        segs = _segments(payload)
        total = sum(len(s) for s in segs)
        rdv = self.rdv
        if (rdv is not None and ftype == MESSAGE and total
                and not (flags & (FLAG_NO_MESSAGE | FLAG_MORE))
                and rdv.eligible(total)
                and rdv.send_message(stream_id, flags, segs, total)):
            return  # payload placed; its COMPLETE is already framed
        if total <= MAX_FRAME_PAYLOAD:
            with self._lock:
                self._ep.write(
                    [HEADER_FMT.pack(ftype, flags, stream_id, total)] + segs)
            return
        if ftype != MESSAGE:
            # control frames don't fragment: fail this caller, not the
            # whole multiplexed connection
            raise FrameError(f"control frame payload {total} exceeds "
                             f"{MAX_FRAME_PAYLOAD}; metadata too large")
        self._send_fragmented(flags, stream_id, segs, total)

    def _send_fragmented(self, flags: int, stream_id: int,
                         segs: List[memoryview], total: int) -> None:
        sent = 0
        si = 0  # current segment index
        so = 0  # offset within the current segment
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
            fl = (flags if sent >= total
                  else (flags & ~FLAG_END_STREAM) | FLAG_MORE)
            with self._lock:
                self._ep.write(
                    [HEADER_FMT.pack(MESSAGE, fl, stream_id, n)] + frame_segs)

    def send_many(self, frames: Sequence[Tuple[int, int, int, "bytes | Sequence"]]
                  ) -> None:
        """Write several frames in ONE endpoint write (one transport notify
        instead of one per frame). Oversized MESSAGE frames fragment, in
        order. A batch holding a MESSAGE for rendezvous goes frame by frame:
        its COMPLETE is framed in sequence, so stream order holds."""
        rdv = self.rdv
        if rdv is not None:
            for ftype, flags, _sid, payload in frames:
                if ftype != MESSAGE or flags & (FLAG_NO_MESSAGE | FLAG_MORE):
                    continue
                n = (sum(len(s) for s in payload)
                     if isinstance(payload, (list, tuple)) else len(payload))
                if rdv.eligible(n):
                    for f in frames:
                        self.send(*f)
                    return
        encoded = []
        for ftype, flags, stream_id, payload in frames:
            segs = _segments(payload)
            total = sum(len(s) for s in segs)
            if total > MAX_FRAME_PAYLOAD and ftype != MESSAGE:
                raise FrameError(f"control frame payload {total} exceeds "
                                 f"{MAX_FRAME_PAYLOAD}; metadata too large")
            encoded.append((ftype, flags, stream_id, segs, total))
        batch: List = []
        for ftype, flags, stream_id, segs, total in encoded:
            if total > MAX_FRAME_PAYLOAD:
                if batch:
                    with self._lock:
                        self._ep.write(batch)
                    batch = []
                self._send_fragmented(flags, stream_id, segs, total)
                continue
            batch.append(HEADER_FMT.pack(ftype, flags, stream_id, total))
            batch.extend(segs)
        if batch:
            with self._lock:
                self._ep.write(batch)

    def send_preface(self) -> None:
        with self._lock:
            self._ep.write(MAGIC)


#: returned by read_frame when a MESSAGE frame was routed to the sink
CONSUMED = object()


class Assembly:
    """Per-stream receive buffer with a writable tail: transport drains land
    directly in message storage. ``take()`` detaches the filled prefix —
    consumers may alias it indefinitely (the tensor codec does), so the next
    message gets fresh storage."""

    __slots__ = ("_buf", "_used", "oversized")

    def __init__(self):
        self._buf = None
        self._used = 0
        #: the in-flight message tripped the receive limit: its remaining
        #: fragments are consumed and discarded
        self.oversized = False

    def __len__(self) -> int:
        return self._used

    def reserve(self, n: int) -> None:
        """Ensure ``n`` more bytes are writable after the filled prefix."""
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
        """Detach and return the filled prefix; reset to empty."""
        self.oversized = False
        if self._buf is None:
            return memoryview(b"")
        out = memoryview(self._buf.data)[:self._used]
        self._buf = None
        self._used = 0
        return out


class MessageSink:
    """Destination for MESSAGE payload bytes, bypassing Frame objects."""

    #: largest acceptable assembled message; None = unlimited
    max_message_bytes = None

    def buffer_for(self, stream_id: int) -> Assembly:
        raise NotImplementedError

    def commit(self, stream_id: int, flags: int) -> None:
        raise NotImplementedError


class FrameReader:
    """Buffered frame parser over the endpoint's read_into() stream."""

    #: opportunistic read-ahead for small control frames
    READ_AHEAD = 8192

    def __init__(self, endpoint: Endpoint, expect_preface: bool = False):
        self._ep = endpoint
        self._buf = bytearray()
        self._eof = False
        self._need_preface = expect_preface
        self._scratch = bytearray(MAX_FRAME_PAYLOAD)
        self._scratch_mv = memoryview(self._scratch)
        self.sink: Optional[MessageSink] = None
        #: sink-routed MESSAGE interrupted by ReadTimeout, resumed next call
        self._pending_msg: Optional[tuple] = None

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
        """Stream the rest of a payload straight into the assembly buffer."""
        try:
            while rest:
                if dst.oversized:
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
        self.sink.commit(stream_id, flags)
        return CONSUMED

    def read_frame(self, timeout: Optional[float] = None):
        """Next control Frame, CONSUMED for a sink-routed MESSAGE, or None at
        clean EOF. Raises EndpointError/FrameError."""
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
            dst.reserve(length)  # announced frame length: presize once
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
