"""HTTP/2 framing layer (RFC 7540 subset sufficient for gRPC).

A copy of ``tpurpc/wire/h2.py``; every ``pack_*`` emits the same bytes.

Covers exactly what a gRPC peer exercises: SETTINGS exchange, HEADERS(+
CONTINUATION), DATA with connection+stream flow control, WINDOW_UPDATE,
PING, RST_STREAM, GOAWAY. No push, no priority tree (PRIORITY frames are
parsed and ignored, like every modern implementation).

Reference: ``chttp2/transport/frame_*.cc`` + ``flow_control.cc``
(SURVEY.md §2.4) — re-derived from the RFC, not ported.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

FLAG_END_STREAM = 0x1   # DATA, HEADERS
FLAG_ACK = 0x1          # SETTINGS, PING
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
SETTINGS_MAX_HEADER_LIST_SIZE = 0x6

#: rendezvous over the gRPC wire: an EXTENSION frame type
#: carrying the rendezvous offer/claim/complete/release control messages
#: (the FLAGS byte is the op from tpurpc_torch.core.rendezvous; the bulk payload
#: itself bypasses DATA/flow-control entirely via the one-sided landing
#: region), negotiated through a custom SETTINGS identifier. Both are safe
#: against stock peers by RFC 7540: implementations MUST ignore unknown
#: frame types (§4.1) and unknown settings (§6.5.2) — a vanilla grpcio
#: peer never advertises the setting, so it never sees the frame.
TPURPC_RDV = 0xF0
SETTINGS_TPURPC_RDV = 0xF0F0

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384

# gRPC error-ish codes we emit
NO_ERROR = 0x0
PROTOCOL_ERROR = 0x1
FLOW_CONTROL_ERROR = 0x3
CANCEL = 0x8

_HDR = struct.Struct("!I")  # we pack the 24-bit length by slicing


class H2Error(ConnectionError):
    pass


def pack_frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> List[bytes]:
    if len(payload) > (1 << 24) - 1:
        raise H2Error("frame too large")
    head = (len(payload).to_bytes(3, "big") + bytes([ftype, flags]) +
            (stream_id & 0x7FFFFFFF).to_bytes(4, "big"))
    return [head, payload] if payload else [head]


def pack_settings(settings: Dict[int, int], ack: bool = False) -> List[bytes]:
    payload = b"".join(struct.pack("!HI", k, v) for k, v in settings.items())
    return pack_frame(SETTINGS, FLAG_ACK if ack else 0, 0, payload)


def parse_settings(payload: bytes) -> Dict[int, int]:
    if len(payload) % 6:
        raise H2Error("malformed SETTINGS")
    out = {}
    for i in range(0, len(payload), 6):
        k, v = struct.unpack_from("!HI", payload, i)
        out[k] = v
    return out


def validate_settings(settings: Dict[int, int]) -> None:
    """RFC 7540 §6.5.2 range checks for the values we ACT on — a peer's
    MAX_FRAME_SIZE outside [16384, 2^24-1] or INITIAL_WINDOW_SIZE above
    2^31-1 is a connection error, not a loop-step size to adopt (a zero
    max-frame would spin the send loop forever; an unsigned-huge window
    delta would blow FlowWindow past its overflow guard later)."""
    if SETTINGS_MAX_FRAME_SIZE in settings:
        v = settings[SETTINGS_MAX_FRAME_SIZE]
        if not (16384 <= v <= (1 << 24) - 1):
            raise H2Error(f"SETTINGS_MAX_FRAME_SIZE {v} outside "
                          "[16384, 2^24-1] (PROTOCOL_ERROR)")
    if SETTINGS_INITIAL_WINDOW_SIZE in settings:
        v = settings[SETTINGS_INITIAL_WINDOW_SIZE]
        if v > 0x7FFFFFFF:
            raise H2Error(f"SETTINGS_INITIAL_WINDOW_SIZE {v} exceeds "
                          "2^31-1 (FLOW_CONTROL_ERROR)")


def pack_goaway(last_stream: int, code: int, debug: bytes = b"") -> List[bytes]:
    return pack_frame(GOAWAY, 0, 0,
                      struct.pack("!II", last_stream & 0x7FFFFFFF, code) + debug)


def pack_rst(stream_id: int, code: int) -> List[bytes]:
    return pack_frame(RST_STREAM, 0, stream_id, struct.pack("!I", code))


def pack_window_update(stream_id: int, increment: int) -> List[bytes]:
    return pack_frame(WINDOW_UPDATE, 0, stream_id,
                      struct.pack("!I", increment & 0x7FFFFFFF))


def strip_padding(flags: int, payload: bytes, has_priority: bool) -> bytes:
    """Remove PADDED/PRIORITY envelope from HEADERS/DATA payloads."""
    pos = 0
    pad = 0
    if flags & FLAG_PADDED:
        if not payload:
            raise H2Error("padded frame with empty payload")
        pad = payload[0]
        pos = 1
    if has_priority and flags & FLAG_PRIORITY:
        pos += 5
    if pad > len(payload) - pos:
        raise H2Error("padding exceeds payload")
    return payload[pos:len(payload) - pad]


class FlowWindow:
    """A send-direction flow-control window: block until credit arrives."""

    def __init__(self, initial: int):
        self._value = initial
        self._cv = threading.Condition()
        self._dead = False

    def take(self, want: int, timeout: Optional[float] = None) -> int:
        """Reserve up to ``want`` bytes; blocks while the window is empty."""
        with self._cv:
            while self._value <= 0 and not self._dead:
                if not self._cv.wait(timeout=timeout):
                    raise TimeoutError("flow-control window starved")
            if self._dead:
                raise H2Error("connection closed")
            got = min(want, self._value)
            self._value -= got
            return got

    def grant(self, n: int) -> None:
        with self._cv:
            self._value += n
            if self._value > 0x7FFFFFFF:
                raise H2Error("window overflow")
            self._cv.notify_all()

    def adjust(self, delta: int) -> None:
        """SETTINGS_INITIAL_WINDOW_SIZE change retro-adjusts stream windows."""
        with self._cv:
            self._value += delta
            self._cv.notify_all()

    def kill(self) -> None:
        with self._cv:
            self._dead = True
            self._cv.notify_all()

    def try_take(self, want: int) -> bool:
        """Reserve exactly ``want`` bytes iff fully available right now —
        the non-blocking probe the fused (single-write) response path uses;
        callers fall back to the blocking chunked path on False."""
        with self._cv:
            if self._dead or self._value < want:
                return False
            self._value -= want
            return True


class FrameScanner:
    """Incremental frame parser over a growing byte buffer."""

    def __init__(self):
        self.buf = bytearray()

    def feed(self, data) -> None:
        self.buf += data

    def next_frame(self) -> Optional[Tuple[int, int, int, bytes]]:
        if len(self.buf) < 9:
            return None
        length = int.from_bytes(self.buf[:3], "big")
        if len(self.buf) < 9 + length:
            return None
        ftype = self.buf[3]
        flags = self.buf[4]
        stream_id = int.from_bytes(self.buf[5:9], "big") & 0x7FFFFFFF
        payload = bytes(self.buf[9:9 + length])
        del self.buf[:9 + length]
        return ftype, flags, stream_id, payload

    def next_frames(self) -> List[Tuple[int, int, int, bytes]]:
        """Every complete frame currently buffered, in order (the burst the
        last transport read delivered). One endpoint read on the tensor path
        typically carries a run of DATA frames for one stream — returning
        the burst lets receivers coalesce them into a single dispatch
        instead of re-entering the parser per frame."""
        out: List[Tuple[int, int, int, bytes]] = []
        while True:
            f = self.next_frame()
            if f is None:
                return out
            out.append(f)
