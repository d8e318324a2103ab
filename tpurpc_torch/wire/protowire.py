"""Minimal protobuf wire-format primitives shared by the hand-rolled
standard services (:mod:`tpurpc_torch.rpc.health`). A copy of
``tpurpc/wire/protowire.py``.

These modules speak real protobuf on the wire without a protobuf dependency
— their messages are a handful of scalar fields. One copy of the varint /
tag / field-walk math lives here so a robustness fix reaches every user.
"""

from __future__ import annotations

from typing import Iterator, Tuple, Union


def encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = val = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def ld(field_no: int, payload: bytes) -> bytes:
    """A length-delimited (wire type 2) field.

    The tag is a VARINT like any other (a raw ``bytes([tag])`` is invalid
    past field 15 — tag ≥ 128 sets the continuation bit and the decoder
    eats the length byte as tag continuation; latent until a field number
    ≥ 16 exists, caught by the xds_v3 fuzz test)."""
    return encode_varint((field_no << 3) | 2) + encode_varint(
        len(payload)) + payload


def vf(field_no: int, value: int) -> bytes:
    """A varint (wire type 0) field; proto3 default-0 is omitted."""
    if not value:
        return b""
    return encode_varint((field_no << 3) | 0) + encode_varint(int(value))


def fields(data: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield ``(field_no, wire_type, value)`` over a serialized message.

    Raises :class:`ValueError` on any truncation — a field whose declared
    length runs past the buffer is corruption, not a short message, and
    must not be silently answered as if valid.
    """
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = decode_varint(data, pos)
        field_no, wt = tag >> 3, tag & 0x07
        if wt == 0:
            val, pos = decode_varint(data, pos)
        elif wt == 2:
            ln, pos = decode_varint(data, pos)
            if pos + ln > n:
                raise ValueError(f"field {field_no} truncated "
                                 f"({ln} declared, {n - pos} left)")
            val = data[pos:pos + ln]
            pos += ln
        elif wt == 5:
            if pos + 4 > n:
                raise ValueError(f"field {field_no} truncated fixed32")
            val = data[pos:pos + 4]
            pos += 4
        elif wt == 1:
            if pos + 8 > n:
                raise ValueError(f"field {field_no} truncated fixed64")
            val = data[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field_no, wt, val
