"""Protobuf varints for the hand-rolled standard services (the health
service's one-field messages): the two functions of
``tpurpc/wire/protowire.py`` that :mod:`tpurpc_torch.rpc.health` needs."""

from __future__ import annotations

from typing import Tuple


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
