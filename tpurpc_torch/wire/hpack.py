"""HPACK (RFC 7541) — header compression for the gRPC wire-compat path.

A copy of ``tpurpc/wire/hpack.py``; the encoders emit the same bytes.

The reference carries this in ``chttp2/transport/hpack_{parser,encoder,
table}.cc`` (SURVEY.md §2.4); this is a from-scratch implementation of the
spec, not a port: the decoder handles every field representation (indexed,
literal ±indexing, never-indexed, table-size update), huffman-coded strings,
and the dynamic table with eviction; the encoder is the minimal legal one —
literal-without-indexing with raw strings for unknown headers, indexed
fields for static-table hits — stateless by design so a lost frame can never
desynchronize two ends' dynamic tables.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Tuple

from tpurpc_torch.wire.rfc7541_tables import HUFFMAN_CODES, STATIC_TABLE

Header = Tuple[bytes, bytes]


class HpackError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Huffman coding (Appendix B)
# ---------------------------------------------------------------------------

def _build_tree():
    # binary trie: internal node = [zero_branch, one_branch]; leaf = symbol int
    root: list = [None, None]
    for sym, (code, nbits) in enumerate(HUFFMAN_CODES):
        node = root
        for i in range(nbits - 1, -1, -1):
            bit = (code >> i) & 1
            if i == 0:
                node[bit] = sym
            else:
                if node[bit] is None:
                    node[bit] = [None, None]
                node = node[bit]
    return root


_TREE = _build_tree()
_EOS = 256


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    node = _TREE
    depth = 0  # bits consumed since last symbol (for padding validation)
    ones = True  # padding must be a prefix of EOS == all ones
    for byte in data:
        for i in range(7, -1, -1):
            bit = (byte >> i) & 1
            nxt = node[bit]
            depth += 1
            ones = ones and bit == 1
            if nxt is None:
                raise HpackError("invalid huffman code")
            if isinstance(nxt, int):
                if nxt == _EOS:
                    raise HpackError("EOS in huffman string")
                out.append(nxt)
                node = _TREE
                depth = 0
                ones = True
            else:
                node = nxt
    if depth > 7 or not ones:
        raise HpackError("bad huffman padding")
    return bytes(out)


def huffman_encode(data: bytes) -> bytes:
    acc = 0
    nbits = 0
    out = bytearray()
    for b in data:
        code, n = HUFFMAN_CODES[b]
        acc = (acc << n) | code
        nbits += n
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        pad = 8 - nbits
        out.append(((acc << pad) | ((1 << pad) - 1)) & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# Primitive codecs (§5)
# ---------------------------------------------------------------------------

def encode_int(value: int, prefix_bits: int, first_byte_flags: int = 0) -> bytes:
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first_byte_flags | value])
    out = bytearray([first_byte_flags | limit])
    value -= limit
    while value >= 0x80:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data, pos: int, prefix_bits: int) -> Tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    if pos >= len(data):
        raise HpackError("truncated integer")
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer continuation")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if shift > 35:
            raise HpackError("integer overflow")
        if not b & 0x80:
            return value, pos


def decode_string(data, pos: int) -> Tuple[bytes, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huff = bool(data[pos] & 0x80)
    length, pos = decode_int(data, pos, 7)
    if pos + length > len(data):
        raise HpackError("truncated string payload")
    raw = bytes(data[pos:pos + length])
    return (huffman_decode(raw) if huff else raw), pos + length


def encode_string(data: bytes) -> bytes:
    return encode_int(len(data), 7, 0x00) + data


# ---------------------------------------------------------------------------
# Tables (§2.3)
# ---------------------------------------------------------------------------

_STATIC: List[Header] = [
    (n.encode() if n else None, v.encode() if v is not None else b"")
    for n, v in STATIC_TABLE
]
_STATIC_LOOKUP = {}
for _i in range(1, len(_STATIC)):
    _n, _v = _STATIC[_i]
    _STATIC_LOOKUP.setdefault((_n, _v), _i)

_ENTRY_OVERHEAD = 32


class _DynamicTable:
    def __init__(self, max_size: int = 4096, lookup: bool = False):
        self.entries: Deque[Header] = deque()  # most recent first
        self.size = 0
        self.max_size = max_size
        self.cap = max_size  # protocol ceiling (SETTINGS_HEADER_TABLE_SIZE)
        #: encoder-side O(1) reverse lookups: (n, v)/name → absolute add id.
        #: Positions shift on every add, so we store a monotone id instead
        #: and convert at lookup time; evicted ids resolve out of range.
        self._lookup = lookup
        self._abs = 0
        self._by_pair: dict = {}
        self._by_name: dict = {}

    def add(self, name: bytes, value: bytes) -> None:
        need = len(name) + len(value) + _ENTRY_OVERHEAD
        while self.entries and self.size + need > self.max_size:
            evicted_abs = self._abs - len(self.entries)  # oldest entry's id
            n, v = self.entries.pop()
            self.size -= len(n) + len(v) + _ENTRY_OVERHEAD
            if self._lookup:
                # Purge exactly-matching ids so the reverse maps can't grow
                # unboundedly on never-repeated header values (a newer add
                # of the same pair/name keeps its newer id).
                if self._by_pair.get((n, v)) == evicted_abs:
                    del self._by_pair[(n, v)]
                if self._by_name.get(n) == evicted_abs:
                    del self._by_name[n]
        if need <= self.max_size:
            self.entries.appendleft((name, value))
            self.size += need
            if self._lookup:
                self._by_pair[(name, value)] = self._abs
                self._by_name[name] = self._abs
        # else: entry larger than table — spec says result is an empty table
        self._abs += 1  # ids advance even for too-large adds (position math)

    def _abs_to_index(self, abs_id: int) -> Optional[int]:
        """Wire index (1-based) for an absolute add id, or None if evicted."""
        pos = self._abs - 1 - abs_id
        if 0 <= pos < len(self.entries):
            return len(_STATIC) + pos
        return None

    def find(self, name: bytes, value: bytes) -> Optional[int]:
        abs_id = self._by_pair.get((name, value))
        if abs_id is None:
            return None
        idx = self._abs_to_index(abs_id)
        if idx is None:
            del self._by_pair[(name, value)]
        return idx

    def find_name(self, name: bytes) -> Optional[int]:
        abs_id = self._by_name.get(name)
        if abs_id is None:
            return None
        idx = self._abs_to_index(abs_id)
        if idx is None:
            del self._by_name[name]
        return idx

    def resize(self, new_max: int) -> None:
        if new_max > self.cap:
            raise HpackError(f"table size {new_max} above ceiling {self.cap}")
        self.max_size = new_max
        while self.entries and self.size > self.max_size:
            n, v = self.entries.pop()
            self.size -= len(n) + len(v) + _ENTRY_OVERHEAD

    def get(self, index: int) -> Header:
        # index is 1-based; 1..61 static, 62.. dynamic
        if 1 <= index < len(_STATIC):
            return _STATIC[index]
        didx = index - len(_STATIC)
        if 0 <= didx < len(self.entries):
            return self.entries[didx]
        raise HpackError(f"index {index} out of range")


# ---------------------------------------------------------------------------
# Decoder / Encoder
# ---------------------------------------------------------------------------

class HpackDecoder:
    def __init__(self, max_table_size: int = 4096):
        self._table = _DynamicTable(max_table_size)

    def decode(self, block) -> List[Header]:
        data = bytes(block)
        pos = 0
        out: List[Header] = []
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed field
                idx, pos = decode_int(data, pos, 7)
                if idx == 0:
                    raise HpackError("indexed field with index 0")
                out.append(self._table.get(idx))
            elif b & 0x40:  # literal with incremental indexing
                idx, pos = decode_int(data, pos, 6)
                name = (self._table.get(idx)[0] if idx
                        else None)
                if name is None:
                    name, pos = decode_string(data, pos)
                value, pos = decode_string(data, pos)
                self._table.add(name, value)
                out.append((name, value))
            elif b & 0x20:  # dynamic table size update
                new_max, pos = decode_int(data, pos, 5)
                self._table.resize(new_max)
            else:  # literal without indexing (0x00) / never indexed (0x10)
                idx, pos = decode_int(data, pos, 4)
                name = self._table.get(idx)[0] if idx else None
                if name is None:
                    name, pos = decode_string(data, pos)
                value, pos = decode_string(data, pos)
                out.append((name, value))
        return out


#: static name → first index with that name (name-only reference)
_STATIC_NAME_LOOKUP: dict = {}
for _i in range(len(_STATIC) - 1, 0, -1):
    _STATIC_NAME_LOOKUP[_STATIC[_i][0]] = _i


class HpackEncoder:
    """HPACK encoder with an optional dynamic table (RFC 7541 §2.3.2).

    ``dynamic=False`` (the server's response path) stays stateless: static
    hits as indexed fields, everything else literal-without-indexing.

    ``dynamic=True`` (the client path, where :path/:authority/user metadata
    repeat on every call) inserts repeatable headers with incremental
    indexing and emits 1-2 byte indexed fields on subsequent calls. The
    encoder's table mirrors exactly what its own emissions tell the peer's
    decoder to do, so it can never desynchronize.

    Indexing starts DISABLED even with ``dynamic=True``: until the peer's
    SETTINGS arrive the peer's actual table ceiling is unknown (it need not
    be the 4096 default — a 0-size decoder would silently drop our inserts
    and desync on the first indexed reference). Call
    :meth:`apply_peer_table_size` when SETTINGS are processed: it sizes the
    table to ``min(4096, peer)``, queues the RFC 7541 §4.2 dynamic-table
    size update for the front of the next header block when shrinking, and
    enables indexing."""

    #: headers that change per-call and would churn the table
    _NEVER_INDEX = {b"grpc-timeout", b"content-length", b"date"}

    def __init__(self, dynamic: bool = False, max_table_size: int = 4096):
        self._dynamic = dynamic
        self._table = (_DynamicTable(max_table_size, lookup=True)
                       if dynamic else None)
        self._index_enabled = False
        self._pending_size_update: Optional[int] = None

    def apply_peer_table_size(self, peer_max: int) -> None:
        """Peer's SETTINGS_HEADER_TABLE_SIZE processed: enable indexing at
        ``min(default, peer_max)``, emitting the mandated size update at the
        start of the next block when that shrinks our declared size."""
        if self._table is None:
            return
        new = min(4096, peer_max)
        if new < self._table.max_size:
            self._table.cap = new
            self._table.resize(new)
            self._pending_size_update = new
        self._index_enabled = new > 0

    def encode(self, headers) -> bytes:
        out = bytearray()
        if self._pending_size_update is not None:
            out += encode_int(self._pending_size_update, 5, 0x20)
            self._pending_size_update = None
        table = self._table
        for name, value in headers:
            n = name.encode() if isinstance(name, str) else bytes(name)
            v = value.encode() if isinstance(value, str) else bytes(value)
            idx = _STATIC_LOOKUP.get((n, v))
            if idx is not None:
                out += encode_int(idx, 7, 0x80)
                continue
            if table is not None:
                idx = table.find(n, v)
                if idx is not None:
                    out += encode_int(idx, 7, 0x80)
                    continue
            name_idx = _STATIC_NAME_LOOKUP.get(n)
            if name_idx is None and table is not None:
                name_idx = table.find_name(n)
            if self._index_enabled and n not in self._NEVER_INDEX:
                # literal WITH incremental indexing: the peer's decoder adds
                # it; we mirror the add so future lookups hit
                out += encode_int(name_idx or 0, 6, 0x40)
                if name_idx is None:
                    out += encode_string(n)
                out += encode_string(v)
                table.add(n, v)
            else:
                out += encode_int(name_idx or 0, 4, 0x00)
                if name_idx is None:
                    out += encode_string(n)
                out += encode_string(v)
        return bytes(out)
