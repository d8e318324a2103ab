"""The port's HPACK (``tpurpc_torch.wire.hpack``) against the reference's
(``tpurpc.wire.hpack``).

Seeded header lists — static-table hits, static names with new values,
new names, ``-bin`` values, long values past one integer prefix — go
through both encoders: the stateless one (the server's) and the dynamic one
(the client's, with insertion, eviction and table-size updates at several
peer table sizes). The bytes must be equal, and each package's decoder must
read the other's output back to the same headers. Huffman strings and the
integer codec are compared alone, and malformed blocks raise ``HpackError``
with the same message in both. Tolerance: exact.
"""

import numpy as np
import pytest

from tpurpc.wire import hpack as jh
from tpurpc_torch.wire import hpack as th
from tpurpc_torch.wire import rfc7541_tables as ttables
from tpurpc.wire import rfc7541_tables as jtables

SEEDS = list(range(8))

_STATIC_PAIRS = [(":method", "POST"), (":scheme", "http"), (":status", "200"),
                 (":path", "/"), ("accept-encoding", "gzip, deflate")]
_STATIC_NAMES = [":authority", ":path", "content-type", "user-agent", "te",
                 "content-length", "date", "accept"]


def _headers(rng, n):
    """``n`` seeded (name, value) pairs drawn from every encoder branch."""
    out = []
    for _ in range(n):
        kind = int(rng.integers(0, 5))
        if kind == 0:
            out.append(_STATIC_PAIRS[int(rng.integers(len(_STATIC_PAIRS)))])
        elif kind == 1:
            name = _STATIC_NAMES[int(rng.integers(len(_STATIC_NAMES)))]
            out.append((name, f"v{int(rng.integers(0, 4))}"))
        elif kind == 2:
            out.append((f"x-key-{int(rng.integers(0, 6))}",
                        "y" * int(rng.integers(0, 300))))
        elif kind == 3:
            out.append((f"x-blob-{int(rng.integers(0, 3))}-bin",
                        rng.integers(0, 256, int(rng.integers(1, 40)),
                                     dtype=np.uint8).tobytes()))
        else:
            out.append(("grpc-timeout", f"{int(rng.integers(1, 10**6))}m"))
    return out


def _as_bytes(headers):
    return [(n.encode() if isinstance(n, str) else n,
             v.encode() if isinstance(v, str) else v) for n, v in headers]


def test_tables_equal():
    assert ttables.HUFFMAN_CODES == jtables.HUFFMAN_CODES
    assert ttables.STATIC_TABLE == jtables.STATIC_TABLE


@pytest.mark.parametrize("seed", SEEDS)
def test_stateless_encoder_bytes_equal_and_cross_decode(seed):
    rng = np.random.default_rng(seed)
    blocks = [_headers(rng, int(rng.integers(1, 12))) for _ in range(6)]
    jenc, tenc = jh.HpackEncoder(), th.HpackEncoder()
    jdec, tdec = jh.HpackDecoder(), th.HpackDecoder()
    for hdrs in blocks:
        jb, tb = jenc.encode(hdrs), tenc.encode(hdrs)
        assert tb == jb
        assert tdec.decode(jb) == jdec.decode(tb) == _as_bytes(hdrs)


@pytest.mark.parametrize("table", [4096, 512, 96, 0])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_dynamic_encoder_bytes_equal_with_eviction_and_resize(seed, table):
    """The client's dynamic table: indexing from the first SETTINGS, blocks
    that repeat headers (indexed hits) and overflow small tables
    (eviction), then a shrink mid-stream (the §4.2 size update at the front
    of the next block)."""
    rng = np.random.default_rng(100 + seed)
    pool = _headers(rng, 10)
    jenc, tenc = jh.HpackEncoder(dynamic=True), th.HpackEncoder(dynamic=True)
    jdec, tdec = jh.HpackDecoder(), th.HpackDecoder()
    for i in range(16):
        if i == 1:
            jenc.apply_peer_table_size(table)
            tenc.apply_peer_table_size(table)
        if i == 9:
            jenc.apply_peer_table_size(table // 2)
            tenc.apply_peer_table_size(table // 2)
        idx = rng.integers(0, len(pool), int(rng.integers(1, 8)))
        hdrs = [pool[int(k)] for k in idx] + _headers(rng, 1)
        jb, tb = jenc.encode(hdrs), tenc.encode(hdrs)
        assert tb == jb, i
        assert tdec.decode(jb) == jdec.decode(tb) == _as_bytes(hdrs)
    assert tdec._table.size == jdec._table.size
    assert list(tdec._table.entries) == list(jdec._table.entries)


@pytest.mark.parametrize("seed", SEEDS)
def test_huffman_bytes_equal_and_cross_decode(seed):
    rng = np.random.default_rng(200 + seed)
    for n in (0, 1, 7, 64, 500):
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        jb, tb = jh.huffman_encode(raw), th.huffman_encode(raw)
        assert tb == jb
        assert th.huffman_decode(jb) == jh.huffman_decode(tb) == raw


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_decoders_read_huffman_literals_alike(seed):
    """Blocks the encoders never emit (huffman strings, indexed names with
    incremental indexing, never-indexed fields, size updates): both
    decoders give the same headers and the same table."""
    rng = np.random.default_rng(300 + seed)
    block = bytearray(jh.encode_int(256, 5, 0x20))      # size update
    for k in range(12):
        name = f"x-h{int(rng.integers(0, 5))}".encode()
        value = rng.integers(32, 127, int(rng.integers(0, 60)),
                             dtype=np.uint8).tobytes()
        hv = jh.huffman_encode(value)
        form = k % 3
        if form == 0:    # literal with incremental indexing, new name
            block += b"\x40" + jh.encode_int(len(name), 7, 0) + name
        elif form == 1:  # never indexed, static name index 4 (:path)
            block += jh.encode_int(4, 4, 0x10)
        else:            # without indexing, huffman name
            hn = jh.huffman_encode(name)
            block += b"\x00" + jh.encode_int(len(hn), 7, 0x80) + hn
        block += jh.encode_int(len(hv), 7, 0x80) + hv
    block += jh.encode_int(62, 7, 0x80)                  # newest dynamic entry
    jdec, tdec = jh.HpackDecoder(), th.HpackDecoder()
    assert tdec.decode(bytes(block)) == jdec.decode(bytes(block))
    assert list(tdec._table.entries) == list(jdec._table.entries)


@pytest.mark.parametrize("prefix", [4, 5, 6, 7])
def test_integer_codec_equal(prefix):
    for v in (0, 1, (1 << prefix) - 2, (1 << prefix) - 1, 1 << prefix, 127,
              128, 1337, 4096, 1 << 20, (1 << 31) - 1):
        jb = jh.encode_int(v, prefix, 0)
        assert th.encode_int(v, prefix, 0) == jb
        assert th.decode_int(jb, 0, prefix) == jh.decode_int(jb, 0, prefix) \
            == (v, len(jb))


MALFORMED = {
    "index 0": b"\x80",
    "index past the tables": b"\xbf",
    "integer overflow": b"\x7f\xff\xff\xff\xff\xff\xff\x01",
    "truncated integer": b"\x0f",
    "truncated string": b"\x40",
    "truncated string payload": b"\x40\x85abc",
    "size update above ceiling": jh.encode_int(8192, 5, 0x20),
    "bad huffman padding": b"\x00\x81a\x81\x00",
    "EOS in huffman": b"\x00\x81a\x84\xff\xff\xff\xff",
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_malformed_block_raises_in_both(name):
    block = MALFORMED[name]
    with pytest.raises(jh.HpackError) as jerr:
        jh.HpackDecoder().decode(block)
    with pytest.raises(th.HpackError) as terr:
        th.HpackDecoder().decode(block)
    assert str(terr.value) == str(jerr.value)
    assert issubclass(th.HpackError, ValueError)
