"""Message compression on the port's native framing (``FLAG_COMPRESSED``)
against the reference's.

Twins of ``tests/test_compression.py``: the writer's gzip step, the
channel's opt-in (``compression=`` and grpcio's
``grpc.default_compression_algorithm``), the server's mirror on replies,
compression before fragmentation, a corrupt stream (INTERNAL), the
gzip-bomb guard (RESOURCE_EXHAUSTED past the receive limit on the inflated
size), and the flag cleared for a payload gzip would enlarge. Round trips
also run across packages, the writer's compressed frames are compared with
the reference's byte for byte, and a compressed tensor request lands in
the port's device ring (on the CPU) as an uncompressed one does.
"""

import gzip
import os
import warnings

import numpy as np
import pytest
import torch

from tpurpc.rpc import frame as ref_fr
from tpurpc_torch.rpc import frame as port_fr
from torch_call_plane import (PORT, REF, code_name, counted_plain,  # noqa: F401
                              platform, small_classify)

FR = {"ref": ref_fr, "port": port_fr}
PKGS = {"ref": REF, "port": PORT}
#: (server, client) package pairs of the wire cases
PAIRS = [("port", "port"), ("ref", "port"), ("port", "ref")]


def _echo_server(pkg, **kw):
    if pkg is REF:
        kw.setdefault("native_dataplane", False)
    srv = pkg.server.Server(max_workers=4, **kw)
    srv.add_method("/c.S/Echo", pkg.server.unary_unary_rpc_method_handler(
        lambda r, c: bytes(r)))

    def dbl(req_iter, ctx):
        for m in req_iter:
            yield bytes(m) * 2

    srv.add_method("/c.S/Dbl", pkg.server.stream_stream_rpc_method_handler(
        dbl))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _unary(pkg, ch, path):
    if pkg is REF:
        return ch.unary_unary(path, tpurpc_native=False)
    return ch.unary_unary(path)


def _stream(pkg, ch, path):
    if pkg is REF:
        return ch.stream_stream(path, tpurpc_native=False)
    return ch.stream_stream(path)


class _Ep:
    def __init__(self):
        self.wrote = []

    def write(self, bufs):
        if isinstance(bufs, (bytes, bytearray, memoryview)):
            bufs = [bufs]
        self.wrote.append(b"".join(bytes(b) for b in bufs))


@pytest.mark.parametrize("name", ["ref", "port"])
def test_writer_compresses_flagged_messages(name):
    """FLAG_COMPRESSED in: a gzip payload on the wire, the flag kept;
    unflagged messages untouched."""
    fr = FR[name]
    ep = _Ep()
    w = fr.FrameWriter(ep)
    body = b"A" * 4096  # compressible
    w.send(fr.MESSAGE, fr.FLAG_COMPRESSED | fr.FLAG_END_STREAM, 1, body)
    frame = ep.wrote[0]
    ftype, flags, sid, ln = fr.HEADER_FMT.unpack(frame[:fr.HEADER_FMT.size])
    assert flags & fr.FLAG_COMPRESSED
    payload = frame[fr.HEADER_FMT.size:]
    assert len(payload) == ln < len(body)  # smaller on the wire
    assert gzip.decompress(payload) == body
    ep.wrote.clear()
    w.send(fr.MESSAGE, 0, 1, body)
    assert ep.wrote[0][fr.HEADER_FMT.size:] == body


def _frames_no_mtime(blob: bytes, hdr) -> bytes:
    """A writev's bytes with each compressed frame's gzip mtime zeroed (the
    header field gzip fills from the clock)."""
    out = bytearray(blob)
    pos = 0
    while pos + hdr.size <= len(out):
        _t, flags, _sid, ln = hdr.unpack_from(out, pos)
        body = pos + hdr.size
        if flags & 0x08 and out[body:body + 2] == b"\x1f\x8b":
            out[body + 4:body + 8] = b"\x00" * 4
        pos = body + ln
    return bytes(out)


def test_writer_compressed_frames_equal_reference():
    """With the same frames in, the writer's writev segments hold the
    reference's bytes: compressed, gather-listed, fragmenting after
    compression, incompressible (flag cleared), and fused."""
    rng = np.random.default_rng(5)
    noise = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    big = (b"tensor " * 200_000)[:(1 << 20) * 3]  # compresses below 1 MiB
    big_noise = rng.integers(0, 256, (1 << 20) + 77, dtype=np.uint8).tobytes()

    def run(fr):
        ep = _Ep()
        w = fr.FrameWriter(ep)
        c = fr.FLAG_COMPRESSED
        w.send(fr.MESSAGE, c | fr.FLAG_END_STREAM, 1, b"A" * 4096)
        w.send(fr.MESSAGE, c, 3, [b"x" * 100, memoryview(b"y" * 300)])
        w.send(fr.MESSAGE, c, 5, noise)
        w.send(fr.MESSAGE, c, 7, big)
        w.send(fr.MESSAGE, c, 9, big_noise)
        w.send_many([(fr.HEADERS, 0, 11, b"h" * 12),
                     (fr.MESSAGE, c | fr.FLAG_END_STREAM, 11, b"q" * 5000)])
        return [_frames_no_mtime(b, fr.HEADER_FMT) for b in ep.wrote]

    assert run(port_fr) == run(ref_fr)


@pytest.mark.parametrize("spelling", ["gzip", 2])
@pytest.mark.parametrize("server,client", PAIRS)
def test_compressed_unary_and_streaming_round_trip(spelling, server, client,
                                                   monkeypatch, platform):
    """With compression on, payloads survive, and the server mirrors the
    encoding on its replies (seen as the client's decompressions)."""
    platform("TCP")
    spkg, cpkg = PKGS[server], PKGS[client]
    cfr = FR[client]
    decompressions = []
    real = cfr.decompress_message
    monkeypatch.setattr(
        cfr, "decompress_message",
        lambda data, limit=None: decompressions.append(1) or real(data,
                                                                  limit))
    srv, port = _echo_server(spkg)
    try:
        with cpkg.channel.Channel(f"127.0.0.1:{port}",
                                  compression=spelling) as ch:
            body = b"compressible " * 1000
            assert bytes(_unary(cpkg, ch, "/c.S/Echo")(body, timeout=15)) \
                == body
            assert decompressions, "the reply was not mirrored compressed"
            out = [bytes(m) for m in _stream(cpkg, ch, "/c.S/Dbl")(
                iter([b"a" * 100, b"b" * 100]), timeout=15)]
            assert out == [b"a" * 200, b"b" * 200]
    finally:
        srv.stop(grace=0)


def test_compressed_large_message_fragments(platform):
    """A compressed message still over 1 MiB crosses the frame bound:
    compression before fragmentation, reassembly before gunzip."""
    platform("TCP")
    srv, port = _echo_server(PORT)
    try:
        with PORT.channel.Channel(f"127.0.0.1:{port}",
                                  compression="gzip") as ch:
            body = os.urandom(3 << 20)  # incompressible: stays 3 MiB
            assert ch.unary_unary("/c.S/Echo")(body, timeout=60) == body
    finally:
        srv.stop(grace=0)


def test_corrupt_compressed_request_aborts_cleanly(platform):
    """A flagged message that does not gunzip fails THAT call INTERNAL;
    the connection survives for the next call."""
    platform("TCP")
    fr = port_fr
    srv, port = _echo_server(PORT)
    try:
        with PORT.channel.Channel(f"127.0.0.1:{port}") as ch:
            conn = ch._connection()
            st = conn.open_stream()
            conn.writer.send(fr.HEADERS, 0, st.stream_id,
                             fr.headers_payload("/c.S/Echo", (), None))
            # FLAG_COMPRESSED garbage, written past the writer's gzip step
            payload = b"\x00garbage-not-gzip\xff"
            conn.writer._ep.write([fr.HEADER_FMT.pack(
                fr.MESSAGE, fr.FLAG_END_STREAM | fr.FLAG_COMPRESSED,
                st.stream_id, len(payload)), payload])
            while True:
                ev = st.events.get(timeout=15)
                if ev[0] == "trailers":
                    assert ev[1] is PORT.status.StatusCode.INTERNAL
                    assert "decompress" in ev[2]
                    break
            assert ch.unary_unary("/c.S/Echo")(b"ok", timeout=15) == b"ok"
    finally:
        srv.stop(grace=0)


def test_deflate_accepted_as_compression():
    """grpcio's Compression.Deflate (1) constructs: the framing honors the
    intent with its one codec."""
    for value in ("deflate", 1):
        ch = PORT.channel.Channel("127.0.0.1:1", compression=value)
        assert ch._compress_flag == port_fr.FLAG_COMPRESSED
        ch.close()


def test_unknown_compression_degrades_with_warning():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ch = PORT.channel.Channel("127.0.0.1:1", compression="snappy")
    assert ch._compress_flag == 0
    assert any("snappy" in str(w.message) for w in caught)
    ch.close()


def test_channel_options_compression(platform):
    """grpcio's grpc.default_compression_algorithm (2 = gzip) turns the
    framing's compression on."""
    platform("TCP")
    srv, port = _echo_server(PORT)
    try:
        ch = PORT.rpc.insecure_channel(
            f"127.0.0.1:{port}",
            options=[("grpc.default_compression_algorithm", 2)])
        assert ch._compress_flag == port_fr.FLAG_COMPRESSED
        assert ch.unary_unary("/c.S/Echo")(b"z" * 512, timeout=15) \
            == b"z" * 512
        ch.close()
    finally:
        srv.stop(grace=0)


@pytest.mark.parametrize("server,client", PAIRS)
def test_gzip_bomb_guard(server, client, platform):
    """The receive limit binds the inflated size: a small gzip of a huge
    message passes the wire check and fails RESOURCE_EXHAUSTED instead of
    inflating into memory; the connection survives."""
    platform("TCP")
    spkg, cpkg = PKGS[server], PKGS[client]
    srv, port = _echo_server(spkg, max_receive_message_length=4096)
    try:
        with cpkg.channel.Channel(f"127.0.0.1:{port}",
                                  compression="gzip") as ch:
            bomb = b"\x00" * (32 << 20)  # 32 MiB of zeros, ~32 KiB of gzip
            with pytest.raises(cpkg.status.RpcError) as ei:
                _unary(cpkg, ch, "/c.S/Echo")(bomb, timeout=30)
            assert code_name(ei.value) == "RESOURCE_EXHAUSTED"
            assert bytes(_unary(cpkg, ch, "/c.S/Echo")(b"ok", timeout=15)) \
                == b"ok"
    finally:
        srv.stop(grace=0)


def test_incompressible_payload_clears_flag(monkeypatch, platform):
    """Random bytes gzip larger: the writer sends them uncompressed with
    the flag cleared, so nobody decompresses."""
    platform("TCP")
    calls = []
    real = port_fr.decompress_message
    monkeypatch.setattr(port_fr, "decompress_message",
                        lambda d, lim=None: calls.append(1) or real(d, lim))
    srv, port = _echo_server(PORT)
    try:
        with PORT.channel.Channel(f"127.0.0.1:{port}",
                                  compression="gzip") as ch:
            body = os.urandom(4096)
            assert ch.unary_unary("/c.S/Echo")(body, timeout=15) == body
        assert not calls
    finally:
        srv.stop(grace=0)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_peer_without_decompressor_degrades_and_replays(name, platform):
    """A server that rejects compressed streams UNIMPLEMENTED with the
    sentinel before any handler work: the unary call replays uncompressed,
    and the channel stays uncompressed after."""
    platform("TCP")
    pkg = PKGS[name]
    fr = FR[name]
    seen = []

    def picky(req, ctx):
        seen.append(ctx._stream.peer_compressed)
        if ctx._stream.peer_compressed:
            ctx.abort(pkg.status.StatusCode.UNIMPLEMENTED,
                      fr.COMPRESSED_UNSUPPORTED_SENTINEL + " here")
        return bytes(req)

    kw = {"native_dataplane": False} if pkg is REF else {}
    srv = pkg.server.Server(max_workers=2, **kw)
    srv.add_method("/c.S/Picky", pkg.server.unary_unary_rpc_method_handler(
        picky))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with pkg.channel.Channel(f"127.0.0.1:{port}",
                                 compression="gzip") as ch:
            mc = _unary(pkg, ch, "/c.S/Picky")
            body = b"compressible " * 100
            assert bytes(mc(body, timeout=15)) == body
            assert ch._compress_flag == 0
            assert bytes(mc(body, timeout=15)) == body
    finally:
        srv.stop(grace=0)
    assert seen == [True, False, False]


# ---------------------------------------------------------------------------
# onto the device ring (the port's TPU platform, on the CPU)
# ---------------------------------------------------------------------------

def _classify_requests(n=4):
    rng = np.random.default_rng(11)
    out = []
    for i in range(n):
        images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
        index = np.arange(images.size, dtype=np.int64)  # compressible
        out.append({"images": torch.from_numpy(images),
                    "index": torch.from_numpy(index)})
    return out


def _device_serve(compression, reqs, counted):
    from tpurpc_torch.torchshim.service import (TensorClient,
                                                add_tensor_method)

    classify = small_classify()

    def fn(tree):
        out = classify(tree)
        out["isum"] = tree["index"].sum()
        return out

    srv = PORT.server.Server(max_workers=4)
    add_tensor_method(srv, "Classify", fn, device=True)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with PORT.channel.Channel(f"127.0.0.1:{port}",
                                  compression=compression) as ch:
            before = dict(counted)
            cli = TensorClient(ch)
            outs = [cli.call("Classify", r, timeout=30) for r in reqs]
            launched = {k: counted[k] - before[k] for k in counted}
            ring = srv._connections[0].endpoint.device_ring
            stats = ring.stats()
    finally:
        srv.stop(grace=1)
    return outs, launched, stats


def test_compressed_request_lands_in_the_device_ring(platform,
                                                     counted_plain):
    """A gzip'd tensor request is gunzipped at reassembly and its tensors
    placed into the device ring as an uncompressed one's are: the same
    replies, the same kernel calls, the ring whole afterwards."""
    platform("TPU", TPURPC_HBM_RING_SIZE_KB="256")
    reqs = _classify_requests()
    plain, l_plain, s_plain = _device_serve(None, reqs, counted_plain)
    gz, l_gz, s_gz = _device_serve("gzip", reqs, counted_plain)
    for a, b in zip(plain, gz):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
    assert l_gz == l_plain and sum(l_plain.values()) > 0
    for s in (s_plain, s_gz):
        assert s["head"] == s["tail"] and s["live_spans"] == 0


def test_compressed_request_past_the_limit_launches_nothing(platform,
                                                            counted_plain):
    """A request that inflates past the server's receive limit fails
    RESOURCE_EXHAUSTED before any tensor reaches the device ring."""
    platform("TPU", TPURPC_HBM_RING_SIZE_KB="256")
    from tpurpc_torch.torchshim.service import (TensorClient,
                                                add_tensor_method)

    srv = PORT.server.Server(max_workers=2,
                             max_receive_message_length=64 << 10)
    add_tensor_method(srv, "Classify", small_classify(), device=True)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with PORT.channel.Channel(f"127.0.0.1:{port}",
                                  compression="gzip") as ch:
            before = dict(counted_plain)
            big = {"images": torch.zeros((8, 64, 64, 3))}  # 384 KiB
            with pytest.raises(PORT.status.RpcError) as ei:
                TensorClient(ch).call("Classify", big, timeout=30)
            assert code_name(ei.value) == "RESOURCE_EXHAUSTED"
            assert counted_plain == before
    finally:
        srv.stop(grace=1)
