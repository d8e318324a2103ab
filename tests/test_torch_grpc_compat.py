"""Wire compatibility: STOCK grpcio clients against the port's server.

The cases of ``tests/test_grpc_compat.py`` (an echo service in all four
shapes, errors, binary metadata, deadlines, gzip and deflate requests,
malformed SETTINGS) and direction A of ``tests/test_interop_suite.py``
(the canonical gRPC interop cases), each with the installed grpcio's
``insecure_channel`` against a ``tpurpc_torch`` server, whose sniff routes
the h2 preface to ``tpurpc_torch/wire/grpc_h2.py``. The cases that hold
for any server run on both the echo and the interop server. The port's
native ``Channel`` shares the port with grpcio.
"""

import socket
import struct
import threading
import time

import grpc
import pytest

import tpurpc_torch.rpc as tps
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.status import StatusCode

_ID = lambda x: x  # bytes-in/bytes-out "serializer" for raw interop
S = "/grpc.testing.TestService/"


def _echo_server():
    srv = tps.Server(max_workers=8)

    def echo(req, ctx):
        return req

    def tail(req, ctx):
        for i in range(4):
            yield req + str(i).encode()

    def collect(req_iter, ctx):
        return b"|".join(req_iter)

    def chat(req_iter, ctx):
        for req in req_iter:
            yield b"re:" + req

    def boom(req, ctx):
        ctx.set_trailing_metadata((("saw-md", "yes"),))
        ctx.abort(StatusCode.FAILED_PRECONDITION, "nope: not ready")

    def meta(req, ctx):
        md = {k: v for k, v in ctx.invocation_metadata()}
        ctx.set_trailing_metadata((("echoed-key", md.get("x-custom", "?")),
                                   ("bin-bin", md.get("x-blob-bin", b"")),))
        return req

    def slow(req, ctx):
        time.sleep(5)
        return req

    srv.add_method("/test.Echo/Echo", tps.unary_unary_rpc_method_handler(echo))
    srv.add_method("/test.Echo/Tail", tps.unary_stream_rpc_method_handler(tail))
    srv.add_method("/test.Echo/Collect",
                   tps.stream_unary_rpc_method_handler(collect))
    srv.add_method("/test.Echo/Chat",
                   tps.stream_stream_rpc_method_handler(chat))
    srv.add_method("/test.Echo/Boom", tps.unary_unary_rpc_method_handler(boom))
    srv.add_method("/test.Echo/Meta", tps.unary_unary_rpc_method_handler(meta))
    srv.add_method("/test.Echo/Slow", tps.unary_unary_rpc_method_handler(slow))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port, None


def _interop_server():
    srv = tps.Server(max_workers=8)
    release = threading.Event()

    def empty_call(req, ctx):
        assert bytes(req) == b""
        return b""

    def unary_call(req, ctx):
        return bytes(req)

    def streaming_input(req_iter, ctx):
        return str(sum(len(m) for m in req_iter)).encode()

    def streaming_output(req, ctx):
        for n in (31415, 9, 2653, 58979):
            yield bytes(n % 251 for _ in range(1))  # sized markers
            yield b"x" * (n % 1024)

    def full_duplex(req_iter, ctx):
        for m in req_iter:
            yield b"pong:" + bytes(m)

    def custom_status(req, ctx):
        ctx.abort(StatusCode.UNKNOWN, bytes(req).decode("utf-8"))

    def sleeping(req, ctx):
        release.wait(timeout=30)
        return b"late"

    def md_echo(req, ctx):
        md = {k: v for k, v in ctx.invocation_metadata()}
        ctx.set_trailing_metadata((
            ("x-grpc-test-echo-trailing-bin",
             md.get("x-grpc-test-echo-trailing-bin", b"")),))
        ctx.send_initial_metadata((
            ("x-grpc-test-echo-initial",
             md.get("x-grpc-test-echo-initial", "?")),))
        return bytes(req)

    for name, factory, fn in (
            ("EmptyCall", tps.unary_unary_rpc_method_handler, empty_call),
            ("UnaryCall", tps.unary_unary_rpc_method_handler, unary_call),
            ("StreamingInputCall", tps.stream_unary_rpc_method_handler,
             streaming_input),
            ("StreamingOutputCall", tps.unary_stream_rpc_method_handler,
             streaming_output),
            ("FullDuplexCall", tps.stream_stream_rpc_method_handler,
             full_duplex),
            ("CustomStatus", tps.unary_unary_rpc_method_handler,
             custom_status),
            ("Sleeping", tps.unary_unary_rpc_method_handler, sleeping),
            ("MetadataEcho", tps.unary_unary_rpc_method_handler, md_echo)):
        srv.add_method(S + name, factory(fn))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port, release


def _rig(make):
    srv, port, release = make()
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    return srv, port, ch, release


def _teardown(rig):
    srv, _, ch, release = rig
    if release is not None:
        release.set()
    ch.close()
    srv.stop(grace=0)


@pytest.fixture(scope="module")
def compat():
    rig = _rig(_echo_server)
    yield rig[:3]
    _teardown(rig)


@pytest.fixture(scope="module")
def interop():
    rig = _rig(_interop_server)
    yield rig[2]
    _teardown(rig)


#: per server: an echoing unary method on it
ECHO = {"echo": "/test.Echo/Echo", "interop": S + "UnaryCall"}


@pytest.fixture(scope="module", params=["echo", "interop"])
def either(request):
    """Each of the two servers, on its own port: (server, port, grpcio
    channel, the server's unary echo method)."""
    rig = _rig(_echo_server if request.param == "echo" else _interop_server)
    yield rig[0], rig[1], rig[2], ECHO[request.param]
    _teardown(rig)


# -- tests/test_grpc_compat.py ---------------------------------------------------

def test_grpcio_unary(compat):
    _, _, ch = compat
    mc = ch.unary_unary("/test.Echo/Echo", _ID, _ID)
    assert mc(b"hello tpu", timeout=20) == b"hello tpu"


def test_grpcio_unary_large_flow_controlled(compat):
    """4 MiB both ways exercises DATA fragmentation + window updates."""
    _, _, ch = compat
    mc = ch.unary_unary("/test.Echo/Echo", _ID, _ID)
    big = bytes(range(256)) * (4 * 4096)  # 4 MiB
    assert mc(big, timeout=60) == big


def test_grpcio_server_streaming(compat):
    _, _, ch = compat
    mc = ch.unary_stream("/test.Echo/Tail", _ID, _ID)
    assert list(mc(b"x", timeout=20)) == [b"x0", b"x1", b"x2", b"x3"]


def test_grpcio_client_streaming(compat):
    _, _, ch = compat
    mc = ch.stream_unary("/test.Echo/Collect", _ID, _ID)
    assert mc(iter([b"a", b"b", b"c"]), timeout=20) == b"a|b|c"


def test_grpcio_bidi_streaming(compat):
    _, _, ch = compat
    mc = ch.stream_stream("/test.Echo/Chat", _ID, _ID)
    assert list(mc(iter([b"1", b"2"]), timeout=20)) == [b"re:1", b"re:2"]


def test_grpcio_error_status_and_message(compat):
    _, _, ch = compat
    mc = ch.unary_unary("/test.Echo/Boom", _ID, _ID)
    with pytest.raises(grpc.RpcError) as ei:
        mc(b"x", timeout=20)
    assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    assert "nope: not ready" in ei.value.details()
    md = dict(ei.value.trailing_metadata())
    assert md.get("saw-md") == "yes"


def test_grpcio_metadata_roundtrip_incl_binary(compat):
    _, _, ch = compat
    mc = ch.unary_unary("/test.Echo/Meta", _ID, _ID)
    resp, call = mc.with_call(
        b"m", timeout=20,
        metadata=(("x-custom", "v123"), ("x-blob-bin", b"\x00\x01\xfe")))
    assert resp == b"m"
    md = dict(call.trailing_metadata())
    assert md.get("echoed-key") == "v123"
    assert md.get("bin-bin") == b"\x00\x01\xfe"


def test_grpcio_unimplemented(either):
    _, _, ch, _ = either
    mc = ch.unary_unary("/test.Echo/Nope", _ID, _ID)
    with pytest.raises(grpc.RpcError) as ei:
        mc(b"x", timeout=20)
    assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_grpcio_deadline(compat):
    _, _, ch = compat
    mc = ch.unary_unary("/test.Echo/Slow", _ID, _ID)
    t0 = time.monotonic()
    with pytest.raises(grpc.RpcError) as ei:
        mc(b"x", timeout=0.5)
    assert ei.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
    assert time.monotonic() - t0 < 3


def test_grpcio_many_concurrent_calls(either):
    _, _, ch, echo = either
    mc = ch.unary_unary(echo, _ID, _ID)
    results = [None] * 16

    def one(i):
        results[i] = mc(f"m{i}".encode(), timeout=30)

    ts = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert results == [f"m{i}".encode() for i in range(16)]


def test_native_and_grpcio_share_one_port(either):
    """Protocol sniffing: the port's native framing and h2 on one listener."""
    _, port, ch, echo = either
    mc = ch.unary_unary(echo, _ID, _ID)
    with Channel(f"127.0.0.1:{port}") as native:
        nmc = native.unary_unary(echo)
        assert bytes(nmc(b"native", timeout=20)) == b"native"
        assert mc(b"h2", timeout=20) == b"h2"


def test_grpcio_gzip_compressed_client(compat):
    """A stock grpcio client with channel-level gzip compression: the port's
    server decompresses the requests (and advertises its accept list)."""
    _, port, _ = compat
    with grpc.insecure_channel(f"127.0.0.1:{port}",
                               compression=grpc.Compression.Gzip) as ch:
        mc = ch.unary_unary("/test.Echo/Echo", _ID, _ID)
        payload = b"compress-me " * 400  # compressible, > trivial size
        assert mc(payload, timeout=20) == payload
        mcs = ch.stream_unary("/test.Echo/Collect", _ID, _ID)
        assert mcs(iter([b"a" * 100, b"b" * 100]), timeout=20) == \
            b"a" * 100 + b"|" + b"b" * 100


def test_grpcio_deflate_compressed_client(compat):
    _, port, _ = compat
    with grpc.insecure_channel(f"127.0.0.1:{port}",
                               compression=grpc.Compression.Deflate) as ch:
        mc = ch.unary_unary("/test.Echo/Echo", _ID, _ID)
        payload = b"deflate-me " * 400
        assert mc(payload, timeout=20) == payload


@pytest.mark.parametrize("key,value", [(5, 0), (4, 0xFFFFFFFF)])
def test_malformed_settings_rejected_cleanly(either, key, value):
    """A peer advertising RFC-invalid SETTINGS (MAX_FRAME_SIZE=0,
    INITIAL_WINDOW_SIZE>2^31-1) gets its connection torn down, and the
    server keeps serving other connections."""
    _, port, ch, echo = either
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.settimeout(10)
    try:
        s.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n")
        payload = struct.pack("!HI", key, value)
        s.sendall(len(payload).to_bytes(3, "big") + b"\x04\x00"
                  + (0).to_bytes(4, "big") + payload)
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                if s.recv(4096) == b"":
                    break
            except socket.timeout:
                raise AssertionError("server kept the connection open")
    finally:
        s.close()
    assert ch.unary_unary(echo, _ID, _ID)(b"alive", timeout=15) == b"alive"


def test_preface_then_close_leaves_the_server_serving(compat):
    """A peer that sends the h2 preface and closes at once: the server's
    SETTINGS write during adoption fails, the sniff thread survives it."""
    _, port, ch = compat
    for _ in range(3):
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(b"PRI * HT")
        s.close()
    time.sleep(0.1)
    assert ch.unary_unary("/test.Echo/Echo", _ID, _ID)(
        b"alive", timeout=15) == b"alive"


# -- tests/test_interop_suite.py, direction A ------------------------------------

def test_empty_unary(interop):
    mc = interop.unary_unary(S + "EmptyCall", _ID, _ID)
    assert mc(b"", timeout=15) == b""


def test_large_unary(interop):
    mc = interop.unary_unary(S + "UnaryCall", _ID, _ID)
    body = bytes(range(256)) * 1109  # ~284KB, the canon's 271828-ish size
    assert mc(body, timeout=30) == body


def test_client_streaming(interop):
    mc = interop.stream_unary(S + "StreamingInputCall", _ID, _ID)
    sizes = [27182, 8, 1828, 45904]  # the canon's request sizes
    out = mc(iter(b"q" * n for n in sizes), timeout=30)
    assert int(out) == sum(sizes)


def test_server_streaming(interop):
    mc = interop.unary_stream(S + "StreamingOutputCall", _ID, _ID)
    msgs = list(mc(b"", timeout=30))
    assert len(msgs) == 8


def test_ping_pong(interop):
    """Bidi lockstep: each request answered before the next is sent."""
    mc = interop.stream_stream(S + "FullDuplexCall", _ID, _ID)
    lock = threading.Semaphore(1)

    def gen():
        for i in range(4):
            lock.acquire()
            yield b"m%d" % i

    replies = []
    for reply in mc(gen()):
        replies.append(reply)
        lock.release()
    assert replies == [b"pong:m%d" % i for i in range(4)]


def test_custom_metadata(interop):
    mc = interop.unary_unary(S + "MetadataEcho", _ID, _ID)
    resp, call = mc.with_call(
        b"payload", timeout=15,
        metadata=(("x-grpc-test-echo-initial", "test_initial_metadata_value"),
                  ("x-grpc-test-echo-trailing-bin", b"\xab\xab\xab")))
    assert resp == b"payload"
    init = dict(call.initial_metadata())
    assert init.get("x-grpc-test-echo-initial") == "test_initial_metadata_value"
    trail = dict(call.trailing_metadata())
    assert trail.get("x-grpc-test-echo-trailing-bin") == b"\xab\xab\xab"


def test_status_code_and_message(interop):
    mc = interop.unary_unary(S + "CustomStatus", _ID, _ID)
    with pytest.raises(grpc.RpcError) as ei:
        mc(b"test status message", timeout=15)
    assert ei.value.code() is grpc.StatusCode.UNKNOWN
    assert ei.value.details() == "test status message"


def test_special_status_message(interop):
    """Unicode + whitespace survive the percent-encoded grpc-message."""
    msg = "\t\ntest with whitespace\r\nand Unicode BMP ☺ and non-BMP \U0001f600\t\n"
    mc = interop.unary_unary(S + "CustomStatus", _ID, _ID)
    with pytest.raises(grpc.RpcError) as ei:
        mc(msg.encode("utf-8"), timeout=15)
    assert ei.value.details() == msg


def test_unimplemented_method(interop):
    mc = interop.unary_unary(S + "UnimplementedCall", _ID, _ID)
    with pytest.raises(grpc.RpcError) as ei:
        mc(b"", timeout=15)
    assert ei.value.code() is grpc.StatusCode.UNIMPLEMENTED


def test_timeout_on_sleeping_server(interop):
    mc = interop.unary_unary(S + "Sleeping", _ID, _ID)
    with pytest.raises(grpc.RpcError) as ei:
        mc(b"", timeout=0.5)
    assert ei.value.code() is grpc.StatusCode.DEADLINE_EXCEEDED


def test_cancel_after_begin(interop):
    mc = interop.stream_unary(S + "StreamingInputCall", _ID, _ID)
    feed = threading.Event()

    def gen():
        feed.wait(timeout=30)  # hold the stream open, nothing sent
        return
        yield  # pragma: no cover

    fut = mc.future(gen())
    time.sleep(0.2)
    fut.cancel()
    with pytest.raises((grpc.RpcError, grpc.FutureCancelledError)):
        fut.result(timeout=15)
    assert fut.cancelled()
    feed.set()


def test_cancel_after_first_response(interop):
    mc = interop.stream_stream(S + "FullDuplexCall", _ID, _ID)
    hold = threading.Event()

    def gen():
        yield b"one"
        hold.wait(timeout=30)

    call = mc(gen())
    assert next(call) == b"pong:one"
    call.cancel()
    with pytest.raises(grpc.RpcError) as ei:
        next(call)
    assert ei.value.code() is grpc.StatusCode.CANCELLED
    hold.set()


def test_concurrent_stock_clients(interop):
    """Several stock grpcio client threads hammer one port h2 server
    concurrently with mixed shapes: races in the server's HPACK,
    flow-control or stream bookkeeping would surface as protocol kills."""
    errors: list = []

    def worker(n: int):
        try:
            u = interop.unary_unary(S + "UnaryCall", _ID, _ID)
            d = interop.stream_stream(S + "FullDuplexCall", _ID, _ID)
            for i in range(40):
                body = bytes((n + i) % 256 for _ in range(512 * (1 + i % 4)))
                assert u(body, timeout=30) == body
                if i % 8 == 0:
                    out = list(d(iter([b"a", b"b"]), timeout=30))
                    assert out == [b"pong:a", b"pong:b"]
        except Exception as exc:  # noqa: BLE001 — surfaced after join
            errors.append(exc)

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    [t.start() for t in ts]
    [t.join(timeout=240) for t in ts]
    assert not errors, errors[0]
    assert not any(t.is_alive() for t in ts)
