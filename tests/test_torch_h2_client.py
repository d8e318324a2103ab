"""The port's ``H2Channel`` (``tpurpc_torch.wire.h2_client``) against a STOCK
grpcio server, and across the packages.

The cases of ``tests/test_h2_client.py`` (all four shapes, 4 MiB under flow
control, trailers-only errors with trailing metadata, binary metadata, the
dynamic HPACK table over many calls, deadlines, gzip responses) and
direction B of ``tests/test_interop_suite.py``, with the port's client
against the installed grpcio's C-core server. Then the cross pairs: the
port's ``H2Channel`` against the reference's server and the reference's
``H2Channel`` against the port's, each case's replies, status, details and
trailing metadata equal to those of the reference's own pair.
"""

import threading
import time
from concurrent import futures

import grpc
import pytest

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from tpurpc.wire.h2_client import H2Channel as JaxH2Channel
from tpurpc_torch.rpc.status import RpcError, StatusCode
from tpurpc_torch.wire.h2_client import H2Channel

_ID = lambda x: x
S = "/grpc.testing.TestService/"


class _Handlers(grpc.GenericRpcHandler):
    """Raw-bytes service on a stock grpcio server."""

    def service(self, details):
        name = details.method.rsplit("/", 1)[-1]
        if name == "Echo":
            return grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: req,
                request_deserializer=_ID, response_serializer=_ID)
        if name == "Tail":
            def tail(req, ctx):
                for i in range(4):
                    yield req + str(i).encode()
            return grpc.unary_stream_rpc_method_handler(
                tail, request_deserializer=_ID, response_serializer=_ID)
        if name == "Collect":
            def collect(req_iter, ctx):
                return b"|".join(req_iter)
            return grpc.stream_unary_rpc_method_handler(
                collect, request_deserializer=_ID, response_serializer=_ID)
        if name == "Chat":
            def chat(req_iter, ctx):
                for req in req_iter:
                    yield b"re:" + req
            return grpc.stream_stream_rpc_method_handler(
                chat, request_deserializer=_ID, response_serializer=_ID)
        if name == "Boom":
            def boom(req, ctx):
                ctx.set_trailing_metadata((("saw-md", "yes"),))
                ctx.abort(grpc.StatusCode.FAILED_PRECONDITION, "nope: not ready")
            return grpc.unary_unary_rpc_method_handler(
                boom, request_deserializer=_ID, response_serializer=_ID)
        if name == "Meta":
            def meta(req, ctx):
                md = {k: v for k, v in ctx.invocation_metadata()}
                ctx.set_trailing_metadata(
                    (("echoed-key", md.get("x-custom", "?")),
                     ("bin-bin", md.get("x-blob-bin", b"")),))
                return req
            return grpc.unary_unary_rpc_method_handler(
                meta, request_deserializer=_ID, response_serializer=_ID)
        if name == "Slow":
            def slow(req, ctx):
                time.sleep(5)
                return req
            return grpc.unary_unary_rpc_method_handler(
                slow, request_deserializer=_ID, response_serializer=_ID)
        if details.method == S + "UnaryCall":
            return grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: bytes(req), _ID, _ID)
        if details.method == S + "CustomStatus":
            def custom(req, ctx):
                ctx.abort(grpc.StatusCode.UNKNOWN, bytes(req).decode("utf-8"))
            return grpc.unary_unary_rpc_method_handler(custom, _ID, _ID)
        if details.method == S + "FullDuplexCall":
            def duplex(req_iter, ctx):
                for m in req_iter:
                    yield b"pong:" + bytes(m)
            return grpc.stream_stream_rpc_method_handler(duplex, _ID, _ID)
        return None  # UNIMPLEMENTED


@pytest.fixture(scope="module")
def rig():
    srv = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    srv.add_generic_rpc_handlers((_Handlers(),))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    ch = H2Channel(f"127.0.0.1:{port}")
    yield srv, port, ch
    ch.close()
    srv.stop(grace=0)


# -- tests/test_h2_client.py -----------------------------------------------------

def test_unary_roundtrip(rig):
    _, _, ch = rig
    mc = ch.unary_unary("/test.Echo/Echo")
    assert mc(b"hello from tpurpc", timeout=20) == b"hello from tpurpc"


def test_unary_large_flow_controlled(rig):
    """4 MiB both directions: DATA chunking under the peer's max-frame and
    conn+stream windows, window replenishment on receive."""
    _, _, ch = rig
    mc = ch.unary_unary("/test.Echo/Echo")
    big = bytes(range(256)) * (4 * 4096)  # 4 MiB
    assert mc(big, timeout=60) == big


def test_server_streaming(rig):
    _, _, ch = rig
    mc = ch.unary_stream("/test.Echo/Tail")
    assert list(mc(b"x", timeout=20)) == [b"x0", b"x1", b"x2", b"x3"]


def test_client_streaming(rig):
    _, _, ch = rig
    mc = ch.stream_unary("/test.Echo/Collect")
    assert mc(iter([b"a", b"b", b"c"]), timeout=20) == b"a|b|c"


def test_bidi_streaming(rig):
    _, _, ch = rig
    mc = ch.stream_stream("/test.Echo/Chat")
    assert list(mc(iter([b"1", b"2"]), timeout=20)) == [b"re:1", b"re:2"]


def test_error_status_message_and_trailing_metadata(rig):
    _, _, ch = rig
    mc = ch.unary_unary("/test.Echo/Boom")
    with pytest.raises(RpcError) as ei:
        mc(b"x", timeout=20)
    assert ei.value.code() is StatusCode.FAILED_PRECONDITION
    assert "nope: not ready" in ei.value.details()
    md = dict(ei.value.trailing_metadata() or [])
    assert md.get("saw-md") == "yes"


def test_metadata_roundtrip_incl_binary(rig):
    _, _, ch = rig
    mc = ch.unary_unary("/test.Echo/Meta")
    assert mc(b"m", timeout=20,
              metadata=(("x-custom", "v123"),
                        ("x-blob-bin", b"\x00\x01\xfe"))) == b"m"
    assert mc(b"m2", timeout=20,
              metadata=(("x-custom", "v456"),
                        ("x-blob-bin", b"\xff\x00"))) == b"m2"


def test_unimplemented_maps_to_status(rig):
    _, _, ch = rig
    mc = ch.unary_unary("/test.Echo/Nope")
    with pytest.raises(RpcError) as ei:
        mc(b"x", timeout=20)
    assert ei.value.code() is StatusCode.UNIMPLEMENTED


def test_deadline_expires_fast(rig):
    _, _, ch = rig
    mc = ch.unary_unary("/test.Echo/Slow")
    t0 = time.monotonic()
    with pytest.raises(RpcError) as ei:
        mc(b"x", timeout=0.5)
    assert ei.value.code() is StatusCode.DEADLINE_EXCEEDED
    assert time.monotonic() - t0 < 3


def test_many_sequential_calls_exercise_dynamic_table(rig):
    """Repeated calls with repeating headers: the dynamic-table encoder
    stays in sync with grpcio's decoder across many HEADERS blocks."""
    _, _, ch = rig
    mc = ch.unary_unary("/test.Echo/Echo")
    for i in range(20):
        payload = f"msg-{i}".encode()
        assert mc(payload, timeout=20,
                  metadata=(("x-repeat", "const"),)) == payload


def test_many_concurrent_calls(rig):
    _, _, ch = rig
    mc = ch.unary_unary("/test.Echo/Echo")
    results = [None] * 16

    def one(i):
        results[i] = mc(f"m{i}".encode(), timeout=30)

    ts = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert results == [f"m{i}".encode() for i in range(16)]


def test_h2channel_against_port_server():
    """Full circle: the port's h2 client against the port server's sniffed
    h2 path."""
    srv = trpc.Server(max_workers=4)
    srv.add_method("/test.Echo/Echo",
                   trpc.unary_unary_rpc_method_handler(lambda req, ctx: req))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with H2Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary("/test.Echo/Echo")
            assert mc(b"self-interop", timeout=20) == b"self-interop"
    finally:
        srv.stop(grace=0)


def test_h2channel_headers_write_on_a_closed_connection_is_unavailable():
    """A call whose HEADERS write meets a connection closed under it (the
    close after a GOAWAY racing a call that took its stream id just
    before) fails UNAVAILABLE naming the GOAWAY, not with the endpoint's
    raw error, and leaves no call behind."""
    from tpurpc_torch.core.endpoint import EndpointError

    srv = trpc.Server(max_workers=4)
    srv.add_method("/test.Echo/Echo",
                   trpc.unary_unary_rpc_method_handler(lambda req, ctx: req))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with H2Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary("/test.Echo/Echo")
            assert mc(b"first", timeout=20) == b"first"
            write = ch._ep.write

            def closed(data):
                ch._goaway = "server sent GOAWAY (error 0)"
                raise EndpointError(
                    "tcp write failed: [Errno 9] Bad file descriptor")

            ch._ep.write = closed
            with pytest.raises(RpcError) as ei:
                mc(b"late", timeout=20)
            ch._ep.write = write
            assert ei.value.code() is StatusCode.UNAVAILABLE
            assert "GOAWAY" in ei.value.details()
            assert not ch._calls
    finally:
        srv.stop(grace=0)


def test_h2channel_against_gzip_compressing_server():
    """A grpcio server configured for gzip compresses RESPONSES; H2Channel
    advertises gzip and decompresses them."""
    gsrv = grpc.server(futures.ThreadPoolExecutor(max_workers=4),
                       compression=grpc.Compression.Gzip)
    gsrv.add_generic_rpc_handlers((_Handlers(),))
    port = gsrv.add_insecure_port("127.0.0.1:0")
    gsrv.start()
    try:
        with H2Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary("/test.Echo/Echo")
            payload = b"squeeze " * 500
            assert mc(payload, timeout=20) == payload
    finally:
        gsrv.stop(grace=0)


# -- tests/test_interop_suite.py, direction B -----------------------------------

def test_b_large_unary_and_status(rig):
    _, port, _ = rig
    with H2Channel(f"127.0.0.1:{port}") as ch:
        body = bytes(range(256)) * 1109
        assert ch.unary_unary(S + "UnaryCall")(body, timeout=30) == body
        msg = "\ttest with whitespace\nand Unicode BMP ☺\t"
        with pytest.raises(RpcError) as ei:
            ch.unary_unary(S + "CustomStatus")(msg.encode(), timeout=15)
        assert ei.value.details() == msg


def test_b_ping_pong(rig):
    _, port, _ = rig
    with H2Channel(f"127.0.0.1:{port}") as ch:
        mc = ch.stream_stream(S + "FullDuplexCall")
        out = list(mc(iter([b"a", b"bb"]), timeout=30))
        assert out == [b"pong:a", b"pong:bb"]


# -- across the packages ---------------------------------------------------------

def _package_server(pkg):
    """The echo service on ``pkg``'s Server (``tpurpc.rpc`` or
    ``tpurpc_torch.rpc``); handlers return bytes, whatever buffer a
    request arrived in."""
    srv = pkg.Server(max_workers=8)

    def boom(req, ctx):
        ctx.set_trailing_metadata((("saw-md", "yes"),
                                   ("blob-bin", b"\x00\xff")))
        ctx.abort(pkg.StatusCode.FAILED_PRECONDITION, "nope: ☺ 100%")

    def meta(req, ctx):
        md = dict(ctx.invocation_metadata())
        ctx.abort(pkg.StatusCode.ABORTED,
                  f"{md.get('x-custom')}|{md.get('x-blob-bin')!r}")

    for name, kind, fn in (
            ("Echo", "unary_unary", lambda r, c: bytes(r)),
            ("Tail", "unary_stream",
             lambda r, c: (bytes(r) + str(i).encode() for i in range(4))),
            ("Collect", "stream_unary",
             lambda it, c: b"|".join(bytes(m) for m in it)),
            ("Chat", "stream_stream",
             lambda it, c: (b"re:" + bytes(m) for m in it)),
            ("Boom", "unary_unary", boom),
            ("Meta", "unary_unary", meta)):
        srv.add_method(f"/test.Echo/{name}", getattr(
            pkg, f"{kind}_rpc_method_handler")(fn))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _observe(fn):
    """A case's outcome: its replies, or its status, details and trailing
    metadata."""
    try:
        out = fn()
        if isinstance(out, list):
            return ("ok", [bytes(m) for m in out])
        return ("ok", bytes(out))
    except Exception as exc:  # both packages' RpcError
        return ("error", exc.code().name, exc.details(),
                sorted(exc.trailing_metadata() or ()))


BIG = bytes(range(251)) * 16384  # ~4 MiB: the rendezvous size class too

CASES = {
    "unary": lambda ch: ch.unary_unary("/test.Echo/Echo")(b"hi", timeout=20),
    "unary_4mib": lambda ch: ch.unary_unary("/test.Echo/Echo")(
        BIG, timeout=60),
    "server_streaming": lambda ch: list(ch.unary_stream("/test.Echo/Tail")(
        b"x", timeout=20)),
    "client_streaming": lambda ch: ch.stream_unary("/test.Echo/Collect")(
        iter([b"a", b"bb", b"ccc"]), timeout=20),
    "bidi": lambda ch: list(ch.stream_stream("/test.Echo/Chat")(
        iter([b"1", b"2", b"3"]), timeout=20)),
    "error_with_trailing_metadata": lambda ch: ch.unary_unary(
        "/test.Echo/Boom")(b"x", timeout=20),
    "binary_metadata": lambda ch: ch.unary_unary("/test.Echo/Meta")(
        b"m", timeout=20, metadata=(("x-custom", "v1"),
                                    ("x-blob-bin", b"\x00\x01\xfe"))),
    "unimplemented": lambda ch: ch.unary_unary("/test.Echo/Nope")(
        b"x", timeout=20),
}


@pytest.fixture(scope="module")
def servers():
    out = {"jax": _package_server(jrpc), "torch": _package_server(trpc)}
    yield {k: v[1] for k, v in out.items()}
    for srv, _ in out.values():
        srv.stop(grace=0)


_CLIENTS = {"jax": JaxH2Channel, "torch": H2Channel}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("client,server", [("torch", "jax"), ("jax", "torch")])
def test_cross_package_pair_matches_reference_pair(servers, case, client,
                                                   server):
    with JaxH2Channel(f"127.0.0.1:{servers['jax']}") as ch:
        want = _observe(lambda: CASES[case](ch))
    with _CLIENTS[client](f"127.0.0.1:{servers[server]}") as ch:
        got = _observe(lambda: CASES[case](ch))
    assert got == want
    if case == "error_with_trailing_metadata":
        assert want[1] == "FAILED_PRECONDITION"
        assert ("blob-bin", b"\x00\xff") in want[3]
