"""The RPC layer over each package's in-process transport: twins of
``tests/test_rpc.py``'s 35 cases, each run on both packages with the
observations compared (status codes by name, details, reply messages,
trailing metadata).

The call-shape and status cases run over ``inproc_channel(server)`` (a
passthru endpoint pair) and over loopback TCP, as the reference's channel
fixture does; the lifecycle cases (keepalive, max connection age, the idle
timeout, ``ping``, the graceful stop) and the three inline-handler cases
follow the reference's. Knobs change through ``monkeypatch`` and both
packages' config is reset around each test. Every wait is bounded.
"""

import importlib
import os
import socket
import struct
import threading
import time
import types

import pytest

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from tpurpc.core import endpoint as ref_ep
from tpurpc.rpc import channel as ref_channel
from tpurpc.rpc import frame as ref_frame
from tpurpc.utils import config as ref_config
from tpurpc_torch.core import endpoint as port_ep
from tpurpc_torch.rpc import channel as port_channel
from tpurpc_torch.rpc import frame as port_frame
from tpurpc_torch.utils import config as port_config

# by module path: the reference's package rebinds ``server`` to a function
ref_server = importlib.import_module("tpurpc.rpc.server")
port_server = importlib.import_module("tpurpc_torch.rpc.server")

REF = types.SimpleNamespace(name="ref", rpc=jrpc, fr=ref_frame, ep=ref_ep,
                            channel=ref_channel, server=ref_server,
                            config=ref_config)
PORT = types.SimpleNamespace(name="port", rpc=trpc, fr=port_frame, ep=port_ep,
                             channel=port_channel, server=port_server,
                             config=port_config)
PKGS = (REF, PORT)


def _reset_config():
    for pkg in PKGS:
        pkg.config.set_config(None)


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    # either package's unary fast path would bypass its Python transport
    monkeypatch.setenv("TPURPC_NATIVE_FAST_UNARY", "0")
    _reset_config()
    yield
    _reset_config()


def both(scenario, *args):
    got = {pkg.name: scenario(pkg, *args) for pkg in PKGS}
    assert got["port"] == got["ref"], got
    return got["port"]


def observe(pkg, fn):
    """``("ok", value)`` or ``("error", code name, details)``."""
    try:
        return ("ok", fn())
    except pkg.rpc.RpcError as exc:
        return ("error", exc.code().name, exc.details())


def wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# ---------------------------------------------------------------------------
# frame codec
# ---------------------------------------------------------------------------

def test_metadata_roundtrip():
    md = [("k", "v"), ("data-bin", b"\x00\xff"), ("empty", "")]
    blobs = {pkg.name: pkg.fr.encode_metadata(md) for pkg in PKGS}
    assert blobs["port"] == blobs["ref"]
    for pkg in PKGS:
        assert pkg.fr.decode_metadata(blobs["port"]) == (md, len(blobs["port"]))


def test_headers_roundtrip():
    blobs = {pkg.name: pkg.fr.headers_payload("/svc/M", [("a", "b")],
                                              timeout_us=123456)
             for pkg in PKGS}
    assert blobs["port"] == blobs["ref"]
    for pkg in PKGS:
        assert pkg.fr.parse_headers(blobs["port"]) == (
            "/svc/M", 123456, [("a", "b")])


def test_trailers_roundtrip():
    blobs = {pkg.name: pkg.fr.trailers_payload(
        pkg.rpc.StatusCode.NOT_FOUND, "nope", [("x", "y")]) for pkg in PKGS}
    assert blobs["port"] == blobs["ref"]
    for pkg in PKGS:
        code, details, md = pkg.fr.parse_trailers(blobs["port"])
        assert (code.name, details, md) == ("NOT_FOUND", "nope", [("x", "y")])


# ---------------------------------------------------------------------------
# the service, on either package and either transport
# ---------------------------------------------------------------------------

def _make_server(pkg, slow_gate=None):
    rpc = pkg.rpc
    SC = rpc.StatusCode

    def echo(request, context):
        return request

    def fail(request, context):
        context.abort(SC.PERMISSION_DENIED, "not allowed")

    def slow(request, context):
        (slow_gate or threading.Event()).wait(1.0)
        return request

    def count(request, context):
        for i in range(int(request)):
            yield str(i).encode()

    def total(request_iterator, context):
        return str(sum(int(x) for x in request_iterator)).encode()

    def double_each(request_iterator, context):
        for x in request_iterator:
            yield str(int(x) * 2).encode()

    def md_echo(request, context):
        context.set_trailing_metadata(
            [("seen", str(len(context.invocation_metadata())))])
        return request

    srv = rpc.server(max_workers=8)
    srv.add_service("t.Echo", {
        "Echo": rpc.unary_unary_rpc_method_handler(echo),
        "Fail": rpc.unary_unary_rpc_method_handler(fail),
        "Slow": rpc.unary_unary_rpc_method_handler(slow),
        "Count": rpc.unary_stream_rpc_method_handler(count),
        "Total": rpc.stream_unary_rpc_method_handler(total),
        "DoubleEach": rpc.stream_stream_rpc_method_handler(double_each),
        "MdEcho": rpc.unary_unary_rpc_method_handler(md_echo),
    })
    return srv


def _on_channel(pkg, transport, body):
    """``body(pkg, channel)`` on a fresh server and channel of ``pkg``."""
    gate = threading.Event()
    srv = _make_server(pkg, gate)
    if transport == "inproc":
        srv.start()
        ch = pkg.rpc.inproc_channel(srv)
    else:
        srv.add_insecure_port("127.0.0.1:0")
        srv.start()
        ch = pkg.rpc.insecure_channel(f"127.0.0.1:{srv.bound_ports[0]}")
    try:
        return body(pkg, ch)
    finally:
        gate.set()
        ch.close()
        srv.stop(grace=0.2)


TRANSPORTS = ["inproc", "tcp"]


def _unary(pkg, ch):
    echo = ch.unary_unary("/t.Echo/Echo")
    return observe(pkg, lambda: bytes(echo(b"hello tpu", timeout=10)))


def _large(pkg, ch):
    echo = ch.unary_unary("/t.Echo/Echo")
    big = bytes(range(256)) * (3 * pkg.fr.MAX_FRAME_PAYLOAD // 256 // 2)
    return observe(pkg, lambda: bytes(echo(big, timeout=30)) == big)


def _unary_stream(pkg, ch):
    return observe(pkg, lambda: [int(x) for x in ch.unary_stream(
        "/t.Echo/Count")(b"5", timeout=10)])


def _stream_unary(pkg, ch):
    return observe(pkg, lambda: bytes(ch.stream_unary("/t.Echo/Total")(
        iter([b"1", b"2", b"3"]), timeout=10)))


def _stream_stream(pkg, ch):
    return observe(pkg, lambda: [int(x) for x in ch.stream_stream(
        "/t.Echo/DoubleEach")(iter([b"1", b"2", b"3"]), timeout=10)])


def _concurrent(pkg, ch):
    echo = ch.unary_unary("/t.Echo/Echo")
    results, errs = {}, []

    def worker(i):
        try:
            results[i] = bytes(echo(str(i).encode() * 100, timeout=20))
        except Exception as exc:  # pragma: no cover
            errs.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return errs, results == {i: str(i).encode() * 100 for i in range(16)}


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("case, want", [
    (_unary, ("ok", b"hello tpu")),
    (_large, ("ok", True)),
    (_unary_stream, ("ok", [0, 1, 2, 3, 4])),
    (_stream_unary, ("ok", b"6")),
    (_stream_stream, ("ok", [2, 4, 6])),
    (_concurrent, ([], True)),
], ids=["unary_unary", "unary_unary_large_fragmented", "unary_stream",
        "stream_unary", "stream_stream", "concurrent_calls_multiplexed"])
def test_call_shapes(transport, case, want):
    assert both(_on_channel, transport, case) == want


def _abort(pkg, ch):
    return observe(pkg, lambda: ch.unary_unary("/t.Echo/Fail")(b"x", timeout=10))


def _unimplemented(pkg, ch):
    got = observe(pkg, lambda: ch.unary_unary("/t.Echo/NoSuchMethod")(
        b"x", timeout=10))
    return got[:2], "NoSuchMethod" in got[2]


def _deadline(pkg, ch):
    t0 = time.monotonic()
    got = observe(pkg, lambda: ch.unary_unary("/t.Echo/Slow")(b"x",
                                                             timeout=0.2))
    return got[:2], time.monotonic() - t0 < 0.9


def _cancel(pkg, ch):
    call = ch.unary_stream("/t.Echo/Count")(b"1000000", timeout=30)
    it = iter(call)
    first = next(it)
    call.cancel()

    def rest():
        for _ in it:
            pass

    return first, observe(pkg, rest)[:2]


def _trailing(pkg, ch):
    resp, call = ch.unary_unary("/t.Echo/MdEcho").with_call(
        b"x", timeout=10, metadata=[("a", "1"), ("b", "2")])
    return bytes(resp), list(call.trailing_metadata()), call.code().name


def _handler_exception(pkg, ch):
    got = observe(pkg, lambda: list(ch.unary_stream("/t.Echo/Count")(
        b"not-a-number", timeout=10)))
    return got[:2], got[2].startswith("Exception calling application")


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("case, want", [
    (_abort, ("error", "PERMISSION_DENIED", "not allowed")),
    (_unimplemented, (("error", "UNIMPLEMENTED"), True)),
    (_deadline, (("error", "DEADLINE_EXCEEDED"), True)),
    (_cancel, (b"0", ("error", "CANCELLED"))),
    (_trailing, (b"x", [("seen", "2")], "OK")),
    (_handler_exception, (("error", "UNKNOWN"), True)),
], ids=["abort_surfaces_status", "unimplemented", "deadline_exceeded",
        "cancel_streaming", "trailing_metadata",
        "handler_exception_maps_to_unknown"])
def test_status_semantics(transport, case, want):
    assert both(_on_channel, transport, case) == want


def _empty_unary(pkg, ch):
    return observe(pkg, lambda: bytes(ch.unary_unary("/t.Echo/Echo")(
        b"", timeout=10)))


def _empty_in_stream(pkg, ch):
    # an empty payload is still a message: int(b"") raises in the handler
    return observe(pkg, lambda: ch.stream_unary("/t.Echo/Total")(
        iter([b"1", b""]), timeout=10))[:2]


def _crashing_iter(pkg, ch):
    def bad_iter():
        yield b"1"
        raise ValueError("boom")

    t0 = time.monotonic()
    got = observe(pkg, lambda: ch.stream_unary("/t.Echo/Total")(
        bad_iter(), timeout=30))
    return got[:2], time.monotonic() - t0 < 5


def _oversized_md(pkg, ch):
    echo = ch.unary_unary("/t.Echo/Echo")
    big = observe(pkg, lambda: echo(b"x", timeout=10, metadata=[
        ("big", "v" * (2 * pkg.fr.MAX_FRAME_PAYLOAD))]))
    return big[:2], observe(pkg, lambda: bytes(echo(b"still alive",
                                                    timeout=10)))


def _ping(pkg, ch):
    rtt = ch.ping(timeout=5)
    return 0 <= rtt < 5


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("case, want", [
    (_empty_unary, ("ok", b"")),
    (_empty_in_stream, ("error", "UNKNOWN")),
    (_crashing_iter, (("error", "CANCELLED"), True)),
    (_oversized_md, (("error", "RESOURCE_EXHAUSTED"),
                     ("ok", b"still alive"))),
    (_ping, True),
], ids=["empty_unary_request_delivered", "empty_messages_in_streams",
        "crashing_request_iterator_fails_fast",
        "oversized_metadata_fails_stream_not_connection", "ping"])
def test_regressions(transport, case, want):
    assert both(_on_channel, transport, case) == want


# ---------------------------------------------------------------------------
# transport failure, reconnect, ping
# ---------------------------------------------------------------------------

def _late_adoption(pkg):
    srv = _make_server(pkg)
    srv.start()
    srv.stop(grace=0)
    a, b = pkg.ep.passthru_endpoint_pair()
    srv.serve_endpoint(b)  # the racy late adoption, made deterministic
    ch = pkg.channel.Channel(endpoint_factory=lambda: a)
    try:
        got = observe(pkg, lambda: ch.unary_unary("/t.Echo/Echo")(
            b"x", timeout=3))[1]
        return (got in ("UNAVAILABLE", "DEADLINE_EXCEEDED"),
                wait_for(lambda: not srv._connections))
    finally:
        ch.close()


def test_stopped_server_refuses_late_adoptions():
    assert both(_late_adoption) == (True, True)


def _pool_rejection(pkg):
    srv = _make_server(pkg)
    srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    ch = pkg.rpc.insecure_channel(f"127.0.0.1:{srv.bound_ports[0]}")
    try:
        echo = ch.unary_unary("/t.Echo/Echo")
        first = observe(pkg, lambda: bytes(echo(b"a", timeout=10)))
        conn = ch._subchannels[0]._conn
        alive = conn is not None and conn.alive
        srv._pool.shutdown(wait=False)  # the stale-adoption state
        second = observe(pkg, lambda: echo(b"b", timeout=3))[:2]
        return first, alive, second, wait_for(lambda: not conn.alive)
    finally:
        ch.close()
        srv.stop(grace=0)


def test_pool_rejection_kills_connection_so_client_redials():
    assert both(_pool_rejection) == (("ok", b"a"), True,
                                     ("error", "UNAVAILABLE"), True)


def _server_gone(pkg):
    srv = _make_server(pkg)
    srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    port = srv.bound_ports[0]
    ch = pkg.rpc.insecure_channel(f"127.0.0.1:{port}")
    srv2 = None
    try:
        echo = ch.unary_unary("/t.Echo/Echo")
        out = [observe(pkg, lambda: bytes(echo(b"a", timeout=10)))]
        srv.stop(grace=0)
        out.append(observe(pkg, lambda: echo(b"b", timeout=3))[:2])
        srv2 = _make_server(pkg)
        srv2.add_insecure_port(f"127.0.0.1:{port}")
        srv2.start()
        deadline = time.monotonic() + 60
        while True:
            got = observe(pkg, lambda: bytes(echo(b"c", timeout=5)))
            if got[0] == "ok" or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        out.append(got)
        return out
    finally:
        ch.close()
        if srv2 is not None:
            srv2.stop(grace=0.2)


def test_server_gone_maps_unavailable_then_reconnects():
    assert both(_server_gone) == [("ok", b"a"), ("error", "UNAVAILABLE"),
                                  ("ok", b"c")]


def _ping_silent(pkg):
    a, _b = pkg.ep.passthru_endpoint_pair()  # nobody reads _b
    ch = pkg.channel.Channel(endpoint_factory=lambda: a)
    try:
        return observe(pkg, lambda: ch.ping(timeout=0.3))[:2]
    finally:
        ch.close()


def test_ping_unresponsive_peer_times_out():
    assert both(_ping_silent) == ("error", "DEADLINE_EXCEEDED")


# ---------------------------------------------------------------------------
# keepalive, max connection age, idle timeout, graceful stop
# ---------------------------------------------------------------------------

def _keepalive_dead_peer(pkg):
    a, _b = pkg.ep.passthru_endpoint_pair()  # _b answers nothing
    ch = pkg.channel.Channel(endpoint_factory=lambda: a)
    try:
        conn = ch._connection()
        return conn.alive, wait_for(lambda: not conn.alive)
    finally:
        ch.close()


def test_keepalive_detects_dead_peer(monkeypatch):
    monkeypatch.setenv("GRPC_ARG_KEEPALIVE_TIME_MS", "100")
    monkeypatch.setenv("GRPC_ARG_KEEPALIVE_TIMEOUT_MS", "200")
    _reset_config()
    assert both(_keepalive_dead_peer) == (True, True)


def _max_age(pkg):
    srv = pkg.rpc.Server(max_workers=4)

    def slow_echo(req, ctx):
        time.sleep(0.6)  # alive across the age expiry
        return bytes(req)

    srv.add_method("/t.Age/Slow",
                   pkg.rpc.unary_unary_rpc_method_handler(slow_echo))
    srv.add_method("/t.Age/Fast", pkg.rpc.unary_unary_rpc_method_handler(
        lambda b, c: bytes(b)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            out = [observe(pkg, lambda: bytes(ch.unary_unary("/t.Age/Slow")(
                b"x", timeout=10)))]
            conn1 = ch._subchannels[0]._conn
            for _ in range(3):
                out.append(observe(pkg, lambda: bytes(ch.unary_unary(
                    "/t.Age/Fast")(b"y", timeout=10))))
            out.append(ch._subchannels[0]._conn is not conn1
                       or not conn1.alive or conn1.draining)
            return out
    finally:
        srv.stop(grace=0)


def test_max_connection_age_drains_gracefully(monkeypatch):
    monkeypatch.setenv("GRPC_ARG_MAX_CONNECTION_AGE_MS", "300")
    _reset_config()
    assert both(_max_age) == [("ok", b"x")] + [("ok", b"y")] * 3 + [True]


def _idle(pkg):
    srv = _make_server(pkg)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            echo = ch.unary_unary("/t.Echo/Echo")
            out = [observe(pkg, lambda: bytes(echo(b"1", timeout=10)))]
            conn = ch._subchannels[0]._conn
            out.append(wait_for(lambda: not conn.alive))
            out.append(observe(pkg, lambda: bytes(echo(b"2", timeout=10))))
            return out
    finally:
        srv.stop(grace=0)


def test_client_idle_timeout_closes_and_redials(monkeypatch):
    monkeypatch.setenv("GRPC_ARG_CLIENT_IDLE_TIMEOUT_MS", "200")
    _reset_config()
    assert both(_idle) == [("ok", b"1"), True, ("ok", b"2")]


def _graceful_stop(pkg):
    srv = pkg.rpc.Server(max_workers=4)
    entered = threading.Event()

    def slow(req, ctx):
        entered.set()
        time.sleep(0.5)
        return b"done:" + bytes(req)

    srv.add_method("/t.Stop/Slow", pkg.rpc.unary_unary_rpc_method_handler(slow))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    ch = pkg.rpc.Channel(f"127.0.0.1:{port}")
    result = {}

    def call():
        result["v"] = bytes(ch.unary_unary("/t.Stop/Slow")(b"x", timeout=10))

    t = threading.Thread(target=call)
    t.start()
    try:
        assert entered.wait(timeout=10)
        stopper = threading.Thread(target=lambda: srv.stop(grace=5))
        stopper.start()
        t.join(timeout=10)
        stopper.join(timeout=10)
        return result.get("v"), observe(pkg, lambda: ch.unary_unary(
            "/t.Stop/Slow")(b"y", timeout=3))[:2]
    finally:
        ch.close()


def test_graceful_stop_drains_inflight_and_refuses_new():
    assert both(_graceful_stop) == (b"done:x", ("error", "UNAVAILABLE"))


def _alive_conns(srv):
    with srv._lock:
        return any(c.alive for c in srv._connections)


def _server_reaps(pkg):
    srv = _make_server(pkg)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    raw = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        raw.sendall(pkg.fr.MAGIC)  # a valid preface, then dead air
        admitted = wait_for(lambda: _alive_conns(srv), 2.0)
        return admitted, wait_for(lambda: not _alive_conns(srv))
    finally:
        raw.close()
        srv.stop(grace=0)


def test_server_keepalive_reaps_silent_client(monkeypatch):
    monkeypatch.setenv("GRPC_ARG_KEEPALIVE_TIME_MS", "150")
    monkeypatch.setenv("GRPC_ARG_KEEPALIVE_TIMEOUT_MS", "300")
    _reset_config()
    assert both(_server_reaps) == (True, True)


def _server_spares(pkg):
    fr = pkg.fr
    srv = _make_server(pkg)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    raw = socket.create_connection(("127.0.0.1", port), timeout=5)
    stop = threading.Event()
    pongs = [0]

    def pong_responder():
        raw.sendall(fr.MAGIC)
        buf = b""
        raw.settimeout(0.2)
        while not stop.is_set():
            try:
                data = raw.recv(4096)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                return
            buf += data
            while len(buf) >= 10:
                ftype, flags, sid, ln = struct.unpack_from("<BBII", buf)
                if len(buf) < 10 + ln:
                    break
                payload, buf = buf[10:10 + ln], buf[10 + ln:]
                if ftype == fr.PING:  # answer ONLY pings
                    raw.sendall(struct.pack("<BBII", fr.PONG, 0, 0,
                                            len(payload)) + payload)
                    pongs[0] += 1

    t = threading.Thread(target=pong_responder, daemon=True)
    t.start()
    try:
        # several ping windows pass: wait until the client answered a few
        wait_for(lambda: pongs[0] >= 3, 5.0)
        return pongs[0] >= 3, _alive_conns(srv)
    finally:
        stop.set()
        t.join(timeout=2)
        raw.close()
        srv.stop(grace=0)


def test_server_keepalive_spares_ponging_idle_client(monkeypatch):
    monkeypatch.setenv("GRPC_ARG_KEEPALIVE_TIME_MS", "300")
    monkeypatch.setenv("GRPC_ARG_KEEPALIVE_TIMEOUT_MS", "3000")
    _reset_config()
    assert both(_server_spares) == (True, True)


def _healthy_idle(pkg):
    srv = _make_server(pkg)
    srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    ch = pkg.rpc.insecure_channel(f"127.0.0.1:{srv.bound_ports[0]}")
    try:
        first = observe(pkg, lambda: bytes(ch.unary_unary("/t.Echo/Echo")(
            b"a", timeout=10)))
        conn = ch._subchannels[0]._conn
        # about five silence windows, PINGs both ways: it must survive
        wait_for(lambda: conn.pong_count >= 3 or not conn.alive, 4.0)
        healthy = conn.alive and conn.pong_count >= 1
    finally:
        ch.close()
        srv.stop(grace=0)
    a, _b = pkg.ep.passthru_endpoint_pair()  # a silent peer
    ch2 = pkg.channel.Channel(endpoint_factory=lambda: a)
    try:
        c2 = ch2._subchannels[0].get()
        return first, healthy, wait_for(lambda: not c2.alive)
    finally:
        ch2.close()


def test_keepalive_healthy_idle_survives_aggressive_knobs(monkeypatch):
    monkeypatch.setenv("GRPC_ARG_KEEPALIVE_TIME_MS", "400")
    monkeypatch.setenv("GRPC_ARG_KEEPALIVE_TIMEOUT_MS", "400")
    _reset_config()
    assert both(_healthy_idle) == (("ok", b"a"), True, True)


def test_closed_channel_sees_no_timer_fire(monkeypatch):
    """Keepalive and idle ticks are wheel entries: once a channel closes,
    none fires (the connection's handles are cancelled at its death)."""
    monkeypatch.setenv("GRPC_ARG_KEEPALIVE_TIME_MS", "50")
    monkeypatch.setenv("GRPC_ARG_CLIENT_IDLE_TIMEOUT_MS", "60")
    _reset_config()
    srv = _make_server(PORT)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        ch = PORT.rpc.Channel(f"127.0.0.1:{port}")
        assert bytes(ch.unary_unary("/t.Echo/Echo")(b"a", timeout=10)) == b"a"
        conn = ch._subchannels[0]._conn
        sends = []
        orig = conn.writer.send
        conn.writer.send = lambda *a, **k: (sends.append(a[0]),
                                            orig(*a, **k))[1]
        ch.close()
        assert not conn.alive
        assert conn._ka_handle.cancelled and conn._idle_handle.cancelled
        time.sleep(0.3)  # several intervals: no keepalive PING goes out
        assert sends == []
    finally:
        srv.stop(grace=0)


# ---------------------------------------------------------------------------
# inline (reactor) unary handlers
# ---------------------------------------------------------------------------

def _inline_e2e(pkg):
    rpc = pkg.rpc
    SC = rpc.StatusCode
    srv = rpc.Server(max_workers=2)
    srv.add_method("/i.S/Echo", rpc.unary_unary_rpc_method_handler(
        lambda r, c: bytes(r) + b"!", inline=True))
    srv.add_method("/i.S/Md", rpc.unary_unary_rpc_method_handler(
        lambda r, c: dict(c.invocation_metadata()).get("k", "?").encode(),
        inline=True))

    def boom(req, ctx):
        raise RuntimeError("kaboom")

    def abort(req, ctx):
        ctx.abort(SC.PERMISSION_DENIED, "no")

    srv.add_method("/i.S/Boom", rpc.unary_unary_rpc_method_handler(
        boom, inline=True))
    srv.add_method("/i.S/Abort", rpc.unary_unary_rpc_method_handler(
        abort, inline=True))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with rpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            def call(m, req, **kw):
                return observe(pkg, lambda: bytes(ch.unary_unary(m)(
                    req, timeout=30, **kw)))

            big = b"B" * (2 << 20)  # a fragmented request reassembles first
            return [call("/i.S/Echo", b"hi"), call("/i.S/Echo", b""),
                    call("/i.S/Echo", big) == ("ok", big + b"!"),
                    call("/i.S/Md", b"", metadata=[("k", "v")]),
                    call("/i.S/Boom", b"")[:2], call("/i.S/Abort", b""),
                    call("/i.S/Echo", b"again")]
    finally:
        srv.stop(grace=0)


def test_inline_unary_handler_end_to_end():
    assert both(_inline_e2e) == [
        ("ok", b"hi!"), ("ok", b"!"), True, ("ok", b"v"),
        ("error", "UNKNOWN"), ("error", "PERMISSION_DENIED", "no"),
        ("ok", b"again!")]


def test_inline_rejected_for_streaming_kinds():
    for pkg in PKGS:
        with pytest.raises(ValueError, match="unary_unary only"):
            pkg.server.RpcMethodHandler("unary_stream", lambda r, c: iter([]),
                                        inline=True)


def _inline_deadline(pkg):
    fr = pkg.fr
    srv = pkg.rpc.Server(max_workers=2)
    srv.add_method("/i.S/Echo", pkg.rpc.unary_unary_rpc_method_handler(
        lambda r, c: bytes(r), inline=True))
    srv.start()
    a, b = pkg.ep.passthru_endpoint_pair()
    srv.serve_endpoint(b)
    try:
        w = fr.FrameWriter(a)
        w.send_preface()
        # HEADERS with a 300 ms deadline, then silence
        w.send(fr.HEADERS, 0, 1,
               fr.headers_payload("/i.S/Echo", [], timeout_us=300000))
        reader = fr.FrameReader(a)
        deadline = time.monotonic() + 10
        got = None
        while time.monotonic() < deadline:
            f = reader.read_frame(timeout=max(0.01,
                                              deadline - time.monotonic()))
            if f is None:
                break
            if f is not fr.CONSUMED and f.type == fr.TRAILERS:
                code, details, _ = fr.parse_trailers(f.payload)
                got = (code.name, details)
                break
        assert wait_for(lambda: bool(srv._connections), 5.0)
        conn = srv._connections[0]
        return got, wait_for(lambda: not conn._streams)
    finally:
        srv.stop(grace=0)
        a.close()


def test_inline_handler_deadline_without_body():
    assert both(_inline_deadline) == (
        ("DEADLINE_EXCEEDED", "deadline exceeded awaiting request"), True)


def _garbage(pkg):
    escapes = []
    prev_hook = threading.excepthook
    threading.excepthook = lambda args: escapes.append(args)
    srv = pkg.rpc.Server(max_workers=2)
    srv.add_method("/g.S/Echo", pkg.rpc.unary_unary_rpc_method_handler(
        lambda r, c: bytes(r)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        payloads = [
            os.urandom(64),                       # junk at the sniff
            b"TPURPC\x01\x00" + os.urandom(64),   # junk after a preface
            b"TPURPC\x01\x00" + struct.pack(      # an oversized frame header
                "<BBII", 2, 0, 1, 0xFFFFFFF0),
            b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n" + os.urandom(32),
            b"TRB",                               # a truncated ring magic
        ]
        for _ in range(3):
            for junk in payloads:
                s = socket.create_connection(("127.0.0.1", port), timeout=10)
                try:
                    s.sendall(junk)
                except OSError:
                    pass
                finally:
                    s.close()
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            alive = observe(pkg, lambda: bytes(ch.unary_unary("/g.S/Echo")(
                b"alive", timeout=15)))
        # the sniff threads of the junk connections finish dying
        wait_for(lambda: not srv._connections or all(
            c.alive for c in srv._connections), 2.0)
        return alive, [repr(e.exc_value) for e in escapes]
    finally:
        threading.excepthook = prev_hook
        srv.stop(grace=0)


def test_listener_survives_garbage_connections():
    assert both(_garbage) == (("ok", b"alive"), [])
