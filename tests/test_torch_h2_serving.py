"""The port's serving stack over the gRPC wire, against the reference's.

- ``TensorClient(H2Channel)`` against ``serve_torch`` of the MoE transformer
  at a small size (2 layers, d_model 32, the reference's parameters through
  ``from_jax``); the same trees through ``serve_jax`` and the reference's
  ``H2Channel``. In each package every reply is bit-equal to that
  package's direct forward, and the two agree within the float32 forward
  test's tolerance.
- The h2 rendezvous case of ``tests/test_rendezvous.py``: a big payload
  each way over ``H2Channel`` moves one-sided, the transfer counts equal
  across the packages, and so are the copy ledgers' deltas.
- The stock health check over h2 (``tests/test_health.py``), byte-equal
  to the reference server's replies.
- A stock grpcio client reaching a 2-worker ``serve_torch_sharded`` fleet,
  through each listener mode.
- ``stop(grace)`` and ``drain()`` with h2 connections open: in-flight calls
  finish, new ones are refused before the server takes them.
- The grpcio-shaped programs of ``tests/test_dropin.py``, verbatim against
  ``import tpurpc_torch.rpc as grpc``.
"""

import contextlib
import functools
import json
import socket
import struct
import threading
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_builds as builds
import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from test_torch_shard import _launch_lock
from test_torch_transformer import (F32_TOL, SMALL, _cfgs, _jax_params,
                                    _port_model, _ref_logits)
from tpurpc.core import _native as ref_native
from tpurpc.jaxshim import service as jsvc
from tpurpc.models import transformer as jtfm
from tpurpc.obs import metrics as ref_metrics
from tpurpc.parallel import mesh as jmesh
from tpurpc.rpc import health as jhealth
from tpurpc.tpu import ledger as ref_ledger
from tpurpc.utils import config as ref_config
from tpurpc.wire.h2_client import H2Channel as JaxH2Channel
from tpurpc_torch.core import _native as port_native
from tpurpc_torch.models import transformer as ttfm
from tpurpc_torch.rpc import health as thealth
from tpurpc_torch.rpc.status import RpcError, StatusCode
from tpurpc_torch.torchshim import codec
from tpurpc_torch.torchshim import service as tsvc
from tpurpc_torch.tpu import ledger
from tpurpc_torch.utils import config as torch_config
from tpurpc_torch.wire import h2, hpack
from tpurpc_torch.wire.h2_client import H2Channel

_ID = lambda x: x
CALL = 60.0


@pytest.fixture
def torch_on_cpu(monkeypatch):
    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    torch_config.set_config(None)
    yield
    torch_config.set_config(None)


def _poll(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# -- the tensor service over h2 ----------------------------------------------------

def test_tensor_client_over_h2_bit_equal_to_direct_in_both(torch_on_cpu):
    jcfg, tcfg = _cfgs(SMALL)
    params = _jax_params(jcfg, seed=4)
    serve = ttfm.make_serve_fn(_port_model(tcfg, params))
    mesh = jmesh.build_mesh(1)
    jparams = jtfm.shard_params(params, jcfg, mesh)
    jfwd = jax.jit(jtfm.build_forward(jcfg, mesh))

    def jserve(tree):
        return {"logits": jfwd(jparams, jnp.asarray(tree["tokens"]))}

    rng = np.random.default_rng(11)
    rows = [rng.integers(0, SMALL["vocab"], (2, 16)).astype(np.int32)
            for _ in range(4)]
    jsrv, jport, _ = jsvc.serve_jax(jserve, name="Generate")
    tsrv, tport, _ = tsvc.serve_torch(serve, name="Generate")
    try:
        with JaxH2Channel(f"127.0.0.1:{jport}") as jch, \
                H2Channel(f"127.0.0.1:{tport}") as tch:
            jcli, tcli = jsvc.TensorClient(jch), tsvc.TensorClient(tch)
            for r in rows:
                jgot = np.asarray(jcli.call("Generate", {"tokens": r},
                                            timeout=CALL)["logits"])
                tgot = tcli.call("Generate", {"tokens": torch.from_numpy(r)},
                                 timeout=CALL)["logits"]
                assert np.array_equal(
                    jgot, np.asarray(jserve({"tokens": r})["logits"]))
                assert torch.equal(
                    tgot, serve({"tokens": torch.from_numpy(r)})["logits"])
                assert tgot.shape == (2, 16, SMALL["vocab"])
                want = _ref_logits(jcfg, params, r)
                err = np.abs(tgot.numpy() - want).max() / max(
                    1.0, np.abs(want).max())
                assert err <= F32_TOL
    finally:
        jsrv.stop(grace=0)
        tsrv.stop(grace=0)


# -- rendezvous over the gRPC wire ---------------------------------------------

@pytest.fixture
def tcp_platform(monkeypatch):
    ref_native.load()   # see test_torch_rendezvous.platform
    port_native.load()  # and the port's, outside deadlines too
    monkeypatch.setenv("GRPC_PLATFORM_TYPE", "TCP")
    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    ref_config.set_config(None)
    torch_config.set_config(None)
    yield
    torch_config.set_config(None)


def _rdv_echo(pkg, **kw):
    srv = pkg.Server(max_workers=4, **kw)
    srv.add_method("/rdv.S/Echo", pkg.unary_unary_rpc_method_handler(
        lambda req, ctx: bytes(req)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _run_rdv_echo(make_server, channel_cls, totals, track):
    srv, port = make_server()
    big = bytes(range(251)) * 8192  # ~2 MiB patterned
    try:
        with channel_cls(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary("/rdv.S/Echo")
            assert bytes(mc(b"small", timeout=10)) == b"small"  # settles
            t0 = totals(ch, srv)
            with track() as w:
                out = mc(big, timeout=30)
                assert bytes(out) == big
                del out
            t1 = totals(ch, srv)
    finally:
        srv.stop(grace=1)
    return ({k: t1[k] - t0[k] for k in t0},
            {k: w[k] for k in ("rdma_write", "host_copy", "dma_h2d")})


def test_h2_plane_big_payloads_bypass_data_frames(tcp_platform):
    def ref_totals(ch, srv):
        m = ref_metrics.registry().metrics()
        return {k: m[f"rdv_{k}"].snapshot() for k in
                ("transfers_sent", "transfers_received", "fallbacks")}

    def port_totals(ch, srv):
        links = [ch.rdv] + [c.rdv for c in list(srv._connections)]
        return {f"transfers_{k}" if k != "fallbacks" else k:
                sum(link.stats()[k] for link in links)
                for k in ("sent", "received", "fallbacks")}

    want = _run_rdv_echo(functools.partial(_rdv_echo, jrpc,
                                           native_dataplane=False),
                         JaxH2Channel, ref_totals, ref_ledger.track)
    got = _run_rdv_echo(functools.partial(_rdv_echo, trpc,
                                          native_dataplane=False), H2Channel,
                        port_totals, ledger.track)
    assert got == want
    assert got[0] == {"transfers_sent": 2, "transfers_received": 2,
                      "fallbacks": 0}


def test_h2_without_rendezvous_frames_big_payloads(tcp_platform, monkeypatch):
    """``TPURPC_RENDEZVOUS=0``: neither side advertises the setting, the
    bytes travel in DATA frames under flow control."""
    monkeypatch.setenv("TPURPC_RENDEZVOUS", "0")
    srv, port = _rdv_echo(trpc)
    try:
        with H2Channel(f"127.0.0.1:{port}") as ch:
            assert ch.rdv is None
            big = bytes(range(251)) * 16384
            assert bytes(ch.unary_unary("/rdv.S/Echo")(big, timeout=30)) \
                == big
            assert all(c.rdv is None for c in srv._connections)
    finally:
        srv.stop(grace=0)


# -- the health service over h2 ---------------------------------------------------

@pytest.fixture(scope="module")
def health_pair():
    out = {}
    for name, pkg, hmod in (("jax", jrpc, jhealth), ("torch", trpc, thealth)):
        srv = pkg.Server(max_workers=4)
        servicer = hmod.add_health_servicer(srv)
        servicer.set("h2.Svc", hmod.ServingStatus.SERVING)
        servicer.set("h2.Down", hmod.ServingStatus.NOT_SERVING)
        port = srv.add_insecure_port("127.0.0.1:0")
        srv.start()
        out[name] = (srv, port)
    yield {k: v[1] for k, v in out.items()}
    for srv, _ in out.values():
        srv.stop(grace=0)


def _grpcio_check(port, service):
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        mc = ch.unary_unary(f"/{thealth.SERVICE_NAME}/Check", _ID, _ID)
        try:
            return ("ok", mc(thealth.encode_request(service), timeout=10))
        except grpc.RpcError as exc:
            return ("error", exc.code().name, exc.details())


@pytest.mark.parametrize("service", ["h2.Svc", "h2.Down", "", "missing"])
def test_stock_grpcio_health_check_over_h2(health_pair, service):
    got = _grpcio_check(health_pair["torch"], service)
    assert got == _grpcio_check(health_pair["jax"], service)
    if service == "missing":
        assert got[1] == "NOT_FOUND"
    else:
        want = (thealth.ServingStatus.NOT_SERVING if service == "h2.Down"
                else thealth.ServingStatus.SERVING)
        assert thealth.decode_response(got[1]) is want


def test_stock_grpcio_health_watch_over_h2(health_pair):
    with grpc.insecure_channel(f"127.0.0.1:{health_pair['torch']}") as ch:
        stream = ch.unary_stream(f"/{thealth.SERVICE_NAME}/Watch", _ID, _ID)(
            thealth.encode_request("h2.Svc"), timeout=10)
        assert thealth.decode_response(next(stream)) is \
            thealth.ServingStatus.SERVING
        stream.cancel()


# -- a stock grpcio client reaching a fleet ------------------------------------

@pytest.mark.parametrize("listener", ["reuseport", "handoff"])
def test_stock_grpcio_client_reaches_sharded_fleet(torch_on_cpu, tmp_path,
                                                   listener):
    """A 2-worker ``serve_torch_sharded`` transformer fleet (the port's
    model from the reference's parameters): stock grpcio channels, each its
    own connection, get every reply within the float32 forward test's
    tolerance of the reference's direct output."""
    jcfg, _ = _cfgs(SMALL)
    params = _jax_params(jcfg, seed=6)
    npz = tmp_path / "params.npz"
    np.savez(npz, **{k: np.asarray(v) for k, v in params.items()})
    rows = np.random.default_rng(12).integers(
        0, SMALL["vocab"], (8, 1, 16)).astype(np.int32)
    want = _ref_logits(jcfg, params, rows[:, 0])
    build_fn = functools.partial(builds.transformer_fn, str(npz),
                                 json.dumps(SMALL))

    def ser(tree):
        return b"".join(bytes(memoryview(s).cast("B"))
                        for s in codec.tree_serializer(tree))

    with _launch_lock():
        sup = tsvc.serve_torch_sharded(build_fn, workers=2, name="Generate",
                                       batching=True, max_batch=8,
                                       max_delay_s=0.005, listener=listener)
        try:
            with contextlib.ExitStack() as stack:
                chans = [stack.enter_context(grpc.insecure_channel(
                    f"127.0.0.1:{sup.port}",
                    options=[("grpc.use_local_subchannel_pool", 1)]))
                    for _ in range(4)]
                got = [chans[i % 4].unary_unary(
                    "/tpurpc.Tensor/Generate", ser, codec.tree_deserializer)(
                        {"tokens": torch.from_numpy(r)}, timeout=CALL)
                    for i, r in enumerate(rows)]
            assert sup.alive_workers() == [0, 1]
        finally:
            sup.stop()
    for i, g in enumerate(got):
        logits = g["logits"].numpy()
        assert logits.shape == (1, 16, SMALL["vocab"])
        err = np.abs(logits[0] - want[i]).max() / max(
            1.0, np.abs(want[i]).max())
        assert err <= F32_TOL, (i, err)


# -- stop and drain with h2 connections open ------------------------------------

def _hold_server():
    srv = trpc.Server(max_workers=8)
    release = threading.Event()
    srv.add_method("/t.S/Echo", trpc.unary_unary_rpc_method_handler(
        lambda req, ctx: bytes(req)))
    srv.add_method("/t.S/Hold", trpc.unary_unary_rpc_method_handler(
        lambda req, ctx: (release.wait(20), bytes(req))[1]))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port, release


@pytest.mark.parametrize("client", ["grpcio", "H2Channel"])
def test_graceful_stop_with_h2_connection(client):
    """stop(grace) survives connections speaking h2 (no native writer to
    GOAWAY: h2's own GOAWAY instead) and still terminates."""
    srv = trpc.Server(max_workers=2)
    srv.add_method("/test.Echo/Echo",
                   trpc.unary_unary_rpc_method_handler(lambda b, c: bytes(b)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    target = f"127.0.0.1:{port}"
    with (grpc.insecure_channel(target) if client == "grpcio"
          else H2Channel(target)) as ch:
        mc = (ch.unary_unary("/test.Echo/Echo", _ID, _ID)
              if client == "grpcio" else ch.unary_unary("/test.Echo/Echo"))
        assert mc(b"hi", timeout=20) == b"hi"
        ev = srv.stop(grace=1)          # h2 conn live: must not raise
        assert ev.wait(timeout=10)


def test_drain_with_h2_connections_fails_no_accepted_call():
    """drain() with a stock grpcio call and an H2Channel call in flight:
    both h2 connections get GOAWAY naming the streams they have open,
    both calls finish with their replies, the drain reports every stream
    done, and a new call on the H2Channel is refused before it is sent."""
    srv, port, release = _hold_server()
    target = f"127.0.0.1:{port}"
    out = {}
    try:
        with grpc.insecure_channel(target) as gch, H2Channel(target) as hch:
            assert gch.unary_unary("/t.S/Echo", _ID, _ID)(
                b"w", timeout=20) == b"w"
            assert hch.unary_unary("/t.S/Echo")(b"w", timeout=20) == b"w"
            fut = gch.unary_unary("/t.S/Hold", _ID, _ID).future(
                b"g", timeout=30)
            t = threading.Thread(target=lambda: out.update(
                h=hch.unary_unary("/t.S/Hold")(b"h", timeout=30)))
            t.start()
            assert _poll(lambda: srv.inflight_requests() == 2)
            d = threading.Thread(target=lambda: out.update(
                drained=srv.drain(linger=20)))
            d.start()
            assert _poll(lambda: hch._goaway is not None)
            with pytest.raises(RpcError) as ei:
                hch.unary_unary("/t.S/Echo")(b"late", timeout=5)
            assert ei.value.code() is StatusCode.UNAVAILABLE
            assert "draining" in ei.value.details()
            release.set()
            assert fut.result(timeout=30) == b"g"
            t.join(30)
            d.join(30)
        assert out == {"h": b"h", "drained": True}
        assert _poll(lambda: not srv._connections)
    finally:
        release.set()
        srv.stop(grace=0)


def test_h2_stream_after_goaway_is_refused_not_served():
    """A HEADERS frame that crosses the GOAWAY (a stream above the last one
    named) is answered RST_STREAM REFUSED_STREAM: the client may replay it
    elsewhere, and the handler never runs. Driven by raw frames, so that
    the stream surely crosses."""
    seen = []
    srv = trpc.Server(max_workers=2)
    srv.add_method("/t.S/Echo", trpc.unary_unary_rpc_method_handler(
        lambda req, ctx: (seen.append(bytes(req)), bytes(req))[1]))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    enc = hpack.HpackEncoder()
    hdrs = [(":method", "POST"), (":scheme", "http"), (":path", "/t.S/Echo"),
            (":authority", "x"), ("te", "trailers"),
            ("content-type", "application/grpc")]

    def call(sid, msg):
        return b"".join(
            h2.pack_frame(h2.HEADERS, h2.FLAG_END_HEADERS, sid,
                          enc.encode(hdrs))
            + h2.pack_frame(h2.DATA, h2.FLAG_END_STREAM, sid,
                            struct.pack("!BI", 0, len(msg)) + msg))

    def read_until(sock, scanner, want):
        frames = []
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            frames += scanner.next_frames()
            if any(want(f) for f in frames):
                return frames
            scanner.feed(sock.recv(65536))
        raise AssertionError(frames)

    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        scanner = h2.FrameScanner()
        sock.sendall(h2.PREFACE + b"".join(h2.pack_settings({})) + call(1, b"a"))
        read_until(sock, scanner, lambda f: f[0] == h2.HEADERS and f[2] == 1
                   and f[1] & h2.FLAG_END_STREAM)
        # the server registers a connection after it starts serving it, so
        # the reply can arrive first
        deadline = time.monotonic() + 10
        while not srv._connections and time.monotonic() < deadline:
            time.sleep(0.01)
        srv._connections[0].goaway(b"test")
        sock.sendall(call(3, b"b"))
        frames = read_until(sock, scanner,
                            lambda f: f[0] == h2.RST_STREAM and f[2] == 3)
        goaway = [f for f in frames if f[0] == h2.GOAWAY]
        assert struct.unpack_from("!II", goaway[0][3]) == (1, h2.NO_ERROR)
        rst = [f for f in frames if f[0] == h2.RST_STREAM]
        assert struct.unpack("!I", rst[0][3])[0] == 0x7  # REFUSED_STREAM
        assert seen == [b"a"]
        sock.close()
    finally:
        srv.stop(grace=0)


# -- tests/test_dropin.py, against the port --------------------------------------

@pytest.mark.parametrize("dial", ["insecure_channel", "H2Channel"])
def test_grpcio_shaped_program_runs_verbatim(dial):
    grpc = trpc  # noqa: F811 — the port: `import tpurpc_torch.rpc as grpc`

    # -- server exactly as a grpcio app writes it --
    class Greeter:
        def SayHello(self, request, context):
            return b"Hello, " + bytes(request) + b"!"

    greeter = Greeter()
    server = grpc.server(max_workers=4)
    handlers = grpc.method_handlers_generic_handler(
        "demo.Greeter",
        {"SayHello": grpc.unary_unary_rpc_method_handler(greeter.SayHello)})
    server.add_generic_rpc_handlers((handlers,))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    try:
        # -- client exactly as a grpcio app writes it --
        channel = getattr(grpc, dial)(f"127.0.0.1:{port}")
        hello = channel.unary_unary("/demo.Greeter/SayHello")
        assert bytes(hello(b"world", timeout=10)) == b"Hello, world!"
        with pytest.raises(grpc.RpcError) as ei:
            channel.unary_unary("/no.Such/Method")(b"", timeout=10)
        assert ei.value.code() is grpc.StatusCode.UNIMPLEMENTED
        channel.close()
    finally:
        server.stop(grace=0)


def test_grpcio_constructor_shapes():
    """The stock grpcio constructor calls run verbatim: an executor as the
    first server() argument, options lists on both sides."""
    from concurrent import futures as cf

    grpc = trpc  # noqa: F811 — the port: `import tpurpc_torch.rpc as grpc`

    class Greeter:
        def SayHello(self, request, context):
            return bytes(request) + b"!"

    server = grpc.server(
        cf.ThreadPoolExecutor(max_workers=6),
        options=[("grpc.max_receive_message_length", 128),
                 ("grpc.so_reuseport", 0)])  # unknown arg: ignored
    assert server.max_receive_message_length == 128
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "d.G", {"SayHello": grpc.unary_unary_rpc_method_handler(
            Greeter().SayHello)}),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    try:
        ch = grpc.insecure_channel(
            f"127.0.0.1:{port}",
            options=[("grpc.max_receive_message_length", 64 << 20),
                     ("grpc.lb_policy_name", "round_robin")])
        assert ch.max_receive_message_length == 64 << 20
        assert bytes(ch.unary_unary("/d.G/SayHello")(b"hi", timeout=10)) \
            == b"hi!"
        # server-side limit from options enforced: >128B rejected
        with pytest.raises(grpc.RpcError) as ei:
            ch.unary_unary("/d.G/SayHello")(b"x" * 256, timeout=10)
        assert ei.value.code() is grpc.StatusCode.RESOURCE_EXHAUSTED
        ch.close()
    finally:
        server.stop(grace=0)


def test_generic_handler_objects_resolve_per_call():
    """grpcio's GenericRpcHandler objects (``.service(details)``) and its
    own handler objects register on the port's server, on both planes."""
    class Handler(grpc.GenericRpcHandler):
        def service(self, details):
            if details.method == "/g.S/Up":
                return grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: bytes(req).upper(), _ID, _ID)
            return None

    srv = trpc.server(2, handlers=(Handler(),))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with trpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            assert bytes(ch.unary_unary("/g.S/Up")(b"ab", timeout=10)) == b"AB"
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            assert ch.unary_unary("/g.S/Up", _ID, _ID)(b"cd", timeout=10) \
                == b"CD"
            with pytest.raises(grpc.RpcError) as ei:
                ch.unary_unary("/g.S/Down", _ID, _ID)(b"", timeout=10)
            assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        srv.stop(grace=0)
    # server(interceptors=...) passes them through: both planes see them
    seen = []

    class Seen(trpc.ServerInterceptor):
        def intercept_service(self, continuation, details):
            seen.append(details.method)
            return continuation(details)

    srv = trpc.server(2, handlers=(Handler(),), interceptors=[Seen()])
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with trpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            assert bytes(ch.unary_unary("/g.S/Up")(b"ef", timeout=10)) == b"EF"
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            assert ch.unary_unary("/g.S/Up", _ID, _ID)(b"gh", timeout=10) \
                == b"GH"
    finally:
        srv.stop(grace=0)
    assert seen == ["/g.S/Up", "/g.S/Up"]


def test_rpc_surface_exports_only_what_the_port_has():
    for name in ("Channel", "insecure_channel", "Server", "server",
                 "method_handlers_generic_handler", "H2Channel",
                 "stream_unary_rpc_method_handler", "register_resolver",
                 "ring_hash_key", "add_health_servicer", "Metadata",
                 "RetryPolicy", "intercept_channel", "ClientInterceptor",
                 "ServerInterceptor", "FaultConfig", "FaultInjector",
                 "secure_channel", "enable_server_reflection",
                 "enable_channelz", "ChannelCredentials", "ServerCredentials",
                 "ssl_channel_credentials", "ssl_server_credentials",
                 "insecure_for_testing_channel_credentials", "aio",
                 "LoadBalancerServicer", "enable_lookaside",
                 "ChannelConnectivity", "channel_ready_future",
                 "inproc_channel", "NativeChannel"):
        assert hasattr(trpc, name), name
    assert trpc.H2Channel is H2Channel
    from tpurpc_torch.rpc.native_client import NativeChannel

    assert trpc.NativeChannel is NativeChannel
    # the package's `server` is the module, callable as grpcio's factory
    from tpurpc_torch.rpc import server as server_module

    assert server_module.LOAD_KEY == "tpurpc-load"
    assert isinstance(trpc.server(1), trpc.Server)
    # the reference's exports, all present now
    import tpurpc.rpc as jrpc_pkg

    assert set(jrpc_pkg.__all__) <= set(trpc.__all__)
