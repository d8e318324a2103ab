"""The port's interceptors and fault injection
(``tpurpc_torch/rpc/interceptors.py``) against the reference's.

The cases of ``tests/test_interceptors.py`` on both packages, with each
package's server and client: the server chain's order and what it sees,
a client interceptor rewriting the call's details (on all four shapes),
``FaultInjector``'s configured abort, its seeded fractions (the same
outcome sequence in both packages), and its aborts reaching a stock
grpcio client over HTTP/2.

Then the device path: a ``device=True`` tensor method on the device-ring
platform (the port on the CPU ring, a 64 KiB ``HbmRing``) behind a seeded
``FaultInjector``, called through a channel whose service config retries
UNAVAILABLE under a retry throttle. Each package's replies equal its
direct run and each other's; the attempts each server saw, the throttle's
tokens and the ring's landings equal the arithmetic of the seeded abort
sequence; an aborted attempt lands nothing; the ring's credit returns in
full.
"""

import random
import threading

import grpc
import numpy as np
import pytest
import torch

from chip_smoke import retry_arithmetic
from torch_call_plane import (PKGS, PORT, REF, both, code_of, observe, poll,
                              serve)

SERVERS = ["ref", "port"]
PAIRS = [("ref", "ref"), ("ref", "port"), ("port", "ref"), ("port", "port")]
CALL = 10
_ID = lambda x: x  # noqa: E731


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    from tpurpc_torch.utils import config as torch_config

    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    torch_config.set_config(None)
    yield
    torch_config.set_config(None)


def _echo(srv_pkg, interceptors=()):
    return serve(srv_pkg, {"/t.S/Echo": ("unary_unary", lambda r, c: r)},
                 interceptors=interceptors, max_workers=4)


def _tagger(srv_pkg, tag: bytes):
    """A server interceptor appending ``tag`` to the reply; it records the
    methods and metadata it saw."""
    class Tagger(srv_pkg.interceptors.ServerInterceptor):
        def __init__(self):
            self.seen = []

        def intercept_service(self, continuation, details):
            self.seen.append((details.method,
                              dict(details.invocation_metadata or [])))
            handler = continuation(details)
            if handler is None:
                return None
            inner = handler.behavior
            return srv_pkg.server.RpcMethodHandler(
                handler.kind, lambda req, ctx: bytes(inner(req, ctx)) + tag,
                handler.request_deserializer, handler.response_serializer)

    return Tagger()


@pytest.mark.parametrize("client, server", PAIRS)
def test_server_interceptor_chain_order(client, server):
    pkg, srv_pkg = PKGS[client], PKGS[server]
    a, b = _tagger(srv_pkg, b"-a"), _tagger(srv_pkg, b"-b")
    srv, port = _echo(srv_pkg, [a, b])
    try:
        with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
            out = bytes(ch.unary_unary("/t.S/Echo")(b"x", timeout=CALL,
                                                    metadata=[("k", "v")]))
            missing = observe(lambda: ch.unary_unary("/t.S/Nope")(
                b"x", timeout=CALL))
    finally:
        srv.stop(grace=0)
    # the first interceptor is outermost: its tag is applied last; an
    # unknown method passes the chain as None and stays UNIMPLEMENTED
    assert out == b"x-b-a"
    assert [m for m, _ in a.seen] == ["/t.S/Echo", "/t.S/Nope"]
    assert a.seen[0][1].get("k") == "v" and b.seen == a.seen
    assert missing[:2] == ("error", "UNIMPLEMENTED")


@pytest.mark.parametrize("client, server", PAIRS)
def test_client_interceptor_rewrites_details(client, server):
    """The client chain adds metadata on every shape, and may rewrite the
    timeout; the server sees what the chain produced."""
    pkg, srv_pkg = PKGS[client], PKGS[server]
    observed = []

    class Probe(srv_pkg.interceptors.ServerInterceptor):
        def intercept_service(self, continuation, details):
            observed.append((details.method,
                             dict(details.invocation_metadata or [])
                             .get("seen")))
            return continuation(details)

    class AddMd(pkg.interceptors.ClientInterceptor):
        def __init__(self, tag):
            self.tag = tag
            self.calls = []

        def intercept_call(self, continuation, details, request):
            self.calls.append(details.method)
            details.metadata = (list(details.metadata or [])
                                + [("seen", self.tag)])
            return continuation(details, request)

    srv, port = serve(srv_pkg, {
        "/t.S/Echo": ("unary_unary", lambda r, c: r),
        "/t.S/Split": ("unary_stream", lambda r, c: iter([r[:1], r[1:]])),
        "/t.S/Join": ("stream_unary",
                      lambda it, c: b"".join(bytes(x) for x in it)),
        "/t.S/Dup": ("stream_stream", lambda it, c: (x for x in it))},
        interceptors=[Probe()])
    outer, inner = AddMd("1"), AddMd("2")
    try:
        with pkg.channel.Channel(f"127.0.0.1:{port}") as raw:
            ch = pkg.interceptors.intercept_channel(raw, outer, inner)
            got = [bytes(ch.unary_unary("/t.S/Echo")(b"q", timeout=CALL)),
                   [bytes(m) for m in ch.unary_stream("/t.S/Split")(
                       b"ab", timeout=CALL)],
                   bytes(ch.stream_unary("/t.S/Join")(iter([b"c", b"d"]),
                                                      timeout=CALL)),
                   [bytes(m) for m in ch.stream_stream("/t.S/Dup")(
                       iter([b"e", b"f"]), timeout=CALL)]]
            resp, call = ch.unary_unary("/t.S/Echo").with_call(
                b"w", timeout=CALL)
            got.append((bytes(resp), call.code().name))
    finally:
        srv.stop(grace=0)
    assert got == [b"q", [b"a", b"b"], b"cd", [b"e", b"f"], (b"w", "OK")]
    assert outer.calls == inner.calls == [
        "/t.S/Echo", "/t.S/Split", "/t.S/Join", "/t.S/Dup", "/t.S/Echo"]
    # grpcio's metadata keeps both values; the last one wins in a dict
    assert observed == [(m, "2") for m in outer.calls]


def test_intercepted_channel_ping_passes_through():
    """``ping`` goes to the wrapped channel, and both packages' answer, on
    a server of either package."""
    for srv_pkg in (REF, PORT):
        srv, port = _echo(srv_pkg)
        try:
            for pkg in (REF, PORT):
                with pkg.channel.Channel(f"127.0.0.1:{port}") as raw:
                    rtt = pkg.interceptors.intercept_channel(raw).ping(5.0)
                    assert 0 <= rtt < 5.0
        finally:
            srv.stop(grace=0)


@pytest.mark.parametrize("client, server", PAIRS)
def test_fault_injector_aborts_with_configured_code(client, server):
    pkg, srv_pkg = PKGS[client], PKGS[server]
    fi = srv_pkg.interceptors.FaultInjector({"/t.S/Echo": srv_pkg.interceptors
                                             .FaultConfig(
        abort_code=code_of(srv_pkg, "RESOURCE_EXHAUSTED"),
        abort_message="injected overload", abort_fraction=1.0)},
        rng=random.Random(7))
    srv, port = _echo(srv_pkg, [fi])
    try:
        with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
            out = observe(lambda: ch.unary_unary("/t.S/Echo")(b"x",
                                                              timeout=CALL))
    finally:
        srv.stop(grace=0)
    assert out == ("error", "RESOURCE_EXHAUSTED", "injected overload")


@pytest.mark.parametrize("seed", [3, 11])
def test_fault_injector_fractional_same_sequence(seed):
    """The seeded injector gives the same ok/fail sequence in both
    packages, and the one its rng predicts; delays drawn first."""
    def scenario(pkg):
        fi = pkg.interceptors.FaultInjector({"*": pkg.interceptors.FaultConfig(
            abort_code=code_of(pkg, "UNAVAILABLE"), abort_fraction=0.5,
            delay_s=0.001, delay_fraction=0.25)}, rng=random.Random(seed))
        srv, port = _echo(pkg, [fi])
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                mc = ch.unary_unary("/t.S/Echo")
                return [observe(lambda: bytes(mc(b"x", timeout=CALL)))[0]
                        for _ in range(30)]
        finally:
            srv.stop(grace=0)

    got = both(scenario)
    rng = random.Random(seed)
    want = []
    for _ in range(30):
        rng.random()  # the delay's draw
        want.append("error" if rng.random() < 0.5 else "ok")
    assert got == want
    assert got.count("ok") > 3 and got.count("error") > 3


@pytest.mark.parametrize("server", SERVERS)
def test_fault_injector_on_h2_path(server):
    """A stock grpcio client sees injected faults too (one chain for both
    wire planes)."""
    srv_pkg = PKGS[server]
    fi = srv_pkg.interceptors.FaultInjector({"/t.S/Echo": srv_pkg.interceptors
                                             .FaultConfig(
        abort_code=code_of(srv_pkg, "FAILED_PRECONDITION"),
        abort_message="h2 injected", abort_fraction=1.0)})
    srv, port = _echo(srv_pkg, [fi])
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary("/t.S/Echo", _ID, _ID)
            with pytest.raises(grpc.RpcError) as ei:
                mc(b"x", timeout=CALL)
            assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
            assert ei.value.details() == "h2 injected"
    finally:
        srv.stop(grace=0)


def test_server_factory_takes_interceptors_alike():
    def scenario(pkg):
        seen = []

        class Seen(pkg.interceptors.ServerInterceptor):
            def intercept_service(self, continuation, details):
                seen.append(details.method)
                return continuation(details)

        srv = pkg.rpc.server(2, interceptors=[Seen()])
        srv.add_method("/t.S/Echo", pkg.server.unary_unary_rpc_method_handler(
            lambda r, c: r))
        port = srv.add_insecure_port("127.0.0.1:0")
        srv.start()
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                out = bytes(ch.unary_unary("/t.S/Echo")(b"z", timeout=CALL))
        finally:
            srv.stop(grace=0)
        return out, seen, len(srv.interceptors)

    assert both(scenario) == (b"z", ["/t.S/Echo"], 1)


# -- the device path -------------------------------------------------------------

RING_KB = 64
SHAPE = (8, 32)            # float32: 1,024 bytes a request
REQUESTS = 12
ABORT_FRACTION = 0.3
RETRY = {"maxAttempts": 5, "initialBackoff": "0.01s", "maxBackoff": "0.1s",
         "backoffMultiplier": 2, "retryableStatusCodes": ["UNAVAILABLE"]}
THROTTLE = {"maxTokens": 10, "tokenRatio": 0.5}


@pytest.fixture
def tpu_platform(monkeypatch):
    """Both packages on the device-ring platform, the port on the CPU
    (``tests/test_torch_slice.py``'s fixture)."""
    from tpurpc.core import _native as ref_native
    from tpurpc.utils import config as jax_config
    from tpurpc_torch.core import _native as port_native
    from tpurpc_torch.core.poller import PairPool, Poller
    from tpurpc_torch.utils import config as torch_config

    ref_native.load()
    port_native.load()  # and the port's, outside deadlines too
    monkeypatch.setenv("GRPC_PLATFORM_TYPE", "TPU")
    monkeypatch.setenv("TPURPC_HBM_RING_SIZE_KB", str(RING_KB))
    jax_config.set_config(None)
    torch_config.set_config(None)
    yield
    Poller.reset()
    PairPool.reset()
    jax_config.set_config(None)
    torch_config.set_config(None)


def _device_rig(pkg, seed):
    """A ``pkg`` server with a device-mode tensor method behind a counting
    interceptor and a seeded FaultInjector."""
    if pkg is REF:
        from tpurpc.jaxshim import add_tensor_method
    else:
        from tpurpc_torch.torchshim.service import add_tensor_method
    counted = []

    class Count(pkg.interceptors.ServerInterceptor):
        def intercept_service(self, continuation, details):
            counted.append(details.method)
            return continuation(details)

    fi = pkg.interceptors.FaultInjector({"*": pkg.interceptors.FaultConfig(
        abort_code=code_of(pkg, "UNAVAILABLE"),
        abort_fraction=ABORT_FRACTION)}, rng=random.Random(seed))
    srv = pkg.server.Server(max_workers=2, interceptors=[Count(), fi])
    add_tensor_method(srv, "Affine", lambda t: {"y": t["x"] * 2 + 1},
                      device=True)
    srv.start()
    return srv, srv.add_insecure_port("127.0.0.1:0"), counted


@pytest.mark.parametrize("seed", [0, 5])
def test_device_method_behind_fault_injector_with_retries(tpu_platform, seed):
    from tpurpc.jaxshim import TensorClient as JaxClient
    from tpurpc.tpu import ledger as ref_ledger
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.torchshim.service import TensorClient
    from tpurpc_torch.tpu import ledger

    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(SHAPE).astype(np.float32)
          for _ in range(REQUESTS)]
    cfg = {"methodConfig": [{"name": [{"service": "tpurpc.Tensor"}],
                             "retryPolicy": RETRY}],
           "retryThrottling": THROTTLE}
    attempts, aborts, tokens = retry_arithmetic(
        seed, REQUESTS, ABORT_FRACTION, RETRY["maxAttempts"], THROTTLE)
    assert aborts > 0

    obs = {}
    for pkg, client, track, wrap in (
            (REF, JaxClient, ref_ledger.track, lambda x: x),
            (PORT, TensorClient, ledger.track, torch.from_numpy)):
        srv, port, counted = _device_rig(pkg, seed)
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                ch.update_service_config(cfg)
                tc = client(ch)
                with track() as w:
                    replies = [np.asarray(tc.call("Affine", {"x": wrap(x)},
                                                  timeout=CALL)["y"])
                               for x in xs]
                left = ch._service_config.retry_throttle.tokens()
                conns = list(srv._connections)
                stats = conns[0].endpoint.device_ring.stats()
        finally:
            srv.stop(grace=0)
        obs[pkg.name] = dict(replies=replies, attempts=len(counted),
                             conns=len(conns),
                             tokens=left, tail=stats["tail"],
                             writable=stats["writable"],
                             capacity=stats["capacity"],
                             live=stats["live_spans"], ledger=w.delta)
    ref, port = obs["ref"], obs["port"]
    for x, a, b in zip(xs, ref["replies"], port["replies"]):
        np.testing.assert_array_equal(b, x * 2 + 1)
        np.testing.assert_array_equal(a, b)
    nbytes = int(np.prod(SHAPE)) * 4
    for o in (ref, port):
        assert o["conns"] == 1
        assert o["attempts"] == attempts
        assert o["tokens"] == pytest.approx(tokens)
        # only the attempts that reached the handler landed a payload
        assert o["tail"] == REQUESTS * nbytes
        assert o["writable"] == o["capacity"] == RING_KB << 10
        assert o["live"] == 0
    # one landing (a host-to-device write, then the in-ring write) and one
    # aliasing view per successful attempt, in both packages' ledgers
    moves = ("dma_h2d", "dma_d2h", "dma_d2d", "zero_copy", "rdma_write")
    for o in (ref, port):
        assert {k: o["ledger"][k] for k in moves} == {
            "dma_h2d": REQUESTS * nbytes, "dma_d2h": 0,
            "dma_d2d": REQUESTS * nbytes, "zero_copy": REQUESTS * nbytes,
            "rdma_write": 0}
        assert o["ledger"]["dma_h2d_ops"] == REQUESTS
    assert (rs_mod.launches, rw_mod.launches) == (0, 0)  # no card here


@pytest.mark.parametrize("client", ["ref", "port"])
def test_device_hedge_loser_releases_its_ring_credit(tpu_platform, client):
    """Hedging across two device-ring servers, the first held: the hedge
    wins on the second, and once the held handler is let go it lands the
    request, runs, replies into a cancelled stream, and its ring's credit
    comes back in full."""
    from tpurpc_torch.torchshim.service import TensorClient, add_tensor_method

    pkg = PKGS[client]
    if pkg is REF:
        from tpurpc.jaxshim import TensorClient as Client
    else:
        Client = TensorClient
    hold = threading.Event()
    entered, finished = [], []

    def slow(t):
        entered.append(1)
        hold.wait(20)
        out = {"y": t["x"] + 1}
        finished.append(1)
        return out

    srvs = []
    for fn in (slow, lambda t: {"y": t["x"] + 1}):
        s = PORT.server.Server(max_workers=4)
        add_tensor_method(s, "Inc", fn, device=True)
        s.start()
        srvs.append((s, s.add_insecure_port("127.0.0.1:0")))
    x = np.arange(256, dtype=np.float32)
    arg = x if pkg is REF else torch.from_numpy(x)
    try:
        target = "ipv4:" + ",".join(f"127.0.0.1:{p}" for _, p in srvs)
        hp = pkg.channel.HedgingPolicy(max_attempts=2, hedging_delay=0.05)
        with pkg.channel.Channel(target, lb_policy="pick_first",
                                 hedging_policy=hp) as ch:
            # a hedge registers its subchannel once its stream is open:
            # dial both first, so that the hedge cannot pick the held one
            for sc in ch._subchannels:
                sc.get()
            out = np.asarray(Client(ch).call("Inc", {"x": arg},
                                             timeout=CALL)["y"])
            held = (len(entered), len(finished))
            hold.set()
            done = poll(lambda: finished)
            ring = srvs[0][0]._connections[0].endpoint.device_ring
            back = poll(lambda: ring.stats()["writable"] == ring.capacity
                        and ring.stats()["live_spans"] == 0)
            tail = ring.stats()["tail"]
    finally:
        hold.set()
        for s, _ in srvs:
            s.stop(grace=0)
    np.testing.assert_array_equal(out, x + 1)
    assert held == (1, 0) and done and back
    assert tail == x.nbytes  # the loser did land its request
