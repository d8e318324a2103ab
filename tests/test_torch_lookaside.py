"""Look-aside load balancing (grpclb) in the port, against the reference.

Twins of ``tests/test_lookaside.py``'s twelve cases. Wherever a case
crosses the wire it runs on every client/server package pair that has the
port in it: a port channel (and its watcher) against the reference's
servers and balancer, a reference channel against the port's, and the port
against itself. The ``grpc.lb.v1`` encoders (``tpurpc_torch.rpc.lb_v1``)
must write the reference's bytes on seeded inputs and agree with protobuf;
a stock grpcio client subscribes to the port's balancer; and two CPU
device-ring backends (``TPU``, the kernels' plain versions) behind a port
balancer answer as direct calls do, with the plain versions run per server
as the ring offsets say and the port's ledger billing what direct calls
bill.

The reference's factory-channel guards build their channel on
``passthru_endpoint_pair``, which the port does not have yet; the port's
twins build a channel whose ``endpoint_factory`` is never called.

Rules these tests keep, so that they leave nothing behind for the next
test in the same worker: protobuf message classes come from a private
``DescriptorPool`` fed by ``protoc --include_imports
--descriptor_set_out``, never from the default pool (the reference's test
compiles ``load_balancer.proto`` into that one). Every watcher is stopped
in a ``finally`` before its balancer; every server is stopped and every
channel closed; every wait and every call has its own timeout; ports are
ephemeral. The device-ring case sets the platform through ``monkeypatch``
and resets both packages' cached configs and the port's pollers.
"""

import random
import shutil
import subprocess
import textwrap
import time
import types

import numpy as np
import pytest
import torch

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from chip_smoke import CallPlaneServer
from torch_call_plane import (counted_plain, platform,  # noqa: F401
                             small_classify)
from tpurpc.rpc import lb_v1 as ref_lb_v1
from tpurpc.rpc import lookaside as ref_la
from tpurpc.rpc import status as ref_status
from tpurpc_torch.rpc import lb_v1 as port_lb_v1
from tpurpc_torch.rpc import lookaside as port_la
from tpurpc_torch.rpc import status as port_status
from tpurpc_torch.rpc.channel import Channel as PortChannel
from tpurpc_torch.torchshim.service import TensorClient
from tpurpc_torch.tpu import ledger

PKG = {"ref": types.SimpleNamespace(rpc=jrpc, la=ref_la, lb_v1=ref_lb_v1),
       "port": types.SimpleNamespace(rpc=trpc, la=port_la,
                                     lb_v1=port_lb_v1)}
#: (client, server): the client's channel and watcher, the server's
#: backends and balancer
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]
PAIR_IDS = [f"{c}-to-{s}" for c, s in PAIRS]
RPC_ERRORS = (ref_status.RpcError, port_status.RpcError)
#: every wait on a call, a membership change or a report
WAIT_S = 30
#: the device-ring case: a 64 KiB ring and requests of 12,288 bytes, whose
#: 6th landing from offset 0 wraps it
RING_KB, DR_SHAPE, DR_REQUESTS = 64, (2, 32, 16, 3), 8


def _named_server(pkg: str, name: str):
    rpc = PKG[pkg].rpc
    srv = rpc.Server(max_workers=4)
    srv.add_method("/l.S/Who",
                   rpc.unary_unary_rpc_method_handler(
                       lambda r, c, n=name: n.encode()))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _balancer(pkg: str, **kw):
    """A started balancer server of ``pkg``: (servicer, server, port)."""
    srv = PKG[pkg].rpc.Server(max_workers=4)
    balancer = PKG[pkg].la.LoadBalancerServicer(**kw)
    balancer.attach(srv)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return balancer, srv, port


def _await(fn, timeout=WAIT_S, every=0.05):
    """Poll until fn() is truthy; a call racing a membership swap may land
    on a just-closed backend once, so an RpcError of either package reads
    as not yet."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if fn():
                return True
        except RPC_ERRORS:
            pass
        time.sleep(every)
    return False


def _never():
    raise AssertionError("the endpoint factory must not be called")


def _factory_channel(pkg: str):
    """A channel of fixed membership: the port's never dials; the
    reference's is its own test's passthru pair."""
    if pkg == "port":
        return PortChannel(endpoint_factory=_never)
    from tpurpc.core.endpoint import passthru_endpoint_pair
    from tpurpc.rpc.channel import Channel

    a, _b = passthru_endpoint_pair()
    return Channel(endpoint_factory=lambda: a)


# -- update_addresses (the mechanism) ----------------------------------------

@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_update_addresses_moves_traffic_and_keeps_live_subchannels(client,
                                                                   server):
    s1, p1 = _named_server(server, "one")
    s2, p2 = _named_server(server, "two")
    try:
        with PKG[client].rpc.Channel(f"127.0.0.1:{p1}") as ch:
            who = ch.unary_unary("/l.S/Who")
            assert who(b"", timeout=10) == b"one"
            conn_before = ch._subchannels[0]._conn
            ch._lb_spec = "round_robin"
            ch.update_addresses([("127.0.0.1", p1), ("127.0.0.1", p2)])
            assert ch._subchannels[0]._conn is conn_before  # reused, live
            got = {bytes(who(b"", timeout=10)) for _ in range(6)}
            assert got == {b"one", b"two"}
            ch.update_addresses([f"127.0.0.1:{p2}"])
            for _ in range(4):
                assert who(b"", timeout=10) == b"two"
    finally:
        s1.stop(grace=0)
        s2.stop(grace=0)


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_update_addresses_guards(client, server):
    status = ref_status if client == "ref" else port_status
    ch = _factory_channel(client)
    try:
        with pytest.raises(RuntimeError):
            ch.update_addresses(["127.0.0.1:1"])
    finally:
        ch.close()
    s1, p1 = _named_server(server, "x")
    try:
        ch = PKG[client].rpc.Channel(f"127.0.0.1:{p1}")
        try:
            with pytest.raises(ValueError):
                ch.update_addresses([])
        finally:
            ch.close()
        with pytest.raises(status.RpcError):
            ch.update_addresses([f"127.0.0.1:{p1}"])  # closed channel
    finally:
        s1.stop(grace=0)


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_update_addresses_hostname_normalizes_to_resolved(client, server):
    """'localhost:p' matches the constructor's resolved keys: a no-op
    update keeps the live connection."""
    s1, p1 = _named_server(server, "same")
    try:
        with PKG[client].rpc.Channel(f"localhost:{p1}") as ch:
            who = ch.unary_unary("/l.S/Who")
            assert who(b"", timeout=10) == b"same"
            live = [sc._conn for sc in ch._subchannels if sc._conn is not None]
            assert live
            ch.update_addresses([f"localhost:{p1}"])
            kept = [sc._conn for sc in ch._subchannels if sc._conn is not None]
            assert any(c in live for c in kept)
            assert who(b"", timeout=10) == b"same"
    finally:
        s1.stop(grace=0)


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_update_addresses_with_composite_spec_degrades_to_round_robin(
        client, server):
    s1, p1 = _named_server(server, "a")
    s2, p2 = _named_server(server, "b")
    try:
        spec = {"priority": [{"policy": "pick_first", "indices": [0]}]}
        with PKG[client].rpc.Channel(f"127.0.0.1:{p1}", lb_policy=spec) as ch:
            who = ch.unary_unary("/l.S/Who")
            assert who(b"", timeout=10) == b"a"
            ch.update_addresses([f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"])
            got = {bytes(who(b"", timeout=10)) for _ in range(6)}
            assert got == {b"a", b"b"}
    finally:
        s1.stop(grace=0)
        s2.stop(grace=0)


# -- the balancer protocol ----------------------------------------------------

def _directs_and_rebalances(client, server, wire):
    s1, p1 = _named_server(server, "backend1")
    s2, p2 = _named_server(server, "backend2")
    balancer, bal_srv, bal_port = _balancer(server)
    balancer.set_servers("demo", [f"127.0.0.1:{p1}"])
    try:
        with PKG[client].rpc.Channel(f"127.0.0.1:{p2}") as ch:
            watcher = PKG[client].la.enable_lookaside(
                ch, f"127.0.0.1:{bal_port}", "demo", wire=wire)
            try:
                who = ch.unary_unary("/l.S/Who")
                # the balancer's list (backend1) takes over from the fallback
                assert _await(lambda: bytes(who(b"", timeout=10))
                              == b"backend1")
                balancer.set_servers("demo", [f"127.0.0.1:{p2}"])
                assert _await(lambda: bytes(who(b"", timeout=10))
                              == b"backend2")
            finally:
                watcher.stop()
    finally:
        bal_srv.stop(grace=0)
        s1.stop(grace=0)
        s2.stop(grace=0)


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_lookaside_balancer_directs_and_rebalances(client, server):
    _directs_and_rebalances(client, server, "tpurpc")


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_lookaside_over_grpclb_wire(client, server):
    """The same control loop on the standard grpc.lb.v1 protobuf wire."""
    _directs_and_rebalances(client, server, "grpclb")


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_lookaside_falls_back_when_balancer_dies(client, server):
    s1, p1 = _named_server(server, "lbpick")
    s2, p2 = _named_server(server, "fallback")
    balancer, bal_srv, bal_port = _balancer(server)
    balancer.set_servers("d", [f"127.0.0.1:{p1}"])
    try:
        with PKG[client].rpc.Channel(f"127.0.0.1:{p2}") as ch:
            watcher = PKG[client].la.enable_lookaside(
                ch, f"127.0.0.1:{bal_port}", "d")
            try:
                who = ch.unary_unary("/l.S/Who")
                assert _await(lambda: bytes(who(b"", timeout=10))
                              == b"lbpick")
                bal_srv.stop(grace=0)  # balancer gone
                # grpclb's fallback rule: back to the resolver's list
                assert _await(lambda: bytes(who(b"", timeout=10))
                              == b"fallback")
            finally:
                watcher.stop()
    finally:
        bal_srv.stop(grace=0)
        s1.stop(grace=0)
        s2.stop(grace=0)


@pytest.mark.parametrize("watcher", ["port", "ref"])
@pytest.mark.parametrize("channel", ["port", "ref"])
def test_lookaside_rejects_factory_channel(channel, watcher):
    """Either package's watcher refuses a channel of fixed membership of
    either package, and an unknown wire, before it starts a thread."""
    ch = _factory_channel(channel)
    try:
        with pytest.raises(ValueError):
            PKG[watcher].la.enable_lookaside(ch, "127.0.0.1:1", "x")
        with pytest.raises(ValueError, match="look-aside wire"):
            PKG[watcher].la.enable_lookaside(ch, "127.0.0.1:1", "x",
                                             wire="xds")
    finally:
        ch.close()


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_lookaside_grpclb_load_reporting(client, server):
    """The balancer asks for ClientStats every 0.3 s; the watcher streams
    the channel's call-count deltas; the balancer sums them per name."""
    s1, p1 = _named_server(server, "b1")
    balancer, bal_srv, bal_port = _balancer(server, stats_interval_s=0.3)
    balancer.set_servers("load", [f"127.0.0.1:{p1}"])
    try:
        with PKG[client].rpc.Channel(f"127.0.0.1:{p1}") as ch:
            watcher = PKG[client].la.enable_lookaside(
                ch, f"127.0.0.1:{bal_port}", "load", wire="grpclb")
            try:
                who = ch.unary_unary("/l.S/Who")
                assert _await(lambda: bytes(who(b"", timeout=10)) == b"b1")
                # stream-relative deltas: wait until reporting is live,
                # then hold exact deltas for the calls made after a base
                assert _await(lambda: balancer.stats("load") != {})
                base = balancer.stats("load")
                for _ in range(7):
                    who(b"", timeout=10)

                def reported():
                    st = balancer.stats("load")
                    return all(st.get(k, 0) - base.get(k, 0) >= 7
                               for k in ("started", "finished",
                                         "known_received"))

                assert _await(reported), (base, balancer.stats("load"))
            finally:
                watcher.stop()
    finally:
        bal_srv.stop(grace=0)
        s1.stop(grace=0)


# -- grpc.lb.v1 standard wire (lb_v1) -----------------------------------------

LB_PROTO = textwrap.dedent("""\
    syntax = "proto3";
    package grpc.lb.v1;
    import "google/protobuf/duration.proto";
    message LoadBalanceRequest {
      oneof load_balance_request_type {
        InitialLoadBalanceRequest initial_request = 1;
        ClientStats client_stats = 2;
      }
    }
    message InitialLoadBalanceRequest { string name = 1; }
    message ClientStats {
      int64 num_calls_started = 2;
      int64 num_calls_finished = 3;
      int64 num_calls_finished_known_received = 7;
    }
    message LoadBalanceResponse {
      oneof load_balance_response_type {
        InitialLoadBalanceResponse initial_response = 1;
        ServerList server_list = 2;
        FallbackResponse fallback_response = 3;
      }
    }
    message FallbackResponse {}
    message InitialLoadBalanceResponse {
      google.protobuf.Duration client_stats_report_interval = 2;
    }
    message ServerList { repeated Server servers = 1; }
    message Server {
      bytes ip_address = 1;
      int32 port = 2;
      string load_balance_token = 3;
      bool drop = 4;
    }
    """)


@pytest.fixture(scope="module")
def pb(tmp_path_factory):
    """The grpc.lb.v1 message subset's classes from a private
    DescriptorPool; nothing enters protobuf's default pool."""
    if shutil.which("protoc") is None:
        pytest.skip("protoc is not installed")
    from google.protobuf import descriptor_pb2, descriptor_pool
    from google.protobuf import message_factory

    out = tmp_path_factory.mktemp("torch_lb_v1")
    (out / "torch_lb_v1_subset.proto").write_text(LB_PROTO)
    desc = out / "set.pb"
    subprocess.run(["protoc", f"-I{out}", "--include_imports",
                    f"--descriptor_set_out={desc}",
                    str(out / "torch_lb_v1_subset.proto")],
                   check=True, timeout=120)
    pool = descriptor_pool.DescriptorPool()
    for fd in descriptor_pb2.FileDescriptorSet.FromString(
            desc.read_bytes()).file:
        pool.Add(fd)
    return types.SimpleNamespace(**{
        name: message_factory.GetMessageClass(
            pool.FindMessageTypeByName(f"grpc.lb.v1.{name}"))
        for name in ("LoadBalanceRequest", "LoadBalanceResponse")})


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_lb_v1_codec_against_real_protobuf(pb, pkg):
    lb_v1 = PKG[pkg].lb_v1
    req = pb.LoadBalanceRequest.FromString(
        lb_v1.encode_initial_request("svc"))
    assert req.initial_request.name == "svc"
    resp = pb.LoadBalanceResponse.FromString(
        lb_v1.encode_server_list(["127.0.0.1:443", "[::1]:8080",
                                  "not-an-ip:1"]))
    servers = resp.server_list.servers
    assert len(servers) == 2  # hostname skipped: the wire carries IPs
    assert servers[0].ip_address == b"\x7f\x00\x00\x01"
    assert servers[0].port == 443
    kind, lst = lb_v1.decode_response(resp.SerializeToString())
    assert kind == "server_list" and lst == ["127.0.0.1:443", "[::1]:8080"]
    r2 = pb.LoadBalanceRequest()
    r2.initial_request.name = "other"
    assert lb_v1.decode_request(r2.SerializeToString()) == "other"
    # drop-entries are load-shedding directives, not dial targets
    resp2 = pb.LoadBalanceResponse()
    s = resp2.server_list.servers.add()
    s.ip_address, s.port, s.drop = b"\x7f\x00\x00\x01", 1, True
    kind, lst = lb_v1.decode_response(resp2.SerializeToString())
    assert kind == "server_list" and lst == []
    resp3 = pb.LoadBalanceResponse()
    resp3.fallback_response.SetInParent()
    assert lb_v1.decode_response(resp3.SerializeToString()) == (
        "fallback", None)


def _addresses(rng: random.Random, n: int) -> list:
    """A seeded mix of IPv4, IPv6, hostname and unparsable entries."""
    out = []
    for _ in range(n):
        kind = rng.randrange(5)
        port = rng.randrange(1, 65536)
        if kind <= 1:
            out.append(".".join(str(rng.randrange(256)) for _ in range(4))
                       + f":{port}")
        elif kind == 2:
            words = ":".join(f"{rng.randrange(65536):x}" for _ in range(8))
            out.append(f"[{words}]:{port}")
        elif kind == 3:
            out.append(f"host{rng.randrange(100)}.example:{port}")
        else:
            out.append(rng.choice(["no-port", "1.2.3.4:", ":", "[::1]:x"]))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_lb_v1_encoders_byte_equal_on_seeded_inputs(pb, seed):
    """Every encoder writes the reference's bytes; protobuf reads them as
    the decoders of both packages do."""
    rng = random.Random(seed)
    name = "".join(rng.choice("abcxyz-._/é") for _ in range(rng.randrange(20)))
    addrs = _addresses(rng, rng.randrange(1, 12))
    interval = rng.choice([0.0, rng.random() * 5, rng.randrange(10)])
    stats = [rng.randrange(1 << rng.randrange(1, 40)) for _ in range(3)]
    pairs = [
        (port_lb_v1.encode_initial_request(name),
         ref_lb_v1.encode_initial_request(name)),
        (port_lb_v1.encode_server_list(addrs),
         ref_lb_v1.encode_server_list(addrs)),
        (port_lb_v1.encode_initial_response(interval),
         ref_lb_v1.encode_initial_response(interval)),
        (port_lb_v1.encode_client_stats(*stats),
         ref_lb_v1.encode_client_stats(*stats)),
    ]
    for got, want in pairs:
        assert got == want
    req = pb.LoadBalanceRequest.FromString(pairs[0][0])
    assert req.initial_request.name == name
    assert port_lb_v1.decode_request(pairs[0][0]) == name
    resp = pb.LoadBalanceResponse.FromString(pairs[1][0])
    listed = port_lb_v1.decode_response(pairs[1][0])
    assert listed == ref_lb_v1.decode_response(pairs[1][0])
    assert listed[0] == "server_list"
    assert len(listed[1]) == len(resp.server_list.servers)
    assert [s.port for s in resp.server_list.servers] == [
        int(a.rpartition(":")[2]) for a in listed[1]]
    cs = pb.LoadBalanceRequest.FromString(pairs[3][0]).client_stats
    assert [cs.num_calls_started, cs.num_calls_finished,
            cs.num_calls_finished_known_received] == stats
    assert port_lb_v1.decode_client_stats(pairs[3][0]) == dict(
        zip(("started", "finished", "known_received"), stats))


@pytest.mark.parametrize("interval", [2.25, 0.0, 0.3, 1.5e-9, 0.9999999999,
                                      7.0])
def test_lb_v1_stats_codec_against_real_protobuf(pb, interval):
    """The Duration-carrying initial_response (including the carry of a
    rounded-up nanosecond count) and ClientStats, judged by protobuf."""
    wire = port_lb_v1.encode_initial_response(interval)
    assert wire == ref_lb_v1.encode_initial_response(interval)
    resp = pb.LoadBalanceResponse.FromString(wire)
    dur = resp.initial_response.client_stats_report_interval
    assert 0 <= dur.nanos < 1_000_000_000
    assert abs(dur.seconds + dur.nanos / 1e9 - interval) < 1e-9
    kind, got = port_lb_v1.decode_response(resp.SerializeToString())
    assert kind == "initial"
    assert got == ref_lb_v1.decode_response(resp.SerializeToString())[1]
    req = pb.LoadBalanceRequest.FromString(
        port_lb_v1.encode_client_stats(10, 8, 7))
    cs = req.client_stats
    assert (cs.num_calls_started, cs.num_calls_finished,
            cs.num_calls_finished_known_received) == (10, 8, 7)
    assert port_lb_v1.decode_client_stats(req.SerializeToString()) == {
        "started": 10, "finished": 8, "known_received": 7}


@pytest.mark.parametrize("seed", range(4))
def test_lb_v1_decoders_agree_on_garbage(seed):
    """On seeded garbage both packages' decoders return the same or both
    raise ValueError (protowire's corruption contract)."""
    rng = random.Random(100 + seed)

    def outcome(fn, blob):
        try:
            return ("ok", fn(blob))
        except ValueError:
            return ("ValueError",)

    for _ in range(200):
        blob = bytes(rng.randrange(256) for _ in range(rng.randrange(48)))
        for name in ("decode_request", "decode_response",
                     "decode_client_stats"):
            assert outcome(getattr(port_lb_v1, name), blob) == outcome(
                getattr(ref_lb_v1, name), blob), (name, blob)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_stock_grpcio_client_subscribes_to_balancer(pb, pkg):
    """A stock grpcio client opens BalanceLoad against the balancer and
    receives initial_response, then a ServerList per change: what the
    port's balancer sends is what the reference's does."""
    import queue

    import grpc

    balancer, bal_srv, bal_port = _balancer(pkg, stats_interval_s=1.5)
    balancer.set_servers("inventory", ["10.1.2.3:50051"])
    seen = []
    try:
        ch = grpc.insecure_channel(f"127.0.0.1:{bal_port}")
        stream = ch.stream_stream(
            "/grpc.lb.v1.LoadBalancer/BalanceLoad",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=lambda b: b)
        hold = queue.Queue()

        def reqs():
            first = pb.LoadBalanceRequest()
            first.initial_request.name = "inventory"
            yield first
            hold.get(timeout=WAIT_S)  # hold the stream open

        try:
            resp_iter = stream(reqs(), timeout=WAIT_S)
            seen.append(next(resp_iter))
            seen.append(next(resp_iter))
            balancer.set_servers("inventory", ["10.9.9.9:1", "[::1]:2"])
            seen.append(next(resp_iter))
        finally:
            hold.put(None)
            ch.close()
    finally:
        bal_srv.stop(grace=0)
    first, sl, sl2 = (pb.LoadBalanceResponse.FromString(m) for m in seen)
    assert first.WhichOneof("load_balance_response_type") == \
        "initial_response"
    assert first.initial_response.client_stats_report_interval.seconds == 1
    assert [f"{s.ip_address.hex()}:{s.port}"
            for s in sl.server_list.servers] == ["0a010203:50051"]
    assert [s.port for s in sl2.server_list.servers] == [1, 2]
    assert seen == [ref_lb_v1.encode_initial_response(1.5),
                    ref_lb_v1.encode_server_list(["10.1.2.3:50051"]),
                    ref_lb_v1.encode_server_list(["10.9.9.9:1", "[::1]:2"])]


# -- device-ring backends behind a port balancer ------------------------------

def _wraps(landings: int, span: int, first: int = 0) -> int:
    """Landings of ``span`` bytes from absolute offset ``first`` that wrap
    the RING_KB ring (chip_smoke's ``_ring_wraps``)."""
    ring = RING_KB << 10
    return sum(1 for k in range(landings)
               if (first + k * span) % ring + span > ring)


@pytest.mark.parametrize("wire", ["tpurpc", "grpclb"])
def test_lookaside_onto_cpu_device_ring_backends(platform, counted_plain,
                                                 wire):
    """Phase 14 (a) on the CPU: two device-ring backends (``TPU``, 64 KiB
    rings) behind a port balancer, a port channel over both
    (``round_robin``) that the watcher moves. The balancer names A, then B;
    then it stops, and the channel falls back to both. Every reply equals
    the direct call's of the same request to the backend that served it;
    each backend ran the plain versions as its rings' offsets say; each
    leg's ledger delta is the direct calls' on a fresh connection (but for
    the number of pieces the transport copies its bytes in); every ring
    comes back whole. The load report is off: its p99 (the servers'
    watchdog's) changes digits between legs, and the trailers with it."""
    platform("TPU", TPURPC_HBM_RING_SIZE_KB=str(RING_KB),
             TPURPC_LOAD_REPORTS="0")
    classify = small_classify()
    rng = np.random.default_rng(31)
    xs = [rng.standard_normal(DR_SHAPE).astype(np.float32)
          for _ in range(DR_REQUESTS)]
    span = xs[0].nbytes
    rigs = {"a": CallPlaneServer(classify, max_workers=4),
            "b": CallPlaneServer(classify, max_workers=4)}
    addr = {k: ("127.0.0.1", r.port) for k, r in rigs.items()}
    balancer, bal_srv, bal_port = _balancer("port")

    def served(k):
        return len(rigs[k].done)

    def leg(ch, n):
        """n sequential calls: replies, the server of each, plain
        versions run at each server, the ledger delta."""
        client = TensorClient(ch)
        before = {k: dict(r.launched) for k, r in rigs.items()}
        out, by = [], []
        with ledger.track() as w:
            for i in range(n):
                done = {k: served(k) for k in rigs}
                out.append(client.call("Classify",
                                       {"images": torch.from_numpy(xs[i])},
                                       timeout=WAIT_S))
                by.append([k for k in rigs if served(k) > done[k]])
        ran = {k: {n_: r.launched[n_] - before[k][n_] for n_ in r.launched}
               for k, r in rigs.items()}
        return out, by, ran, dict(w.delta)

    try:
        direct = {}
        for k, rig in rigs.items():
            with trpc.insecure_channel(f"127.0.0.1:{rig.port}") as ch:
                direct[k] = leg(ch, DR_REQUESTS)
        balancer.set_servers("dr", ["127.0.0.1:%d" % addr["a"][1]])
        target = "ipv4:" + ",".join(f"{h}:{p}" for h, p in addr.values())
        with trpc.Channel(target, lb_policy="round_robin") as ch:
            watcher = trpc.enable_lookaside(ch, f"127.0.0.1:{bal_port}", "dr",
                                            wire=wire)
            try:
                assert _await(lambda: ch._addrs == [addr["a"]])
                on_a = leg(ch, DR_REQUESTS)
                balancer.set_servers("dr", ["127.0.0.1:%d" % addr["b"][1]])
                assert _await(lambda: ch._addrs == [addr["b"]])
                on_b = leg(ch, DR_REQUESTS)
                bal_srv.stop(grace=0)
                assert _await(lambda: ch._addrs == [addr["a"], addr["b"]])
                fell_back = leg(ch, DR_REQUESTS)
            finally:
                watcher.stop()
            stats = {k: [c.endpoint.device_ring.stats()
                         for c in list(r.server._connections)
                         if c.endpoint.device_ring is not None]
                     for k, r in rigs.items()}
    finally:
        bal_srv.stop(grace=0)
        for r in rigs.values():
            r.server.stop()
    assert on_a[1] == [["a"]] * DR_REQUESTS
    assert on_b[1] == [["b"]] * DR_REQUESTS
    assert sorted(k for (k,) in fell_back[1]) == (
        ["a"] * (DR_REQUESTS // 2) + ["b"] * (DR_REQUESTS // 2))
    for out, by in ((on_a[0], on_a[1]), (on_b[0], on_b[1]),
                    (fell_back[0], fell_back[1])):
        for i, (got, (k,)) in enumerate(zip(out, by)):
            want = direct[k][0][i]
            assert torch.equal(got["logits"], want["logits"])
            assert torch.equal(got["top1"], want["top1"])
    one = {"ring_scatter": _wraps(DR_REQUESTS, span),
           "ring_window": _wraps(DR_REQUESTS, span)}
    assert one["ring_scatter"] == 1
    for k in rigs:
        assert direct[k][2][k] == one
    assert on_a[2] == {"a": one, "b": {"ring_scatter": 0, "ring_window": 0}}
    assert on_b[2] == {"a": {"ring_scatter": 0, "ring_window": 0}, "b": one}
    # the fallback: A on a fresh connection (its ring from 0), B on the
    # kept one (its ring from DR_REQUESTS spans on)
    half = DR_REQUESTS // 2
    assert fell_back[2] == {
        "a": {n: _wraps(half, span) for n in one},
        "b": {n: _wraps(half, span, DR_REQUESTS * span) for n in one}}
    assert counted_plain["ring_scatter"] == sum(
        r.launched["ring_scatter"] for r in rigs.values())
    for got, want in ((on_a[3], direct["a"][3]), (on_b[3], direct["b"][3])):
        got.pop("host_copy_ops"), want.pop("host_copy_ops")
        assert got == want
    for k, rings in stats.items():
        assert rings, k
        for st in rings:
            assert st["writable"] == st["capacity"] and not st["live_spans"]
