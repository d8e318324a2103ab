"""xDS in the port (``tpurpc_torch.rpc.xds``, ``xds_v3``), against the
reference.

Twins of ``tests/test_xds.py``'s eight cases. Wherever a case crosses the
wire it runs on every client/server package pair that has the port in it:
a port channel (its ``xds`` resolver, ``xds_channel`` and watcher) against
the reference's control plane and backends, a reference channel against
the port's, and the port against itself. The v3 ADS codec must write the
reference's bytes on seeded inputs, read what protobuf writes, and meet the
same seeded garbage as the reference's does; bootstrap parsing must give
the same outcome in both packages on each environment; and the port's
``xds`` scheme sits in the port's resolver registry only.

Rules these tests keep, so that they leave nothing behind for the next
test in the same worker: protobuf message classes come from a private
``DescriptorPool`` fed by ``protoc --include_imports
--descriptor_set_out``, never from the default pool (the reference's test
compiles ``envoy_subset.proto`` into that one). ``GRPC_XDS_BOOTSTRAP`` and
``GRPC_XDS_BOOTSTRAP_CONFIG`` are set only through ``monkeypatch``, and the
one a test does not use is deleted. Every watcher is stopped in a
``finally`` before its control plane; every server is stopped and every
channel closed; every wait has its own timeout; ports are ephemeral. The
``xds`` scheme is registered by importing each package's module and is
never registered or removed by hand. A wait for a resubscribed push allows
the push loop's 1.0 s wait and a margin (ROADMAP C).
"""

import json
import random
import shutil
import subprocess
import textwrap
import time
import types

import pytest

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from tpurpc.rpc import resolver as ref_resolver
from tpurpc.rpc import status as ref_status
from tpurpc.rpc import xds as ref_xds
from tpurpc.rpc import xds_v3 as ref_xds_v3
from tpurpc.wire.protowire import encode_varint, ld, vf
from tpurpc_torch.rpc import resolver as port_resolver
from tpurpc_torch.rpc import status as port_status
from tpurpc_torch.rpc import xds as port_xds
from tpurpc_torch.rpc import xds_v3 as port_xds_v3

PKG = {"ref": types.SimpleNamespace(rpc=jrpc, xds=ref_xds, v3=ref_xds_v3,
                                    status=ref_status),
       "port": types.SimpleNamespace(rpc=trpc, xds=port_xds, v3=port_xds_v3,
                                     status=port_status)}
#: (client, server): the client's channel, resolver and watcher, the
#: server's control plane and backends
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]
PAIR_IDS = [f"{c}-to-{s}" for c, s in PAIRS]
RPC_ERRORS = (ref_status.RpcError, port_status.RpcError)
BOOT_VARS = ("GRPC_XDS_BOOTSTRAP", "GRPC_XDS_BOOTSTRAP_CONFIG")
#: every wait on a call or a push; a resubscribed push comes after the
#: control plane's 1.0 s wait at most, well inside it
WAIT_S = 15


def _echo_server(pkg: str, tag: bytes):
    rpc = PKG[pkg].rpc
    srv = rpc.Server(max_workers=2)
    srv.add_method("/x.S/Who",
                   rpc.unary_unary_rpc_method_handler(lambda r, c: tag))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _control_plane(pkg: str):
    xds = PKG[pkg].xds.XdsServicer()
    srv = PKG[pkg].rpc.Server(max_workers=4)
    xds.attach(srv)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return xds, srv, port


def _bootstrap(monkeypatch, cport: int, **server):
    monkeypatch.setenv("GRPC_XDS_BOOTSTRAP_CONFIG", json.dumps(
        {"xds_servers": [{"server_uri": f"127.0.0.1:{cport}", **server}],
         "node": {"id": "test-node"}}))
    monkeypatch.delenv("GRPC_XDS_BOOTSTRAP", raising=False)


def _until(who, want: bytes) -> bytes:
    """Call until ``want`` answers (a call racing the membership swap may
    land on the closing backend once and fail UNAVAILABLE)."""
    deadline = time.monotonic() + WAIT_S
    seen = b""
    while time.monotonic() < deadline:
        try:
            seen = bytes(who(b"", timeout=WAIT_S))
        except RPC_ERRORS as exc:
            if exc.code().name != "UNAVAILABLE":
                raise
        if seen == want:
            break
        time.sleep(0.05)
    return seen


# -- bootstrap ---------------------------------------------------------------

def test_bootstrap_parsing(monkeypatch, tmp_path):
    """The reference's sequence, on the port's ``load_bootstrap``."""
    for var in BOOT_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError):
        port_xds.load_bootstrap()  # no bootstrap configured: loud
    monkeypatch.setenv("GRPC_XDS_BOOTSTRAP_CONFIG",
                       json.dumps({"xds_servers": []}))
    with pytest.raises(RuntimeError):
        port_xds.load_bootstrap()  # malformed: needs server_uri
    monkeypatch.setenv("GRPC_XDS_BOOTSTRAP_CONFIG", json.dumps(
        {"xds_servers": [{"server_uri": "inline:1"}]}))
    assert port_xds.load_bootstrap()["xds_servers"][0]["server_uri"] == \
        "inline:1"
    bs = tmp_path / "bootstrap.json"
    bs.write_text(json.dumps({"xds_servers": [{"server_uri": "file:2"}],
                              "node": {"id": "n1"}}))
    monkeypatch.setenv("GRPC_XDS_BOOTSTRAP", str(bs))
    cfg = port_xds.load_bootstrap()
    assert cfg["xds_servers"][0]["server_uri"] == "file:2"
    assert cfg["node"]["id"] == "n1"


GOOD = {"xds_servers": [{"server_uri": "cp:1", "server_features":
                         ["ads_lite"]}], "node": {"id": "n", "cluster": "c"}}
#: (GRPC_XDS_BOOTSTRAP's file content or None for unset, "" for set empty,
#: "missing" for a path that does not exist; GRPC_XDS_BOOTSTRAP_CONFIG)
BOOT_CASES = {
    "none": (None, None),
    "inline_good": (None, json.dumps(GOOD)),
    "inline_no_servers": (None, json.dumps({"xds_servers": []})),
    "inline_no_uri": (None, json.dumps({"xds_servers": [{"x": 1}]})),
    "inline_not_json": (None, "{xds_servers"),
    "inline_empty": (None, ""),
    "file_wins": (json.dumps({"xds_servers": [{"server_uri": "f:2"}]}),
                  json.dumps(GOOD)),
    "file_empty": ("", json.dumps(GOOD)),
    "file_missing": ("missing", json.dumps(GOOD)),
    "file_not_json": ("[1, 2", None),
    "file_servers_null": (json.dumps({"xds_servers": None}), None),
}


@pytest.mark.parametrize("case", sorted(BOOT_CASES))
def test_bootstrap_outcome_alike(monkeypatch, tmp_path, case):
    """Each environment gives the same bootstrap, or the same exception
    type, in both packages, and the same wire choice."""
    file_text, inline = BOOT_CASES[case]
    for var in BOOT_VARS:
        monkeypatch.delenv(var, raising=False)
    if file_text == "missing":
        monkeypatch.setenv("GRPC_XDS_BOOTSTRAP", str(tmp_path / "absent"))
    elif file_text is not None:
        path = tmp_path / "bootstrap.json"
        path.write_text(file_text)
        monkeypatch.setenv("GRPC_XDS_BOOTSTRAP",
                           str(path) if file_text else "")
    if inline is not None:
        monkeypatch.setenv("GRPC_XDS_BOOTSTRAP_CONFIG", inline)

    def outcome(xds):
        try:
            cfg = xds.load_bootstrap()
        except Exception as exc:  # the type is the observation
            return ("error", type(exc).__name__)
        return ("ok", cfg, xds._use_ads_lite(cfg), xds._server_uri(cfg))

    assert outcome(port_xds) == outcome(ref_xds)


# -- the resolver and the watcher --------------------------------------------

def test_xds_scheme_is_in_the_port_registry_only(monkeypatch):
    """Importing the port's module puts its resolver in the port's
    registry; the reference's ``xds`` entry, if any, is the reference's."""
    assert port_resolver._RESOLVERS["xds"] is port_xds._resolve_xds
    assert ref_resolver._RESOLVERS.get("xds") is not port_xds._resolve_xds
    assert ref_resolver._RESOLVERS.get("xds") in (None, ref_xds._resolve_xds)
    for var in BOOT_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="bootstrap"):
        port_resolver.resolve_target("xds:///svc")  # through the port's


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_xds_target_resolves_via_control_plane(monkeypatch, client, server):
    """``Channel("xds:///svc")`` works as grpcio's does: the bootstrap names
    the control plane, the resolver fetches the current assignment."""
    backend, bport = _echo_server(server, b"b1")
    xds, cp, cport = _control_plane(server)
    try:
        xds.set_endpoints("svc", [f"127.0.0.1:{bport}"])
        _bootstrap(monkeypatch, cport)
        with PKG[client].rpc.Channel("xds:///svc") as ch:
            assert ch.unary_unary("/x.S/Who")(b"", timeout=WAIT_S) == b"b1"
        # an empty assignment: a loud resolution failure, not a hang
        with pytest.raises(ValueError, match="empty"):
            PKG[client].rpc.Channel("xds:///nonexistent-svc")
    finally:
        cp.stop(grace=0)
        backend.stop(grace=0)


def _moves_on_eds_update(monkeypatch, client, server, **features):
    b1, p1 = _echo_server(server, b"b1")
    b2, p2 = _echo_server(server, b"b2")
    xds, cp, cport = _control_plane(server)
    _bootstrap(monkeypatch, cport, **features)
    try:
        xds.set_endpoints("svc", [f"127.0.0.1:{p1}"])
        ch, watcher = PKG[client].xds.xds_channel("xds:///svc")
        try:
            who = ch.unary_unary("/x.S/Who")
            assert who(b"", timeout=WAIT_S) == b"b1"
            # a hostname on purpose: the watcher normalizes it as the
            # channel's keep-live matching does
            xds.set_endpoints("svc", [f"localhost:{p2}"])
            assert _until(who, b"b2") == b"b2", "EDS update never moved it"
            assert watcher.applied_versions, "watcher applied no update"
        finally:
            watcher.stop()
            ch.close()
    finally:
        cp.stop(grace=0)
        b1.stop(grace=0)
        b2.stop(grace=0)


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_xds_watcher_moves_traffic_on_eds_update(monkeypatch, client,
                                                 server):
    """The EDS update re-points a live channel over the v3 ADS wire."""
    _moves_on_eds_update(monkeypatch, client, server)


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_ads_lite_watcher_moves_traffic_on_eds_update(monkeypatch, client,
                                                      server):
    """The same over the legacy JSON wire (``server_features:
    ["ads_lite"]``)."""
    _moves_on_eds_update(monkeypatch, client, server,
                         server_features=["ads_lite"])


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_ads_lite_feature_flag_selects_legacy_wire(monkeypatch, client,
                                                   server):
    backend, bport = _echo_server(server, b"lite")
    xds, cp, cport = _control_plane(server)
    try:
        xds.set_endpoints("svc", [f"127.0.0.1:{bport}"])
        _bootstrap(monkeypatch, cport, server_features=["ads_lite"])
        with PKG[client].rpc.Channel("xds:///svc") as ch:
            assert ch.unary_unary("/x.S/Who")(b"", timeout=WAIT_S) == b"lite"
    finally:
        cp.stop(grace=0)
        backend.stop(grace=0)


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_xds_watcher_keeps_last_assignment_on_control_plane_loss(
        monkeypatch, client, server):
    """The control plane's death churns no working assignment: calls keep
    going to the last applied endpoints."""
    b1, p1 = _echo_server(server, b"b1")
    xds, cp, cport = _control_plane(server)
    _bootstrap(monkeypatch, cport)
    try:
        xds.set_endpoints("svc", [f"127.0.0.1:{p1}"])
        ch, watcher = PKG[client].xds.xds_channel("xds:///svc")
        try:
            who = ch.unary_unary("/x.S/Who")
            assert who(b"", timeout=WAIT_S) == b"b1"
            before = list(ch._addrs)
            cp.stop(grace=0)  # the control plane goes away
            time.sleep(0.5)
            for _ in range(5):
                assert who(b"", timeout=WAIT_S) == b"b1"
            assert ch._addrs == before
        finally:
            watcher.stop()
            ch.close()
    finally:
        cp.stop(grace=0)
        b1.stop(grace=0)


# -- the v3 ADS stream --------------------------------------------------------

class _RawAds:
    """A raw v3 ADS stream from ``client``'s channel: requests go in with
    ``send``, decoded responses come out of ``next``."""

    def __init__(self, client: str, cport: int):
        import queue

        self._v3 = PKG[client].v3
        self._q = queue.Queue()
        self._done = False
        self.ch = PKG[client].rpc.Channel(f"127.0.0.1:{cport}")

        def reqs():
            while not self._done:
                try:
                    yield self._q.get(timeout=0.2)
                except queue.Empty:
                    continue

        self.call = self.ch.stream_stream(self._v3.METHOD)(reqs(),
                                                            timeout=WAIT_S)
        self._it = iter(self.call)

    def send(self, names, **kw):
        self._q.put(self._v3.encode_discovery_request(names, **kw))

    def next(self) -> dict:
        return self._v3.decode_discovery_response(bytes(next(self._it)))

    def close(self):
        self._done = True
        try:
            self.call.cancel()
        finally:
            self.ch.close()


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_assignment_arrives_over_real_ads_stream(client, server):
    """The assignment arrives over StreamAggregatedResources driven with
    hand-encoded DiscoveryRequests, then an ACK and a pushed update on the
    same stream."""
    xds, cp, cport = _control_plane(server)
    raw = None
    try:
        xds.set_endpoints("clu", ["10.1.1.1:443"])
        raw = _RawAds(client, cport)
        raw.send(["clu"], node_id="raw-client")
        first = raw.next()
        assert first["assignments"]["clu"] == ["10.1.1.1:443"]
        assert first["type_url"] == port_xds_v3.CLA_TYPE_URL
        assert first["nonce"]
        raw.send(["clu"], version_info=first["version_info"],
                 response_nonce=first["nonce"], node_id="raw-client")
        xds.set_endpoints("clu", ["10.1.1.2:444"])
        second = raw.next()
        assert second["assignments"]["clu"] == ["10.1.1.2:444"]
        assert second["nonce"] != first["nonce"]
    finally:
        if raw is not None:
            raw.close()
        cp.stop(grace=0)


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_resubscription_is_pushed_on_the_same_stream(client, server):
    """A DiscoveryRequest naming other resources re-arms the push loop:
    the new subscription's assignment comes on the same stream, once the
    loop's 1.0 s wait runs out (a fault of both packages, ROADMAP C)."""
    xds, cp, cport = _control_plane(server)
    raw = None
    try:
        xds.set_endpoints("a", ["10.0.0.1:1"])
        xds.set_endpoints("b", ["10.0.0.2:2", "[::1]:3"])
        raw = _RawAds(client, cport)
        raw.send(["a"])
        first = raw.next()
        assert first["assignments"] == {"a": ["10.0.0.1:1"]}
        t0 = time.monotonic()
        raw.send(["a", "b"], version_info=first["version_info"],
                 response_nonce=first["nonce"])
        second = raw.next()
        took = time.monotonic() - t0
        assert second["assignments"] == {"a": ["10.0.0.1:1"],
                                         "b": ["10.0.0.2:2", "[::1]:3"]}
        assert took < 1.0 + 5.0
    finally:
        if raw is not None:
            raw.close()
        cp.stop(grace=0)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_ads_v3_refuses_another_type(pkg):
    """A subscription to another resource type is refused UNIMPLEMENTED by
    both packages' control planes."""
    xds, cp, cport = _control_plane(pkg)
    raw = None
    try:
        raw = _RawAds("port", cport)
        raw.send(["l"], type_url="type.googleapis.com/envoy.Listener")
        with pytest.raises(port_status.RpcError) as info:
            raw.next()
        assert info.value.code().name == "UNIMPLEMENTED"
    finally:
        if raw is not None:
            raw.close()
        cp.stop(grace=0)


# -- the v3 codec -------------------------------------------------------------

ENVOY_SUBSET_PROTO = textwrap.dedent("""\
    syntax = "proto3";
    package torchenvoy;
    import "google/protobuf/any.proto";
    message Node { string id = 1; string cluster = 2;
                   string user_agent_name = 6; }
    message DiscoveryRequest {
      string version_info = 1; Node node = 2;
      repeated string resource_names = 3;
      string type_url = 4; string response_nonce = 5; }
    message DiscoveryResponse {
      string version_info = 1; repeated google.protobuf.Any resources = 2;
      string type_url = 4; string nonce = 5; }
    message SocketAddress { string address = 2; uint32 port_value = 3; }
    message Address { SocketAddress socket_address = 1; }
    message Endpoint { Address address = 1; }
    message LbEndpoint { Endpoint endpoint = 1; int32 health_status = 2; }
    message LocalityLbEndpoints { repeated LbEndpoint lb_endpoints = 2;
                                  uint32 priority = 5; }
    message ClusterLoadAssignment {
      string cluster_name = 1;
      repeated LocalityLbEndpoints endpoints = 2; }
    """)


@pytest.fixture(scope="module")
def pb(tmp_path_factory):
    """The envoy v3 subset's classes from a private DescriptorPool;
    nothing enters protobuf's default pool."""
    if shutil.which("protoc") is None:
        pytest.skip("protoc is not installed")
    from google.protobuf import descriptor_pb2, descriptor_pool
    from google.protobuf import message_factory

    out = tmp_path_factory.mktemp("torch_xds_v3")
    (out / "torch_envoy_subset.proto").write_text(ENVOY_SUBSET_PROTO)
    desc = out / "set.pb"
    subprocess.run(["protoc", f"-I{out}", "--include_imports",
                    f"--descriptor_set_out={desc}",
                    str(out / "torch_envoy_subset.proto")],
                   check=True, timeout=120)
    pool = descriptor_pool.DescriptorPool()
    for fd in descriptor_pb2.FileDescriptorSet.FromString(
            desc.read_bytes()).file:
        pool.Add(fd)
    return types.SimpleNamespace(**{
        name: message_factory.GetMessageClass(
            pool.FindMessageTypeByName(f"torchenvoy.{name}"))
        for name in ("DiscoveryRequest", "DiscoveryResponse",
                     "ClusterLoadAssignment")})


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_ads_v3_codec_against_real_protobuf(pb, pkg):
    xds_v3 = PKG[pkg].v3
    req = pb.DiscoveryRequest.FromString(xds_v3.encode_discovery_request(
        ["cluster-a"], version_info="7", response_nonce="n3",
        node_id="node-1", node_cluster="prod"))
    assert req.version_info == "7"
    assert list(req.resource_names) == ["cluster-a"]
    assert req.type_url == xds_v3.CLA_TYPE_URL
    assert req.response_nonce == "n3"
    assert req.node.id == "node-1" and req.node.cluster == "prod"
    resp = pb.DiscoveryResponse.FromString(xds_v3.encode_discovery_response(
        [("cluster-a", ["10.0.0.1:443", "[::1]:8080"])],
        version_info="9", nonce="n9"))
    assert resp.version_info == "9" and resp.nonce == "n9"
    assert resp.resources[0].type_url == xds_v3.CLA_TYPE_URL
    cla = pb.ClusterLoadAssignment.FromString(resp.resources[0].value)
    assert cla.cluster_name == "cluster-a"
    eps = cla.endpoints[0].lb_endpoints
    sock0 = eps[0].endpoint.address.socket_address
    assert (sock0.address, sock0.port_value) == ("10.0.0.1", 443)
    # protobuf's encodes through our decoder: localities by priority, an
    # unhealthy endpoint left out
    cla2 = pb.ClusterLoadAssignment(cluster_name="c2")
    lo_hi = cla2.endpoints.add(priority=1)
    lo_hi.lb_endpoints.add().endpoint.address.socket_address.address = "b"
    lo_hi.lb_endpoints[0].endpoint.address.socket_address.port_value = 2
    lo0 = cla2.endpoints.add()
    lo0.lb_endpoints.add().endpoint.address.socket_address.address = "a"
    lo0.lb_endpoints[0].endpoint.address.socket_address.port_value = 1
    sick = lo0.lb_endpoints.add(health_status=3)
    sick.endpoint.address.socket_address.address = "dead"
    sick.endpoint.address.socket_address.port_value = 9
    resp2 = pb.DiscoveryResponse(version_info="1", nonce="x",
                                 type_url=xds_v3.CLA_TYPE_URL)
    any_res = resp2.resources.add()
    any_res.type_url = xds_v3.CLA_TYPE_URL
    any_res.value = cla2.SerializeToString()
    out = xds_v3.decode_discovery_response(resp2.SerializeToString())
    assert out["version_info"] == "1" and out["nonce"] == "x"
    assert out["assignments"] == {"c2": ["a:1", "b:2"]}
    sub = pb.DiscoveryRequest(type_url=xds_v3.CLA_TYPE_URL,
                              resource_names=["c3"], response_nonce="n")
    got = xds_v3.decode_discovery_request(sub.SerializeToString())
    assert got["resource_names"] == ["c3"] and got["response_nonce"] == "n"


def _endpoints(rng: random.Random, n: int) -> list:
    out = []
    for _ in range(n):
        kind = rng.randrange(5)
        port = rng.randrange(0, 65536)
        if kind == 0:
            out.append(".".join(str(rng.randrange(256)) for _ in range(4))
                       + f":{port}")
        elif kind == 1:
            out.append(f"[fe80::{rng.randrange(65536):x}]:{port}")
        elif kind == 2:
            out.append(f"svc-{rng.randrange(50)}.local:{port}")
        elif kind == 3:
            out.append(f"h{rng.randrange(9)}:{port}")
        else:
            out.append(rng.choice(["noport", "h:", ":5", "h:x", ""]))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_xds_v3_encoders_byte_equal_on_seeded_inputs(pb, seed):
    """Every encoder writes the reference's bytes; protobuf and both
    decoders read them alike."""
    rng = random.Random(seed)

    def word(k=12):
        return "".join(rng.choice("abz09-._é") for _ in range(rng.randrange(k)))

    names = [word() for _ in range(rng.randrange(4))]
    kw = dict(version_info=word(), response_nonce=word(), node_id=word(),
              node_cluster=word())
    clusters = [(word() or "c", _endpoints(rng, rng.randrange(6)))
                for _ in range(rng.randrange(1, 4))]
    prio = rng.randrange(4)
    for fn, args, kwargs in (
            ("encode_discovery_request", (names,), kw),
            ("encode_cluster_load_assignment", clusters[0], {"priority":
                                                             prio}),
            ("encode_discovery_response", (clusters,),
             {"version_info": kw["version_info"],
              "nonce": kw["response_nonce"]})):
        got = getattr(port_xds_v3, fn)(*args, **kwargs)
        assert got == getattr(ref_xds_v3, fn)(*args, **kwargs), fn
    req = port_xds_v3.encode_discovery_request(names, **kw)
    msg = pb.DiscoveryRequest.FromString(req)
    assert list(msg.resource_names) == names
    assert msg.node.id == kw["node_id"] and msg.node.user_agent_name == \
        "tpurpc"
    assert port_xds_v3.decode_discovery_request(req) == \
        ref_xds_v3.decode_discovery_request(req)
    resp = port_xds_v3.encode_discovery_response(
        clusters, version_info="1", nonce="2")
    decoded = port_xds_v3.decode_discovery_response(resp)
    assert decoded == ref_xds_v3.decode_discovery_response(resp)
    parsed = pb.DiscoveryResponse.FromString(resp)
    assert len(parsed.resources) == len(clusters)
    for res, (name, _eps) in zip(parsed.resources, clusters):
        cla = pb.ClusterLoadAssignment.FromString(res.value)
        assert cla.cluster_name == name
        socks = [e.endpoint.address.socket_address
                 for e in cla.endpoints[0].lb_endpoints]
        want = [f"[{s.address}]:{s.port_value}" if ":" in s.address
                else f"{s.address}:{s.port_value}" for s in socks]
        assert port_xds_v3.decode_cluster_load_assignment(res.value) == (
            name, want)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_ads_v3_decoder_robust_to_garbage(seed):
    """On seeded garbage both packages' decoders return the same or both
    raise ValueError; unknown fields (a multi-byte tag included) and
    foreign Any types are skipped."""
    rng = random.Random(seed)

    def outcome(fn, blob):
        try:
            return ("ok", fn(blob))
        except ValueError:
            return ("ValueError",)

    for _ in range(200):
        blob = bytes(rng.randrange(256) for _ in range(rng.randrange(64)))
        for name in ("decode_discovery_response", "decode_discovery_request",
                     "decode_cluster_load_assignment"):
            assert outcome(getattr(port_xds_v3, name), blob) == outcome(
                getattr(ref_xds_v3, name), blob), (name, blob)
    big_tag_field = encode_varint((1000 << 3) | 0) + encode_varint(5)
    body = (ld(1, b"v9") + vf(29, 7) + ld(30, b"future-field")
            + big_tag_field
            + ld(5, b"n1") + ld(4, port_xds_v3.CLA_TYPE_URL.encode()))
    out = port_xds_v3.decode_discovery_response(body)
    assert out["version_info"] == "v9" and out["nonce"] == "n1"
    foreign = ld(2, ld(1, b"type.googleapis.com/envoy.Listener") + ld(2, b"x"))
    out = port_xds_v3.decode_discovery_response(foreign + ld(5, b"n2"))
    assert out["assignments"] == {} and out["nonce"] == "n2"
