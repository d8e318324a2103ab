"""channelz on both packages: the call counters, the JSON snapshot and the
grpc.channelz.v1 wire service.

Mirrors ``tests/test_channelz.py`` and ``tests/test_channelz_v1.py``: each
scenario runs against the reference's server and the port's, driven by a
stock grpcio client (hand-decoded protos, as grpcdebug sends them) or by
either package's channel (every client/server package pair), and the
observations are compared. Each package keeps its own process-wide
registry, so ids differ between them; counts and shapes must not.
"""

import itertools
import json
import threading
import time

import grpc
import pytest

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from tpurpc.rpc import channelz as ref_cz
from tpurpc.rpc import channelz_v1 as ref_v1
from tpurpc_torch.rpc import channelz as port_cz
from tpurpc_torch.rpc import channelz_v1 as port_v1
from tpurpc_torch.wire.protowire import fields, vf

PKGS = {"ref": jrpc, "port": trpc}
CZ = {"ref": ref_cz, "port": port_cz}
V1 = {"ref": ref_v1, "port": port_v1}
PAIRS = [("ref", "ref"), ("port", "port"), ("ref", "port"), ("port", "ref")]
PAIR_IDS = [f"{c}-to-{s}" for c, s in PAIRS]
SERVICE = port_v1.SERVICE
_ID = lambda b: b  # noqa: E731
#: numbers for the method that names one test's server in a snapshot: a
#: stopped server of an earlier test can stay listed on a port the OS has
#: since handed to this one
_MARKS = itertools.count(1)


def _submsgs(raw, field_no):
    return [bytes(v) for f, _w, v in fields(bytes(raw)) if f == field_no]


def _field(raw, field_no, default=None):
    for f, _w, v in fields(bytes(raw)):
        if f == field_no:
            return v
    return default


def _poll(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _server(name, methods, v1=False, json_service=False):
    pkg = PKGS[name]
    srv = pkg.Server(max_workers=4)
    for path, fn in methods.items():
        srv.add_method(path, pkg.unary_unary_rpc_method_handler(fn))
    if v1:
        V1[name].enable_channelz(srv)
    if json_service:
        CZ[name].add_channelz_service(srv)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _bad(req, ctx):
    ctx.abort(ctx_code(ctx), "x")


def ctx_code(ctx):
    # the handler's own package's INTERNAL
    mod = jrpc if type(ctx).__module__.startswith("tpurpc.") else trpc
    return mod.StatusCode.INTERNAL


def _counters(cli, srv_name):
    """Two OK calls, one aborted, then the JSON snapshot over RPC. The
    snapshot's entry for this server is the one on its port that also
    serves a method no other server has."""
    mark = f"/t.S/Mark{next(_MARKS)}"
    srv, port = _server(srv_name, {"/t.S/Ok": lambda r, c: r,
                                   "/t.S/Bad": _bad, mark: lambda r, c: r},
                        json_service=True)
    try:
        with PKGS[cli].Channel(f"127.0.0.1:{port}") as ch:
            ch.unary_unary("/t.S/Ok")(b"1", timeout=10)
            ch.unary_unary("/t.S/Ok")(b"2", timeout=10)
            with pytest.raises((jrpc.RpcError, trpc.RpcError)):
                ch.unary_unary("/t.S/Bad")(b"3", timeout=10)
            raw = ch.unary_unary("/tpurpc.Channelz/Get")(b"", timeout=10)
            cz = CZ[srv_name]
            # counters settle once the trailers are on the wire
            _poll(lambda: cz.server_info(srv)["calls_succeeded"] >= 3)
            info = cz.server_info(srv)
            chan = CZ[cli].channel_info(ch)
            counters = ch.call_counters.as_dict()
        remote = json.loads(bytes(raw).decode())
        mine = [s for s in remote["servers"]
                if port in s["ports"] and mark in s["methods"]]
        return {"started": info["calls_started"],
                "succeeded": info["calls_succeeded"],
                "failed": info["calls_failed"],
                "methods": [m for m in info["methods"] if m != mark],
                "ports": info["ports"],
                "channel": {k: chan[k] for k in ("subchannels", "connected",
                                                 "lb_policy", "closed")},
                "channel_counters": (counters["calls_started"],
                                     counters["calls_succeeded"],
                                     counters["calls_failed"]),
                "remote_methods": ([m for m in mine[0]["methods"] if m != mark]
                                   if len(mine) == 1 else mine)}
    finally:
        srv.stop(grace=0)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_counters_and_snapshot(pair):
    want = _counters("ref", "ref")
    got = _counters(*pair)
    # the JSON method itself is a call: 4 started, 3 ok, 1 failed
    assert got["started"] == want["started"] == 4
    assert got == {**want, "ports": got["ports"]}
    assert (want["succeeded"], want["failed"]) == (3, 1)
    assert want["channel"] == {"subchannels": 1, "connected": 1,
                               "lb_policy": "pick_first", "closed": False}
    assert want["channel_counters"] == (4, 3, 1)
    assert "/t.S/Ok" in want["remote_methods"]


def _management(cli, srv_name):
    release = threading.Event()

    def slow(req, ctx):
        release.wait(timeout=20)
        return b"ok"

    srv, port = _server(srv_name, {"/z.S/Slow": slow})
    try:
        with PKGS[cli].Channel(f"127.0.0.1:{port}") as ch:
            t = threading.Thread(
                target=lambda: ch.unary_unary("/z.S/Slow")(b"", timeout=30))
            t.start()
            _poll(lambda: (CZ[srv_name].server_info(srv)["active_streams"]
                           >= 1 and CZ[cli].channel_info(ch)["active_streams"]
                           >= 1), timeout=10)
            sinfo = CZ[srv_name].server_info(srv)
            cinfo = CZ[cli].channel_info(ch)
            release.set()
            t.join(timeout=10)
            after = _poll(lambda: CZ[srv_name].server_info(
                srv)["active_streams"] == 0)
        return (sinfo["active_streams"], cinfo["active_streams"],
                sinfo["draining_connections"], sinfo["connections"], after)
    finally:
        release.set()
        srv.stop(grace=0)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_channelz_exposes_connection_management_state(pair):
    want = _management("ref", "ref")
    assert _management(*pair) == want
    assert want == (1, 1, 0, 1, True)


@pytest.fixture
def served():
    """``served(name)``: a started server of that package with Echo and
    grpc.channelz.v1."""
    made = []

    def make(name):
        made.append(_server(name, {"/z.S/Echo": lambda r, c: bytes(r)},
                            v1=True))
        return made[-1]
    yield make
    for srv, _ in made:
        srv.stop(grace=0)


def _get_servers(srv_name, served):
    srv, port = served(srv_name)
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        resp = ch.unary_unary(f"/{SERVICE}/GetServers", _ID, _ID)(b"")
    found = []
    for s in _submsgs(resp, 1):
        ref = _field(s, 1)
        assert ref is not None and _field(ref, 1, 0) > 0
        if _field(ref, 1, 0) != srv._channelz_id:
            continue  # another server (a stale one may share the port)
        for sock in _submsgs(s, 3):
            if _field(sock, 2) == f"listen:{port}".encode():
                found.append(_field(sock, 1, 0) > 0)
    return _field(resp, 2), found


@pytest.mark.parametrize("server", ["ref", "port"])
def test_get_servers_stock_grpcio(served, server):
    want = _get_servers("ref", served)
    assert _get_servers(server, served) == want
    assert want == (1, [True])  # end = true; our listen socket, an id > 0


def _channel_counters(cli, srv_name, served):
    _, port = served(srv_name)
    with PKGS[cli].insecure_channel(f"127.0.0.1:{port}") as tch:
        echo = tch.unary_unary("/z.S/Echo")
        replies = [bytes(echo(b"x", timeout=10)) for _ in range(3)]
        cid = tch._channelz_id
        # the channel is in its own package's registry: ask a server of
        # the client's package for it
        _, own = served(cli)
        with grpc.insecure_channel(f"127.0.0.1:{own}") as ch:
            mc = ch.unary_unary(f"/{SERVICE}/GetChannel", _ID, _ID)
            data = _field(_field(mc(vf(1, cid)), 1), 2)
            with pytest.raises(grpc.RpcError) as ei:
                mc(vf(1, 999999))
    return (replies, _field(data, 4), _field(data, 5), _field(data, 6, 0),
            _field(_field(data, 1), 1),
            _field(data, 2) == f"127.0.0.1:{port}".encode(),
            ei.value.code().name)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_channel_counters_and_get_channel(served, pair):
    want = _channel_counters("ref", "ref", served)
    assert _channel_counters(*pair, served) == want
    # 3 started, 3 ok, none failed, READY (3), the target, NOT_FOUND
    assert want == ([b"x"] * 3, 3, 3, 0, 3, True, "NOT_FOUND")


def _server_counters(cli, srv_name, served):
    srv, port = served(srv_name)
    with PKGS[cli].insecure_channel(f"127.0.0.1:{port}") as tch:
        assert tch.unary_unary("/z.S/Echo")(b"y", timeout=10) == b"y"
    cz = CZ[srv_name]
    _poll(lambda: cz.server_info(srv)["calls_succeeded"] >= 1)
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        resp = ch.unary_unary(f"/{SERVICE}/GetServer", _ID, _ID)(
            vf(1, srv._channelz_id))
    data = _field(_field(resp, 1), 2)
    # started counts the Echo and this GetServer itself; the timestamp
    # is a Timestamp message
    return (_field(data, 2, 0), _field(data, 3, 0), _field(data, 4, 0),
            _field(data, 5) is not None)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_server_call_counters_move(served, pair):
    want = _server_counters("ref", "ref", served)
    assert _server_counters(*pair, served) == want
    assert want == (2, 1, 0, True)


def _pages(srv_name, served):
    _, port = served(srv_name)
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        mc = ch.unary_unary(f"/{SERVICE}/GetTopChannels", _ID, _ID)
        # max_results=1: walking with start_channel_id terminates
        start, seen, pages, ids = 0, 0, 0, []
        while True:
            resp = mc(vf(1, start) + vf(2, 1))
            chans = _submsgs(resp, 1)
            seen += len(chans)
            pages += 1
            if _field(resp, 2) == 1 or not chans:
                break
            ref = _field(chans[-1], 1)
            ids.append(_field(ref, 1))
            start = _field(ref, 1) + 1
            assert pages < 1000
    return seen >= 0, ids == sorted(ids), len(set(ids)) == len(ids)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_pagination(served, pair):
    """One live channel of each package at least; pages are id-ordered
    and end."""
    cli, srv_name = pair
    _, port = served(srv_name)
    with PKGS[cli].insecure_channel(f"127.0.0.1:{port}") as tch:
        tch.unary_unary("/z.S/Echo")(b"p", timeout=10)
        want = _pages("ref", served)
        assert _pages(srv_name, served) == want == (True, True, True)


def _sockets(cli, srv_name, served):
    srv, port = served(srv_name)
    with PKGS[cli].insecure_channel(f"127.0.0.1:{port}") as tch:
        tch.unary_unary("/z.S/Echo")(b"s", timeout=10)  # a live connection
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary(f"/{SERVICE}/GetServerSockets", _ID, _ID)
            resp = mc(vf(1, srv._channelz_id))
            refs = _submsgs(resp, 1)
            gs = ch.unary_unary(f"/{SERVICE}/GetSocket", _ID, _ID)
            found = []
            for r in refs:
                sock = _field(gs(vf(1, _field(r, 1))), 1)
                found.append((_field(_field(sock, 2), 1, 0) >= 1,
                              _field(sock, 4) is not None))
            codes = []
            for call in (mc, gs):
                with pytest.raises(grpc.RpcError) as ei:
                    call(vf(1, 999999))
                codes.append(ei.value.code().name)
    # the live native connection streams; the grpcio one may not have yet
    return _field(resp, 2), (True, True) in found, codes


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_get_server_sockets_and_get_socket(served, pair):
    want = _sockets("ref", "ref", served)
    assert _sockets(*pair, served) == want
    assert want == (1, True, ["NOT_FOUND", "NOT_FOUND"])


def _deadline(cli, srv_name, served):
    srv, port = served(srv_name)
    release = threading.Event()

    def slow(req, ctx):
        release.wait(timeout=5)
        return b"late"

    pkg = PKGS[srv_name]
    srv.add_method("/z.S/Slow", pkg.unary_unary_rpc_method_handler(slow))
    try:
        with PKGS[cli].insecure_channel(f"127.0.0.1:{port}") as tch:
            with pytest.raises((jrpc.RpcError, trpc.RpcError)) as ei:
                tch.unary_unary("/z.S/Slow")(b"", timeout=0.2)
            c = tch.call_counters
            _poll(lambda: c.failed >= 1)
            return ei.value.code().name, c.started, c.succeeded, c.failed
    finally:
        release.set()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_deadline_expired_call_counts_as_failed(served, pair):
    want = _deadline("ref", "ref", served)
    assert _deadline(*pair, served) == want
    assert want == ("DEADLINE_EXCEEDED", 1, 0, 1)


def _listen_ids(srv_name, served):
    srv, port = served(srv_name)
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        resp = ch.unary_unary(f"/{SERVICE}/GetServer", _ID, _ID)(
            vf(1, srv._channelz_id))
        listen_refs = _submsgs(_field(resp, 1), 3)
        sid = _field(listen_refs[0], 1)
        sock = _field(ch.unary_unary(f"/{SERVICE}/GetSocket", _ID, _ID)(
            vf(1, sid)), 1)
    return len(listen_refs), _field(_field(sock, 1), 2) == (
        f"listen:{port}".encode())


@pytest.mark.parametrize("server", ["ref", "port"])
def test_get_socket_resolves_listen_socket_ids(served, server):
    want = _listen_ids("ref", served)
    assert _listen_ids(server, served) == want == (1, True)


def test_port_h2_plane_counts_calls():
    """A stock grpcio client's calls reach the port's server over the h2
    plane and count there as the native plane's do."""
    srv, port = _server("port", {"/t.S/Ok": lambda r, c: r, "/t.S/Bad": _bad})
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            assert ch.unary_unary("/t.S/Ok", _ID, _ID)(b"1") == b"1"
            with pytest.raises(grpc.RpcError):
                ch.unary_unary("/t.S/Bad", _ID, _ID)(b"2")
        assert _poll(lambda: srv.call_counters.failed == 1)
        assert (srv.call_counters.started, srv.call_counters.succeeded) == (
            2, 1)
    finally:
        srv.stop(grace=0)
