"""Server reflection (grpc.reflection.v1alpha and v1) on both packages.

Mirrors ``tests/test_reflection.py``: each scenario runs against the
reference's server and the port's, driven by a stock grpcio client or by
either package's channel (every client/server package pair), and the
replies are compared byte for byte. Requests are hand-encoded, as grpcurl
sends them. One more case lists the services of a TLS server over a secure
channel.
"""

import time

import grpc
import pytest

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from torch_tls import make_pki
from tpurpc.rpc import reflection as ref_reflection
from tpurpc_torch.rpc import reflection as port_reflection
from tpurpc_torch.wire.protowire import fields as _fields
from tpurpc_torch.wire.protowire import ld as _ld

PKGS = {"ref": jrpc, "port": trpc}
REFL = {"ref": ref_reflection, "port": port_reflection}
PAIRS = [("ref", "ref"), ("port", "port"), ("ref", "port"), ("port", "ref")]
PAIR_IDS = [f"{c}-to-{s}" for c, s in PAIRS]
V1ALPHA = port_reflection.V1ALPHA_SERVICE
V1 = port_reflection.V1_SERVICE
_ID = lambda b: b  # noqa: E731  identity (de)serializers: raw proto bytes


def _list_services_request() -> bytes:
    return _ld(7, b"")  # ServerReflectionRequest{ list_services = 7 }


def _decode_list_services(raw: bytes):
    """-> (valid_host, [service names]) of a ServerReflectionResponse."""
    names, host = [], b""
    for field_no, _wt, val in _fields(bytes(raw)):
        if field_no == 1:
            host = bytes(val)
        elif field_no == 6:  # ListServiceResponse
            for f2, _w2, v2 in _fields(bytes(val)):
                if f2 == 1:  # ServiceResponse
                    for f3, _w3, v3 in _fields(bytes(v2)):
                        if f3 == 1:
                            names.append(bytes(v3).decode())
    return host, names


def _decode_error(raw: bytes):
    """-> (code, message) of an error_response, or None."""
    for field_no, _wt, val in _fields(bytes(raw)):
        if field_no == 7:
            code, msg = 0, b""
            for f2, _w2, v2 in _fields(bytes(val)):
                if f2 == 1:
                    code = v2
                elif f2 == 2:
                    msg = v2
            return code, bytes(msg).decode()
    return None


def _decode_file_descriptors(raw: bytes):
    return [bytes(v2) for field_no, _wt, val in _fields(bytes(raw))
            if field_no == 4
            for f2, _w2, v2 in _fields(bytes(val)) if f2 == 1]


class _Served:
    """A started reflective server of one package with three methods."""

    def __init__(self, name, secure=False):
        pkg = PKGS[name]
        srv = pkg.Server(max_workers=4)
        for path in ("/demo.Greeter/Hello", "/demo.Greeter/Bye",
                     "/other.Thing/Do"):
            srv.add_method(path,
                           pkg.unary_unary_rpc_method_handler(lambda r, c: r))
        self.servicer = REFL[name].enable_server_reflection(srv)
        self.secure = secure
        if secure:
            pki = make_pki.load()
            self.port = srv.add_secure_port(
                "127.0.0.1:0", pkg.ssl_server_credentials(
                    [(pki["srv_key"], pki["srv_cert"])]))
        else:
            self.port = srv.add_insecure_port("127.0.0.1:0")
        srv.start()
        self.server = srv


@pytest.fixture
def served():
    """``served(name)``: a started reflective server of that package."""
    made = []

    def make(name, **kw):
        made.append(_Served(name, **kw))
        return made[-1]
    yield make
    for s in made:
        s.server.stop(grace=0)
    if any(s.secure for s in made):
        # a closed reference TLS endpoint may read on for up to 0.1 s, on
        # an fd number the next connection may already have (ROADMAP C)
        time.sleep(0.15)


def _ask(cli, port, reqs, service=V1ALPHA):
    with PKGS[cli].insecure_channel(f"127.0.0.1:{port}") as ch:
        mc = ch.stream_stream(f"/{service}/ServerReflectionInfo")
        return [bytes(r) for r in mc(iter(reqs), timeout=10)]


@pytest.mark.parametrize("server", ["ref", "port"])
def test_list_services_stock_grpcio_client(served, server):
    got = {}
    for name in ("ref", server):
        s = served(name)
        with grpc.insecure_channel(f"127.0.0.1:{s.port}") as ch:
            mc = ch.stream_stream(f"/{V1ALPHA}/ServerReflectionInfo", _ID, _ID)
            got[name] = list(mc(iter([_list_services_request()]), timeout=10))
    assert got[server] == got["ref"]
    assert len(got["ref"]) == 1
    _, names = _decode_list_services(got["ref"][0])
    assert "demo.Greeter" in names and "other.Thing" in names
    # a reflective server lists its own reflection services (C++ parity)
    assert V1ALPHA in names and V1 in names


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_v1_alias_and_native_channel(served, pair):
    want = _ask("ref", served("ref").port, [_list_services_request()],
                service=V1)
    got = _ask(pair[0], served(pair[1]).port, [_list_services_request()],
               service=V1)
    assert got == want
    assert "demo.Greeter" in _decode_list_services(want[0])[1]


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_echoes_host_and_original_request(served, pair):
    req = _ld(1, b"somehost") + _ld(7, b"")
    want = _ask("ref", served("ref").port, [req])
    got = _ask(pair[0], served(pair[1]).port, [req])
    assert got == want
    host, _ = _decode_list_services(want[0])
    assert host == b"somehost"
    assert {f: v for f, _w, v in _fields(want[0])}[2] == req


def _lookups(cli, s):
    # a hand-built FileDescriptorProto: name(1), package(2),
    # service(6){name(1), method(2){name(1)}}
    svc = _ld(1, b"Greeter") + _ld(2, _ld(1, b"Hello"))
    fdp = _ld(1, b"demo.proto") + _ld(2, b"demo") + _ld(6, svc)
    s.servicer.add_file_descriptor_protos([fdp])
    replies = [_ask(cli, s.port, [req])[0] for req in (
        _ld(3, b"demo.proto"), _ld(4, b"demo.Greeter"),
        _ld(4, b"demo.Greeter.Hello"), _ld(4, b"no.such.Thing"))]
    return fdp, replies


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_descriptor_lookup_and_not_found(served, pair):
    fdp, want = _lookups("ref", served("ref"))
    _, got = _lookups(pair[0], served(pair[1]))
    assert got == want
    # by filename, by service symbol, by method symbol
    for raw in want[:3]:
        assert _decode_file_descriptors(raw) == [fdp]
    # an unknown symbol: error_response NOT_FOUND (5), stream usable
    code, msg = _decode_error(want[3])
    assert code == 5 and "no.such.Thing" in msg


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_multiple_requests_one_stream(served, pair):
    reqs = [_list_services_request(), _ld(4, b"nope"),
            _list_services_request()]
    want = _ask("ref", served("ref").port, reqs)
    got = _ask(pair[0], served(pair[1]).port, reqs)
    assert got == want
    assert len(want) == 3 and _decode_error(want[1])[0] == 5
    assert "demo.Greeter" in _decode_list_services(want[2])[1]


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_malformed_oneof_wire_type_gets_error_response(served, pair):
    """A oneof arm sent as a varint is malformed: INVALID_ARGUMENT (3) on
    the stream, which stays usable."""
    bad = b"\x18\x05"  # field 3 (file_by_filename), wire type 0, value 5
    reqs = [bad, _list_services_request()]
    want = _ask("ref", served("ref").port, reqs)
    got = _ask(pair[0], served(pair[1]).port, reqs)
    assert got == want
    assert len(want) == 2 and _decode_error(want[0])[0] == 3
    assert "demo.Greeter" in _decode_list_services(want[1])[1]


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_list_services_over_tls(served, pair):
    pki = make_pki.load()

    def ask(cli, s):
        pkg = PKGS[cli]
        creds = pkg.ssl_channel_credentials(root_certificates=pki["ca"])
        with pkg.secure_channel(f"localhost:{s.port}", creds) as ch:
            mc = ch.stream_stream(f"/{V1}/ServerReflectionInfo")
            return [bytes(r) for r in mc(iter([_list_services_request()]),
                                         timeout=10)]

    want = ask("ref", served("ref", secure=True))
    time.sleep(0.15)   # the reference's closed TLS endpoint reads on
    assert ask(pair[0], served(pair[1], secure=True)) == want
    assert "other.Thing" in _decode_list_services(want[0])[1]


def test_module_descriptors_seed_new_servicers(served, monkeypatch):
    """``register_module_descriptors`` fills the process-wide registry
    (idempotent by content) that every servicer made afterwards answers
    from, on both packages."""
    svc = _ld(1, b"Seeded") + _ld(2, _ld(1, b"Go"))
    fdp = _ld(1, b"seeded.proto") + _ld(2, b"sd") + _ld(6, svc)
    out = {}
    for name in ("ref", "port"):
        monkeypatch.setattr(REFL[name], "_GLOBAL_FILES", [])
        REFL[name].register_module_descriptors([fdp, fdp])
        assert REFL[name]._GLOBAL_FILES == [fdp]
        s = served(name)
        out[name] = _ask(name, s.port, [_ld(4, b"sd.Seeded.Go")])
    assert out["port"] == out["ref"]
    assert _decode_file_descriptors(out["ref"][0]) == [fdp]
