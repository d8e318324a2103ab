"""TLS and mTLS on every wire plane, on both packages.

Mirrors ``tests/test_tls.py``: each scenario runs on the reference
(``tpurpc``) and on the port (``tpurpc_torch``), and across client/server
package pairs, and the observations are compared: TLS end to end on TCP and
on the ring platforms (``RDMA_BP``, ``RDMA_EVENT``, ``RDMA_BPEV``, and
``TPU`` with a CPU ring), where the ring bootstrap and its notify channel
ride the TLS socket; the untrusted server; the plaintext client refused at
the handshake; mTLS requiring the client certificate; ``auth_context`` with
the mTLS identity; a ring port serving a stock grpcio TLS client; and
``H2Channel`` over TLS against stock grpcio and both packages' servers.

A secure channel never falls back to plaintext: a server whose handshake
fails sees no connection reach its protocol sniff, and a listener that
records every byte a failing secure channel sends sees TLS records only.

Certificates are the committed test-only PKI in ``tests/torch_tls/``
(``make_pki.py`` rewrites it); nothing is generated at run time.
"""

import socket
import ssl
import threading
import time

import grpc
import numpy as np
import pytest
import torch

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from torch_tls import make_pki
from tpurpc.core import _native as ref_native
from tpurpc.core import pair as ref_pair
from tpurpc.rpc import frame as ref_frame
from tpurpc.utils import config as ref_config
from tpurpc_torch.core import _native as port_native
from tpurpc_torch.core import pair as port_pair
from tpurpc_torch.core.poller import PairPool, Poller
from tpurpc_torch.ops import ring_scatter as rs_mod
from tpurpc_torch.ops import ring_window as rw_mod
from tpurpc_torch.torchshim.service import TensorClient, add_tensor_method
from tpurpc_torch.utils import config as torch_config

PKGS = {"ref": jrpc, "port": trpc}
PAIRS = [("ref", "ref"), ("port", "port"), ("ref", "port"), ("port", "ref")]
PAIR_IDS = [f"{c}-to-{s}" for c, s in PAIRS]
RING_PLATFORMS = ["RDMA_BP", "RDMA_EVENT", "RDMA_BPEV", "TPU"]
ECHO, WHO = "/t.S/Echo", "/t.S/Who"
BIG = bytes(range(256)) * 4096        # 1 MiB through the encrypted pipe
#: what a handler's context says of a TLS client without a certificate, by
#: the server's package: the port reads ``ssl`` (grpcio's contract, and the
#: reference's own docstring); the reference reads {} because
#: ``getpeercert()`` is None on a server that asked for no certificate
#: (ROADMAP C)
CERTLESS = {"ref": ({}, None, None),
            "port": ({"transport_security_type": [b"ssl"]}, None, None)}


@pytest.fixture(scope="module")
def certs():
    return make_pki.load()


@pytest.fixture
def platform(monkeypatch):
    """``platform(name)``: both packages on ``name``, the port on the CPU;
    the port's singletons reset afterwards."""
    # The reference loads (and, without native/build, first compiles) its
    # native library on a ring's first use under a lock other processes
    # wait on: take that wait here, not inside a call with a deadline.
    ref_native.load()
    port_native.load()  # and the port's, outside deadlines too

    def use(name):
        monkeypatch.setenv("GRPC_PLATFORM_TYPE", name)
        monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
        ref_config.set_config(None)
        torch_config.set_config(None)
    use("TCP")
    yield use
    Poller.reset()
    PairPool.reset()
    ref_config.set_config(None)
    torch_config.set_config(None)


class _Rig:
    """A started TLS server of one package: Echo, and Who, which records
    what its context says of the peer. ``sniffed`` counts connections that
    reached the protocol sniff (after any handshake)."""

    def __init__(self, pkg, certs, require_client_auth=False, roots=False,
                 insecure=False):
        self.pkg = pkg
        self.seen = []
        self.served = 0
        self.sniffed = 0
        # a native plane (a plaintext ring port's default) has no
        # auth_context; the Python plane does
        srv = pkg.Server(max_workers=4, native_dataplane=False)

        def echo(req, ctx):
            self.served += 1
            return bytes(req)

        def who(req, ctx):
            self.served += 1
            self.seen.append((ctx.auth_context(), ctx.peer_identities(),
                              ctx.peer_identity_key()))
            return b"ok"

        srv.add_method(ECHO, pkg.unary_unary_rpc_method_handler(echo))
        srv.add_method(WHO, pkg.unary_unary_rpc_method_handler(who))
        sniff = srv._sniff_and_serve

        def counted_sniff(endpoint):
            self.sniffed += 1
            return sniff(endpoint)

        srv._sniff_and_serve = counted_sniff
        self.insecure = insecure
        if insecure:
            self.port = srv.add_insecure_port("127.0.0.1:0")
        else:
            creds = pkg.ssl_server_credentials(
                [(certs["srv_key"], certs["srv_cert"])],
                root_certificates=(certs["ca"]
                                   if require_client_auth or roots else None),
                require_client_auth=require_client_auth)
            self.port = srv.add_secure_port("127.0.0.1:0", creds)
        srv.start()
        self.server = srv

    def endpoint(self):
        return _first_conn(self.server).endpoint

    def stop(self):
        self.server.stop(grace=0)
        if not self.insecure:
            _settle()


#: how long the reference's TLS endpoints may go on reading after close:
#: a read blocks inside OpenSSL for up to 0.1 s, on an fd number that the
#: next connection may already have (ROADMAP C)
REF_TLS_LINGER_S = 0.15


def _settle():
    """Let a closed reference TLS endpoint's last read run out before the
    next connection takes its fd number."""
    time.sleep(REF_TLS_LINGER_S)


def _first_conn(srv):
    """The server's first connection; a server registers a connection
    after it starts serving it, so a reply can arrive first."""
    deadline = time.monotonic() + 10
    while not srv._connections and time.monotonic() < deadline:
        time.sleep(0.01)
    return srv._connections[0]


def _observe(fn):
    """``("ok", fn())``, or ``("error", code name)`` when ``fn`` raises
    either package's RpcError."""
    try:
        return ("ok", fn())
    except (jrpc.RpcError, trpc.RpcError) as exc:
        return ("error", exc.code().name)


def _mutual(pkg, certs):
    return pkg.ssl_channel_credentials(root_certificates=certs["ca"],
                                       private_key=certs["cli_key"],
                                       certificate_chain=certs["cli_cert"])


def _e2e(cli, srv_pkg, certs):
    rig = _Rig(srv_pkg, certs)
    try:
        creds = cli.ssl_channel_credentials(root_certificates=certs["ca"])
        with cli.secure_channel(f"localhost:{rig.port}", creds) as ch:
            echo = ch.unary_unary(ECHO)
            small = bytes(echo(b"secure", timeout=20)) == b"secure"
            big = bytes(echo(BIG, timeout=30)) == BIG
            who = bytes(ch.unary_unary(WHO)(b"", timeout=20))
            ep = rig.endpoint()
            pair = getattr(ep, "pair", None)
            notify_tls = (None if pair is None
                          else isinstance(pair.notify_sock, ssl.SSLSocket))
            return {"small": small, "big": big, "who": who,
                    "endpoint": type(ep).__name__, "notify_tls": notify_tls,
                    "seen": rig.seen, "sniffed": rig.sniffed}
    finally:
        rig.stop()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", ["TCP"] + RING_PLATFORMS)
def test_tls_e2e(platform, certs, name, pair):
    """Echo (6 bytes and 1 MiB) and Who over TLS: a ring platform
    bootstraps over the TLS socket and keeps it as the encrypted notify
    channel, and a certless client's context reads ``ssl`` alone."""
    platform(name)
    want = _e2e(jrpc, jrpc, certs)
    got = _e2e(PKGS[pair[0]], PKGS[pair[1]], certs)
    assert got.pop("seen") == [CERTLESS[pair[1]]]
    assert want.pop("seen") == [CERTLESS["ref"]]
    assert got == want
    assert want["small"] and want["big"] and want["who"] == b"ok"
    assert want["notify_tls"] is (None if name == "TCP" else True)
    assert want["sniffed"] == 1


def _untrusted(cli, srv_pkg, certs):
    rig = _Rig(srv_pkg, certs)
    try:
        # a trust anchor that did NOT sign the server's certificate
        creds = cli.ssl_channel_credentials(
            root_certificates=certs["other_ca"])
        with cli.secure_channel(f"localhost:{rig.port}", creds) as ch:
            got = _observe(lambda: ch.unary_unary(ECHO)(b"x", timeout=5))
        return got, rig.served, rig.sniffed
    finally:
        rig.stop()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_tls_rejects_untrusted_server(platform, certs, pair):
    want = _untrusted(jrpc, jrpc, certs)
    assert _untrusted(PKGS[pair[0]], PKGS[pair[1]], certs) == want
    assert want == (("error", "UNAVAILABLE"), 0, 0)


def _port_handshake_failure_detail(certs):
    rig = _Rig(trpc, certs)
    try:
        creds = trpc.ssl_channel_credentials(
            root_certificates=certs["other_ca"])
        with trpc.secure_channel(f"localhost:{rig.port}", creds) as ch:
            with pytest.raises(trpc.RpcError) as ei:
                ch.unary_unary(ECHO)(b"x", timeout=5)
        return ei.value.code(), ei.value.details()
    finally:
        rig.stop()


def test_port_failed_handshake_is_unavailable_tls_handshake_failed(
        platform, certs):
    code, details = _port_handshake_failure_detail(certs)
    assert code is trpc.StatusCode.UNAVAILABLE
    assert "TLS handshake failed" in details


def _plaintext_client(cli, srv_pkg, certs):
    rig = _Rig(srv_pkg, certs)
    try:
        with cli.insecure_channel(f"127.0.0.1:{rig.port}") as ch:
            got = _observe(lambda: ch.unary_unary(ECHO)(b"x", timeout=5))
        return got, rig.served, rig.sniffed
    finally:
        rig.stop()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", ["TCP", "RDMA_BPEV"])
def test_tls_plaintext_client_rejected(platform, certs, name, pair):
    """A plaintext client on a TLS port dies at the handshake: it is closed,
    never served, and reaches no protocol layer."""
    platform(name)
    want = _plaintext_client(jrpc, jrpc, certs)
    assert _plaintext_client(PKGS[pair[0]], PKGS[pair[1]], certs) == want
    assert want[0][0] == "error" and want[1:] == (0, 0)


def _mtls(cli, srv_pkg, certs):
    rig = _Rig(srv_pkg, certs, require_client_auth=True)
    try:
        bare = cli.ssl_channel_credentials(root_certificates=certs["ca"])
        with cli.secure_channel(f"localhost:{rig.port}", bare) as ch:
            without = _observe(lambda: ch.unary_unary(ECHO)(b"x", timeout=5))
        _settle()
        served_before = rig.served
        with cli.secure_channel(f"localhost:{rig.port}",
                                _mutual(cli, certs)) as ch:
            with_cert = _observe(
                lambda: bytes(ch.unary_unary(ECHO)(b"m", timeout=20)))
        return without, served_before, with_cert
    finally:
        rig.stop()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", ["TCP", "TPU"])
def test_mtls_requires_client_cert(platform, certs, name, pair):
    platform(name)
    want = _mtls(jrpc, jrpc, certs)
    assert _mtls(PKGS[pair[0]], PKGS[pair[1]], certs) == want
    assert want[0][0] == "error" and want[1] == 0 and want[2] == ("ok", b"m")


def _identity(cli, srv_pkg, certs):
    out = {}
    for label, kw, creds in (
            ("mtls", {"require_client_auth": True}, _mutual(cli, certs)),
            ("tls", {}, cli.ssl_channel_credentials(
                root_certificates=certs["ca"])),
            ("optional", {"roots": True}, _mutual(cli, certs))):
        rig = _Rig(srv_pkg, certs, **kw)
        try:
            with cli.secure_channel(f"localhost:{rig.port}", creds) as ch:
                assert bytes(ch.unary_unary(WHO)(b"", timeout=30)) == b"ok"
            out[label] = rig.seen
        finally:
            rig.stop()
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", ["TCP", "RDMA_BPEV", "TPU"])
def test_auth_context_exposes_mtls_identity(platform, certs, name, pair):
    """grpcio's auth_context / peer_identities / peer_identity_key: the mTLS
    client's URI SAN is its identity (SANs win over the CN), on TCP and
    through a ring's notify socket, also where the server only asks for a
    certificate (``CERT_OPTIONAL``); TLS without a client certificate
    reads ``ssl`` alone on the port (``CERTLESS``)."""
    platform(name)
    want = _identity(jrpc, jrpc, certs)
    got = _identity(PKGS[pair[0]], PKGS[pair[1]], certs)
    assert got.pop("tls") == [CERTLESS[pair[1]]]
    assert want.pop("tls") == [CERTLESS["ref"]]
    assert got == want
    sans = [make_pki.CLIENT_URI.encode()]
    mtls = ({"transport_security_type": [b"ssl"],
             "x509_subject_alternative_name": sans,
             "x509_common_name": [b"tpurpc-test-client"]},
            sans, "x509_subject_alternative_name")
    assert want == {"mtls": [mtls], "optional": [mtls]}


def _plaintext_identity(cli, srv_pkg, certs):
    rig = _Rig(srv_pkg, certs, insecure=True)
    try:
        with cli.insecure_channel(f"127.0.0.1:{rig.port}") as ch:
            assert bytes(ch.unary_unary(WHO)(b"", timeout=30)) == b"ok"
        return rig.seen
    finally:
        rig.stop()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_auth_context_is_empty_in_plaintext(platform, certs, pair):
    want = _plaintext_identity(jrpc, jrpc, certs)
    assert _plaintext_identity(PKGS[pair[0]], PKGS[pair[1]], certs) == want
    assert want == [({}, None, None)]


def _stock_client(srv_pkg, certs, ring_client=None):
    rig = _Rig(srv_pkg, certs)
    try:
        out = []
        if ring_client is not None:
            creds = ring_client.ssl_channel_credentials(
                root_certificates=certs["ca"])
            with ring_client.secure_channel(f"localhost:{rig.port}",
                                            creds) as ch:
                out.append(bytes(ch.unary_unary(ECHO)(b"ring", timeout=30)))
                out.append(type(rig.endpoint()).__name__)
            _settle()
        gc = grpc.ssl_channel_credentials(root_certificates=certs["ca"])
        with grpc.secure_channel(f"localhost:{rig.port}", gc) as gch:
            mc = gch.unary_unary(ECHO, lambda x: x, lambda x: x)
            out.append(mc(b"grpcio-tls", timeout=20))
        return out
    finally:
        rig.stop()


@pytest.mark.parametrize("server", ["ref", "port"])
def test_stock_grpcio_tls_client(platform, certs, server):
    """grpc.secure_channel (C-core TLS, ALPN h2) against a TLS port."""
    assert _stock_client(PKGS[server], certs) == [b"grpcio-tls"]


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", ["RDMA_BPEV", "TPU"])
def test_ring_port_serves_stock_grpcio_tls(platform, certs, name, pair):
    """One TLS port on a ring platform serves a ring client (bootstrapped
    over TLS) and a stock grpcio TLS client (the h2 preface, decrypted,
    lands on the TCP path)."""
    platform(name)
    want = _stock_client(jrpc, certs, ring_client=jrpc)
    got = _stock_client(PKGS[pair[1]], certs, ring_client=PKGS[pair[0]])
    assert got == want
    assert want[0] == b"ring" and want[2] == b"grpcio-tls"


def _h2_tls(cli, srv_pkg, certs):
    if srv_pkg is None:
        from concurrent import futures

        gsrv = grpc.server(futures.ThreadPoolExecutor(max_workers=4))

        class H(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method == ECHO:
                    return grpc.unary_unary_rpc_method_handler(
                        lambda req, ctx: req,
                        request_deserializer=lambda x: x,
                        response_serializer=lambda x: x)
                return None

        gsrv.add_generic_rpc_handlers((H(),))
        port = gsrv.add_secure_port("127.0.0.1:0", grpc.ssl_server_credentials(
            [(certs["srv_key"], certs["srv_cert"])]))
        gsrv.start()
        stop = lambda: gsrv.stop(grace=0)   # noqa: E731
    else:
        rig = _Rig(srv_pkg, certs)
        port, stop = rig.port, rig.stop
    try:
        creds = cli.ssl_channel_credentials(root_certificates=certs["ca"])
        with cli.H2Channel(f"localhost:{port}", credentials=creds) as ch:
            alpn = ch._ep._sock.selected_alpn_protocol()
            reply = bytes(ch.unary_unary(ECHO)(b"h2-tls", timeout=20))
        return alpn, reply
    finally:
        stop()
        _settle()


@pytest.mark.parametrize("client", ["ref", "port"])
def test_h2channel_tls_against_stock_grpcio(platform, certs, client):
    assert _h2_tls(PKGS[client], None, certs) == ("h2", b"h2-tls")


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_h2channel_tls_against_both_packages(platform, certs, pair):
    want = _h2_tls(jrpc, jrpc, certs)
    assert _h2_tls(PKGS[pair[0]], PKGS[pair[1]], certs) == want
    assert want == ("h2", b"h2-tls")


def _call_ms(pkg, port, creds, h2):
    """Median ms of 11 sequential 100-byte echo calls on one channel."""
    if h2:
        ch = pkg.H2Channel(f"localhost:{port}", credentials=creds)
    elif creds is None:
        ch = pkg.insecure_channel(f"127.0.0.1:{port}")
    else:
        ch = pkg.secure_channel(f"localhost:{port}", creds)
    with ch:
        mc = ch.unary_unary(ECHO)
        mc(b"warm", timeout=10)
        ms = []
        for _ in range(11):
            t0 = time.perf_counter()
            assert bytes(mc(b"x" * 100, timeout=10)) == b"x" * 100
            ms.append((time.perf_counter() - t0) * 1e3)
        return sorted(ms)[5]


@pytest.mark.parametrize("h2", [False, True], ids=["native", "h2"])
def test_tls_on_tcp_does_not_hold_writes_behind_a_parked_reader(
        platform, certs, h2):
    """A reader waiting for data must not hold the SSL lock: each side's
    reply waits on it otherwise. The reference's locked read blocks up to
    0.1 s, so each of its sequential TLS calls on TCP takes about 0.2 s
    (ROADMAP C); the port's locked reads and writes never block, and a
    TLS call costs about what a plaintext one does."""
    rig = _Rig(trpc, certs)
    plain = _Rig(trpc, certs, insecure=True)
    try:
        creds = trpc.ssl_channel_credentials(root_certificates=certs["ca"])
        tls_ms = _call_ms(trpc, rig.port, creds, h2)
        plain_ms = _call_ms(trpc, plain.port, None, h2)
    finally:
        rig.stop()
        plain.stop()
    assert tls_ms < plain_ms + 50.0, (tls_ms, plain_ms)


class _Recorder:
    """A listener that records every byte each connection sends, then
    closes it without a word (a secure client's handshake fails on EOF)."""

    def __init__(self):
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self.conns = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                continue
            conn.settimeout(0.5)
            got = b""
            try:
                while True:
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    got += chunk
            except OSError:
                pass  # the client's hello is in; it waits for ours
            conn.close()
            self.conns.append(got)

    def close(self):
        self._stop.set()
        self._t.join(timeout=5)
        self._sock.close()


def _no_plaintext_after_failure(cli, certs):
    rec = _Recorder()
    try:
        creds = cli.ssl_channel_credentials(root_certificates=certs["ca"])
        with cli.secure_channel(f"localhost:{rec.port}", creds) as ch:
            # wait_for_ready redials through the backoff until the deadline
            got = _observe(lambda: ch.unary_unary(ECHO)(
                b"x", timeout=2, wait_for_ready=True))
    finally:
        rec.close()
    magics = (ref_frame.MAGIC, ref_pair._BOOTSTRAP_MAGIC, b"PRI * HT")
    return (got[0], len(rec.conns) >= 2,
            all(c[:2] == b"\x16\x03" for c in rec.conns),
            any(m in c for c in rec.conns for m in magics))


@pytest.mark.parametrize("client", ["ref", "port"])
def test_secure_channel_never_sends_plaintext_after_failed_handshake(
        platform, certs, client):
    """Every connection a failing secure channel opens (redials included)
    carries a TLS handshake record and no byte of any protocol preface."""
    want = _no_plaintext_after_failure(jrpc, certs)
    assert _no_plaintext_after_failure(PKGS[client], certs) == want
    assert want == ("error", True, True, False)


def _tls_socket_pair(certs):
    """A connected (server, client) pair of SSLSockets over TCP."""
    sctx = trpc.ssl_server_credentials(
        [(certs["srv_key"], certs["srv_cert"])])._context
    cctx = trpc.ssl_channel_credentials(root_certificates=certs["ca"])._context
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    out = {}

    def accept():
        raw, _ = lst.accept()
        raw.settimeout(10)
        out["srv"] = sctx.wrap_socket(raw, server_side=True)

    t = threading.Thread(target=accept)
    t.start()
    raw = socket.create_connection(lst.getsockname(), timeout=10)
    cli = cctx.wrap_socket(raw, server_hostname="localhost")
    t.join(timeout=10)
    lst.close()
    return out["srv"], cli


def _notify_probe(mod, certs):
    """Two pairs of ``mod`` bootstrapped over TLS sockets: the probe before
    and after a data token, the drained tokens, the probe after the drain,
    and after the peer's close."""
    srv_sock, cli_sock = _tls_socket_pair(certs)
    a, b = mod.Pair(mod.LocalDomain()), mod.Pair(mod.LocalDomain())
    a.init()
    b.init()
    errs = []

    def connect_b():
        try:
            b.connect_over_socket(srv_sock)
        except Exception as exc:  # surfaced below
            errs.append(exc)

    t = threading.Thread(target=connect_b)
    t.start()
    a.connect_over_socket(cli_sock)
    t.join(timeout=20)
    assert not errs, errs
    try:
        obs = [isinstance(b.notify_sock, ssl.SSLSocket), b.peek_events()]
        a._notify(mod.NOTIFY_DATA)
        deadline = time.monotonic() + 5
        while not b.peek_events() and time.monotonic() < deadline:
            time.sleep(0.005)
        obs.append(b.peek_events())
        obs.append(b.drain_notifications())
        obs.append(b.peek_events())
        a.destroy()
        deadline = time.monotonic() + 5
        while not b.peek_events() and time.monotonic() < deadline:
            time.sleep(0.005)
        obs.append(b.peek_events())
        b.drain_notifications()
        obs.append(b.get_status().name)
        return obs
    finally:
        a.destroy()
        b.destroy()


def test_peek_events_on_a_tls_notify_socket(platform, certs, monkeypatch):
    """The notify channel over TLS: the non-consuming probe never raises
    (an SSLSocket refuses MSG_PEEK), sees a pending token, leaves it for the
    drain, and sees the peer's close."""
    want = _notify_probe(ref_pair, certs)
    calls = []
    orig = ssl.SSLSocket.recv

    def recv(self, buflen=1024, flags=0):
        calls.append(flags)
        return orig(self, buflen, flags)

    monkeypatch.setattr(ssl.SSLSocket, "recv", recv)
    got = _notify_probe(port_pair, certs)
    assert got == want
    assert want == [True, False, True, b"d", False, True, "HALF_CLOSED"]
    assert socket.MSG_PEEK not in calls


@pytest.fixture
def counted_plain(monkeypatch):
    """Count calls of the kernels' plain versions (the CPU path)."""
    calls = {"ring_scatter": 0, "ring_window": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(rs_mod, "ring_scatter_plain",
                        counting("ring_scatter", rs_mod.ring_scatter_plain))
    monkeypatch.setattr(rw_mod, "ring_window_plain",
                        counting("ring_window", rw_mod.ring_window_plain))
    return calls


def test_mtls_device_ring_bit_equal_to_plaintext(platform, certs, monkeypatch,
                                                 counted_plain):
    """The device-ring main path at a small size: a tensor method with
    ``device=True`` on a 64 KiB CPU ring, 6 requests of 24,576 bytes (the
    3rd and 6th wrap), once plaintext and once over mTLS on another server
    of the same function: replies bit-equal, the wrapped landing and view
    taken alike, the handler's context holding the client's SAN, and the
    ring back to capacity."""
    monkeypatch.setenv("TPURPC_HBM_RING_SIZE_KB", "64")
    platform("TPU")
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 4)).astype(np.float32))
    rng = np.random.default_rng(13)
    xs = [torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32)) for _ in range(6)]
    idents = []

    def fn(tree):
        x = tree["images"]
        return {"y": x.sum(dim=(1, 2)) @ w, "x0": x[:, 0, 0, :].clone()}

    def run(secure):
        srv = trpc.Server(max_workers=2)

        class Who(trpc.ServerInterceptor):
            def intercept_service(self, continuation, details):
                handler = continuation(details)
                inner = handler.behavior

                def seen(raw, ctx):
                    idents.append(ctx.peer_identities())
                    return inner(raw, ctx)

                return trpc.RpcMethodHandler(
                    handler.kind, seen, handler.request_deserializer,
                    handler.response_serializer)

        srv.interceptors.append(Who())
        add_tensor_method(srv, "Classify", fn, device=True)
        if secure:
            port = srv.add_secure_port("127.0.0.1:0", trpc.ssl_server_credentials(
                [(certs["srv_key"], certs["srv_cert"])],
                root_certificates=certs["ca"], require_client_auth=True))
            ch = trpc.secure_channel(f"localhost:{port}", _mutual(trpc, certs))
        else:
            port = srv.add_insecure_port("127.0.0.1:0")
            ch = trpc.insecure_channel(f"127.0.0.1:{port}")
        srv.start()
        before = dict(counted_plain)
        try:
            client = TensorClient(ch)
            replies = [client.call("Classify", {"images": x}, timeout=30)
                       for x in xs]
            stats = _first_conn(srv).endpoint.device_ring.stats()
        finally:
            ch.close()
            srv.stop(grace=0)
        used = {k: counted_plain[k] - before[k] for k in before}
        return replies, used, stats

    plain, plain_used, _ = run(False)
    tls, tls_used, stats = run(True)
    for p, t in zip(plain, tls):
        assert torch.equal(p["y"], t["y"]) and torch.equal(p["x0"], t["x0"])
    assert tls_used == plain_used == {"ring_scatter": 2, "ring_window": 2}
    assert stats["live_spans"] == 0 and stats["writable"] == stats["capacity"]
    assert idents == [None] * 6 + [[make_pki.CLIENT_URI.encode()]] * 6


def test_tls_refusals_leave_the_device_ring_untouched(platform, certs,
                                                      monkeypatch,
                                                      counted_plain):
    """A channel trusting only the other CA, a plaintext client and an mTLS
    port reached without a client certificate all fail, and the device-ring
    server's ring and the kernels' counts do not move."""
    monkeypatch.setenv("TPURPC_HBM_RING_SIZE_KB", "64")
    platform("TPU")
    srv = trpc.Server(max_workers=2)
    add_tensor_method(srv, "Classify", lambda t: {"y": t["images"] * 2},
                      device=True)
    sniffed = []
    sniff = srv._sniff_and_serve
    srv._sniff_and_serve = lambda ep: (sniffed.append(1), sniff(ep))
    port = srv.add_secure_port("127.0.0.1:0", trpc.ssl_server_credentials(
        [(certs["srv_key"], certs["srv_cert"])],
        root_certificates=certs["ca"], require_client_auth=True))
    srv.start()
    x = torch.arange(2 * 32 * 32 * 3, dtype=torch.float32).reshape(2, 32, 32, 3)
    try:
        with trpc.secure_channel(f"localhost:{port}",
                                 _mutual(trpc, certs)) as ch:
            out = TensorClient(ch).call("Classify", {"images": x}, timeout=30)
            assert torch.equal(out["y"], x * 2)
            ring = _first_conn(srv).endpoint.device_ring
        before = (dict(counted_plain), ring.stats())
        codes = []
        for ch in (trpc.secure_channel(
                       f"localhost:{port}", trpc.ssl_channel_credentials(
                           root_certificates=certs["other_ca"])),
                   trpc.insecure_channel(f"127.0.0.1:{port}"),
                   trpc.secure_channel(
                       f"localhost:{port}", trpc.ssl_channel_credentials(
                           root_certificates=certs["ca"]))):
            with ch:
                with pytest.raises(trpc.RpcError) as ei:
                    TensorClient(ch).call("Classify", {"images": x},
                                          timeout=5)
                codes.append(ei.value.code().name)
        assert (dict(counted_plain), ring.stats()) == before
        assert before[1]["live_spans"] == 0
        assert before[1]["writable"] == before[1]["capacity"]
        assert codes == ["UNAVAILABLE"] * 3
        assert len(sniffed) == 1   # the refused clients reached no protocol
    finally:
        srv.stop(grace=0)
