"""The port's test endpoints, accept path and resource limits against the
reference's: twins of ``tests/test_endpoint.py``'s ``MockEndpoint`` and
passthru cases and its pool-recycle case, of ``tests/test_limits.py``'s six
cases, and the listener's burst accepts and admission shedding.

Each scenario runs on both packages and the observations (bytes, status
codes by name, details, counts) are compared. Every wait is bounded;
environment changes go through ``monkeypatch`` with both packages' config
reset after each.
"""

import queue
import socket
import threading
import time
import types

import pytest

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from tpurpc.core import _native as ref_native
from tpurpc.core import endpoint as ref_ep
from tpurpc.core import poller as ref_poller
from tpurpc.utils import config as ref_config
from tpurpc_torch.core import _native as port_native
from tpurpc_torch.core import endpoint as port_ep
from tpurpc_torch.core import pair as port_pair
from tpurpc_torch.core import poller as port_poller
from tpurpc_torch.utils import config as port_config
from tpurpc.core import pair as ref_pair

REF = types.SimpleNamespace(name="ref", ep=ref_ep, poller=ref_poller,
                            config=ref_config, rpc=jrpc, P=ref_pair)
PORT = types.SimpleNamespace(name="port", ep=port_ep, poller=port_poller,
                             config=port_config, rpc=trpc, P=port_pair)
PKGS = (REF, PORT)


def _reset_config():
    for pkg in PKGS:
        pkg.config.set_config(None)


@pytest.fixture(autouse=True)
def _fresh():
    _reset_config()
    yield
    _reset_config()
    for pkg in PKGS:
        pkg.poller.Poller.reset()
        pkg.poller.PairPool.reset()
        pkg.P.RingPool.reset()


def both(scenario, *args):
    got = {pkg.name: scenario(pkg, *args) for pkg in PKGS}
    assert got["port"] == got["ref"], got
    return got["port"]


# ---------------------------------------------------------------------------
# test endpoints
# ---------------------------------------------------------------------------

def _mock_script(pkg):
    m = pkg.ep.MockEndpoint()
    out = []
    m.inject(b"scripted")
    out.append(m.read(100))
    m.write([b"cap", b"tured"])
    out.append(bytes(m.written))
    m.inject_eof()
    out.append(m.read(10))
    out.append(m.read(10))  # EOF is sticky
    m.close()
    try:
        m.read(1)
    except pkg.ep.EndpointError as exc:
        out.append(("EndpointError", str(exc)))
    return out


def test_mock_endpoint_scriptability():
    assert both(_mock_script) == [b"scripted", b"captured", b"", b"",
                                  ("EndpointError", "read on closed endpoint")]


def _mock_tail(pkg):
    m = pkg.ep.MockEndpoint()
    m.inject(b"x" * 100)
    first = m.read(10)
    rest = b""
    while len(rest) < 90:
        rest += m.read(40)
    return first, rest


def test_mock_endpoint_retains_tail_beyond_max_bytes():
    assert both(_mock_tail) == (b"x" * 10, b"x" * 90)


def test_mock_endpoint_read_into_and_timeout():
    """The port's frame reader reads with ``read_into``: a queue endpoint
    gives the same bytes through it, and an empty read times out."""
    m = port_ep.MockEndpoint()
    m.inject(b"abcdef")
    buf = bytearray(4)
    assert m.read_into(buf) == 4 and bytes(buf) == b"abcd"
    assert m.read(10) == b"ef"
    with pytest.raises(port_ep.ReadTimeout):
        m.read(1, timeout=0.05)


def _read_exact(ep, n, timeout=30):
    out = b""
    deadline = time.monotonic() + timeout
    while len(out) < n:
        remain = deadline - time.monotonic()
        assert remain > 0, f"timed out with {len(out)}/{n} bytes"
        chunk = ep.read(n - len(out), timeout=remain)
        assert chunk != b"", "unexpected EOF"
        out += chunk
    return out


def _passthru(pkg, case):
    a, b = pkg.ep.passthru_endpoint_pair()
    try:
        return case(pkg, a, b)
    finally:
        a.close()
        b.close()


def _roundtrip_small(pkg, a, b):
    a.write(b"hello")
    got = _read_exact(b, 5)
    b.write([b"wor", b"ld"])  # gather write
    return got, _read_exact(a, 5)


def _large_both_ways(pkg, a, b):
    blob = bytes(i & 0xFF for i in range(1 << 20))  # 1 MiB
    t = threading.Thread(target=lambda: a.write(blob))
    t.start()
    got1 = _read_exact(b, len(blob), timeout=60) == blob
    t.join(60)
    t2 = threading.Thread(target=lambda: b.write(blob))
    t2.start()
    got2 = _read_exact(a, len(blob), timeout=60) == blob
    t2.join(60)
    return got1, got2


def _many_small(pkg, a, b):
    msgs = [f"m{i:04d}|".encode() for i in range(200)]

    def pump():
        for m in msgs:
            a.write(m)

    t = threading.Thread(target=pump)
    t.start()
    expect = b"".join(msgs)
    got = _read_exact(b, len(expect), timeout=60) == expect
    t.join(60)
    return got


def _clean_eof(pkg, a, b):
    a.write(b"bye")
    a.close()
    return _read_exact(b, 3), b.read(100, timeout=10)


def _read_timeout(pkg, a, b):
    try:
        b.read(100, timeout=0.2)
        timed_out = False
    except pkg.ep.ReadTimeout:
        timed_out = True
    a.write(b"late")  # still usable afterwards
    return timed_out, _read_exact(b, 4)


def _names(pkg, a, b):
    return [(ep.peer, ep.local_address) for ep in (a, b)]


@pytest.mark.parametrize("case, want", [
    (_roundtrip_small, (b"hello", b"world")),
    (_large_both_ways, (True, True)),
    (_many_small, True),
    (_clean_eof, (b"bye", b"")),
    (_read_timeout, (True, b"late")),
    (_names, [("passthru:a:peer", "passthru:a:local"),
              ("passthru:b:peer", "passthru:b:local")]),
], ids=["roundtrip_small", "large_transfer_both_directions",
        "many_small_writes_preserve_stream", "clean_eof_on_close",
        "read_timeout", "peer_and_local_names"])
def test_passthru_endpoint(case, want):
    assert both(_passthru, case) == want


def _listener(pkg, monkeypatch, platform):
    monkeypatch.setenv("GRPC_PLATFORM_TYPE", platform)
    _reset_config()
    accepted: "queue.Queue" = queue.Queue()
    listener = pkg.ep.EndpointListener("127.0.0.1", 0, accepted.put)
    client = pkg.ep.connect_endpoint("127.0.0.1", listener.port)
    server = accepted.get(timeout=10)
    return listener, client, server


def test_ring_pool_recycles_pairs(monkeypatch):
    ref_native.load()
    port_native.load()  # and the port's, outside deadlines too

    def scenario(pkg):
        listener, client, server = _listener(pkg, monkeypatch, "RDMA_BPEV")
        key = client.pool_key
        client.close()
        server.close()
        listener.close()
        return pkg.poller.PairPool.get().idle_count(key)

    assert both(scenario) == 1


# ---------------------------------------------------------------------------
# burst accepts and admission pushback
# ---------------------------------------------------------------------------

def _burst(pkg, n, admission=None, admitted=True):
    """``n`` connections queued in the backlog before the listener starts
    accepting: the endpoints accepted, the sockets the listener closed
    unread (a shed connection's client reads EOF), and the port listener's
    shed count and largest burst (None on the reference)."""
    ready = threading.Event()
    accepted: "queue.Queue" = queue.Queue()
    kw = {} if admission is None else {"admission": admission}
    listener = pkg.ep.EndpointListener("127.0.0.1", 0, accepted.put,
                                       ready=ready, **kw)
    socks = [socket.create_connection(("127.0.0.1", listener.port),
                                      timeout=10) for _ in range(n)]
    try:
        ready.set()
        eps = []
        deadline = time.monotonic() + 10
        while admitted and len(eps) < n and time.monotonic() < deadline:
            try:
                eps.append(accepted.get(timeout=0.5))
            except queue.Empty:
                pass
        closed = 0
        if not admitted:
            for s in socks:
                s.settimeout(10)
                try:
                    closed += s.recv(1) == b""
                except OSError:
                    closed += 1
        for ep in eps:
            ep.close()
        return (len(eps), closed, getattr(listener, "shed", None),
                getattr(listener, "max_burst", None))
    finally:
        for s in socks:
            s.close()
        listener.close()


def test_burst_accept_takes_the_backlog_in_one_wakeup(monkeypatch):
    """16 queued connections: both packages accept all; the port's
    listener took them in bursts of up to ``accept_burst`` (4 here)."""
    monkeypatch.setenv("TPURPC_ACCEPT_BURST", "4")
    _reset_config()
    got = {pkg.name: _burst(pkg, 16) for pkg in PKGS}
    assert got["ref"][:2] == got["port"][:2] == (16, 0)
    _, _, shed, max_burst = got["port"]
    assert shed == 0 and 1 <= max_burst <= 4


def test_admission_probe_sheds_before_any_handshake():
    """A probe that pushes back closes every accepted socket before the
    bootstrap (no endpoint is made), in both packages."""
    got = {pkg.name: _burst(pkg, 6, admission=lambda: 100, admitted=False)
           for pkg in PKGS}
    assert got["ref"][:2] == got["port"][:2] == (0, 6)
    assert got["port"][2] == 6


def test_broken_admission_probe_never_sheds():
    def broken():
        raise RuntimeError("probe bug")

    got = {pkg.name: _burst(pkg, 3, admission=broken) for pkg in PKGS}
    assert got["ref"][:2] == got["port"][:2] == (3, 0)
    assert got["port"][2] == 0


def _gate_probe(pkg):
    import importlib

    gate = importlib.import_module(
        pkg.rpc.__name__ + ".server").AdmissionGate
    g = gate(2, soft_limit=1)
    out = [g.connection_pushback_ms()]
    for _ in range(3):
        out.append(g.try_admit())
        out.append(g.connection_pushback_ms())
    g.release()
    out.append(g.connection_pushback_ms())
    return out


def test_gate_connection_pushback_only_at_saturation():
    got = both(_gate_probe)
    # nothing shed below max_inflight; at it, new connections are, and a
    # release reopens the accept path
    assert got[:4] == [None, None, None, None]
    assert got[5] is not None and got[6] is not None and got[7] is None


@pytest.mark.parametrize("raw, want", [
    (None, None), ("", None), ("junk", None), ("0", None), ("3", (3, None)),
])
def test_admission_gate_from_env(monkeypatch, raw, want):
    import importlib

    if raw is None:
        monkeypatch.delenv("TPURPC_ADMISSION_MAX_INFLIGHT", raising=False)
    else:
        monkeypatch.setenv("TPURPC_ADMISSION_MAX_INFLIGHT", raw)
    monkeypatch.delenv("TPURPC_ADMISSION_SLO_MS", raising=False)
    for root in ("tpurpc", "tpurpc_torch"):
        gate = importlib.import_module(f"{root}.rpc.server").AdmissionGate
        g = gate.from_env()
        assert (None if g is None else (g.max_inflight, g.latency_slo_ms)) \
            == want, root


# ---------------------------------------------------------------------------
# test_limits.py's twins
# ---------------------------------------------------------------------------

def _limits_server(pkg, **kw):
    srv = pkg.rpc.Server(max_workers=4, **kw)
    srv.add_method("/t.S/Echo",
                   pkg.rpc.unary_unary_rpc_method_handler(lambda req, ctx: req))

    def count(req_iter, ctx):
        n = 0
        for _ in req_iter:
            n += 1
        return str(n).encode()

    srv.add_method("/t.S/Count",
                   pkg.rpc.stream_unary_rpc_method_handler(count))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _err(pkg, fn):
    try:
        return ("ok", bytes(fn()))
    except pkg.rpc.RpcError as exc:
        return ("error", exc.code().name, exc.details())


def _oversized_unary(pkg):
    srv, port = _limits_server(pkg, max_receive_message_length=64 << 10)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary("/t.S/Echo")
            big = _err(pkg, lambda: mc(b"x" * (1 << 20), timeout=20))
            return big[:2], "larger than max" in big[2], _err(
                pkg, lambda: mc(b"small", timeout=20))
    finally:
        srv.stop(grace=0)


def test_oversized_unary_rejected_cleanly():
    assert both(_oversized_unary) == (("error", "RESOURCE_EXHAUSTED"), True,
                                      ("ok", b"small"))


def _oversized_stream(pkg):
    srv, port = _limits_server(pkg, max_receive_message_length=64 << 10)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.stream_unary("/t.S/Count")
            msgs = [b"ok1", b"y" * (1 << 20), b"ok2"]
            first = _err(pkg, lambda: mc(iter(msgs), timeout=20))
            return first[:2], _err(
                pkg, lambda: ch.unary_unary("/t.S/Echo")(b"z", timeout=20))
    finally:
        srv.stop(grace=0)


def test_oversized_mid_stream_aborts_stream_only():
    assert both(_oversized_stream) == (("error", "RESOURCE_EXHAUSTED"),
                                       ("ok", b"z"))


def _oversized_reply(pkg):
    srv, port = _limits_server(pkg)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}",
                             max_receive_message_length=32 << 10) as ch:
            mc = ch.unary_unary("/t.S/Echo")
            return _err(pkg, lambda: mc(b"q" * (256 << 10), timeout=20))[:2]
    finally:
        srv.stop(grace=0)


def test_oversized_response_rejected_client_side():
    assert both(_oversized_reply) == ("error", "RESOURCE_EXHAUSTED")


def _env_knob(pkg):
    srv, port = _limits_server(pkg)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            return _err(pkg, lambda: ch.unary_unary("/t.S/Echo")(
                b"e" * (64 << 10), timeout=20))[:2]
    finally:
        srv.stop(grace=0)


def test_env_knob_applies(monkeypatch):
    monkeypatch.setenv("TPURPC_MAX_RECV_MESSAGE_LENGTH", str(16 << 10))
    _reset_config()
    assert both(_env_knob) == ("error", "RESOURCE_EXHAUSTED")


def _backpressure(pkg):
    consumed = []
    first = threading.Event()
    release = threading.Event()

    def slow_count(req_iter, ctx):
        for item in req_iter:
            consumed.append(len(bytes(item)))
            if len(consumed) == 1:
                first.set()
                release.wait(timeout=30)  # park after the first message
        return str(len(consumed)).encode()

    srv = pkg.rpc.Server(max_workers=4)
    srv.add_method("/t.S/Slow",
                   pkg.rpc.stream_unary_rpc_method_handler(slow_count))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    sent = [0]
    result = [None]
    n_msgs, msg = 64, b"b" * (1 << 20)  # 64 x 1 MiB

    def gen():
        for _ in range(n_msgs):
            sent[0] += 1
            yield msg

    def call():
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            result[0] = bytes(ch.stream_unary("/t.S/Slow")(gen(), timeout=60))

    t = threading.Thread(target=call)
    t.start()
    try:
        assert first.wait(30)
        # the sender runs against the parked handler until the transport
        # stalls it: wait until the count stops moving (bounded)
        last, deadline = -1, time.monotonic() + 10
        while sent[0] != last and time.monotonic() < deadline:
            last = sent[0]
            time.sleep(0.5)
        bounded = sent[0] < n_msgs
    finally:
        release.set()
        t.join(timeout=60)
        srv.stop(grace=0)
    return bounded, result[0]


def test_slow_reader_backpressures_fast_sender(monkeypatch):
    monkeypatch.setenv("TPURPC_STREAM_QUEUE_DEPTH", "4")
    _reset_config()
    assert both(_backpressure) == (True, b"64")


def test_pair_pool_per_key_bound_below_total():
    for pkg in PKGS:
        pool = pkg.poller.PairPool(max_idle_total=128)
        assert (pool.max_idle_total, pool.max_idle_per_key) == (128, 32)
        pool.drain()
        pool = pkg.poller.PairPool(max_idle_total=128, max_idle_per_key=8)
        assert pool.max_idle_per_key == 8
        pool.drain()
