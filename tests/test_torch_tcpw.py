"""``tcp_window``: the port's cross-host one-sided ring domain over sockets
(``tpurpc_torch/core/tcpw.py``), against the reference's.

Twins of ``tests/test_tcpw.py``: the same pair, ring and credit protocol
that runs over /dev/shm runs over an ordered record socket, in one process
and across processes (spawned, never forked: the child imports torch), the
record stream is authenticated per region, stale and out-of-bounds writes
are dropped, and ``GRPC_PLATFORM_TYPE=TPU`` with
``TPURPC_RING_DOMAIN=tcp_window`` lands another process's tensors in the
server's device ring (on the CPU here). Also the port twin of
``test_tls.py::test_tls_e2e_over_tcp_window_domain``, the record wire
across packages, and a rendezvous landing whose COMPLETE stays framed.

Each package has its own record server; no test stops either one. The
records carry tensor bytes in plaintext (an HMAC guards them), even under
TLS, so every record server this file starts, in this process or a child,
listens on the loopback only (``TPURPC_TCPW_BIND``). Cross-process cases
take ``torch_ranks``' launch lock, and their children run at
``os.nice(10)``.
"""

import contextlib
import os
import selectors
import socket
import subprocess
import sys
import threading
import time

import pytest

import torch_ranks
from tpurpc.core import tcpw as ref_tcpw
from tpurpc.utils import config as ref_config
from tpurpc_torch.core import pair as P
from tpurpc_torch.core import tcpw as T
from tpurpc_torch.core.pair import Pair
from tpurpc_torch.core.poller import wait_readable
from tpurpc_torch.core.tcpw import TcpWindowDomain, _PeerLink, _RecordServer
from tpurpc_torch.utils import config as torch_config
from torch_call_plane import PORT, platform  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def loopback_records(monkeypatch):
    """Record servers started by this file bind the loopback only."""
    monkeypatch.setenv("TPURPC_TCPW_BIND", "127.0.0.1")
    ref_config.set_config(None)
    torch_config.set_config(None)
    yield
    ref_config.set_config(None)
    torch_config.set_config(None)


def _loopback(ring_size, domain):
    """Two connected pairs in this process over a socketpair."""
    a, b = Pair(domain, ring_size), Pair(domain, ring_size)
    a.init()
    b.init()
    sa, sb = socket.socketpair()
    err = []

    def side():
        try:
            b.connect_over_socket(sb)
        except BaseException as exc:
            err.append(exc)

    t = threading.Thread(target=side, daemon=True)
    t.start()
    a.connect_over_socket(sa)
    t.join(10)
    if err:
        raise err[0]
    return a, b


def _recv(pair) -> bytes:
    buf = bytearray(1 << 16)
    n = pair.recv_into(buf)
    return bytes(buf[:n])


def test_tcpw_lazy_registration_and_config(monkeypatch):
    """``make_domain("tcp_window")`` imports and registers the domain on
    first use; the advertised host comes from ``TPURPC_TCPW_HOST``."""
    assert "tcp_window" in P._LAZY_DOMAINS
    dom = P.make_domain("tcp_window")
    assert isinstance(dom, TcpWindowDomain) and dom.kind == "tcp_window"
    monkeypatch.setenv("TPURPC_TCPW_HOST", "10.1.2.3")
    monkeypatch.setenv("TPURPC_TCPW_BIND", "127.0.0.1")
    torch_config.set_config(None)
    try:
        cfg = torch_config.get_config()
        assert (cfg.tcpw_host, cfg.tcpw_bind) == ("10.1.2.3", "127.0.0.1")
        region = dom.alloc(64)
        try:
            assert region.handle.startswith("tcpw:10.1.2.3:")
        finally:
            region.close()
    finally:
        torch_config.set_config(None)


def test_tcpw_same_process_roundtrip():
    a, b = _loopback(4096, TcpWindowDomain())
    try:
        a.send([b"over the record socket"])
        assert wait_readable(b, timeout=10, discipline="event")
        assert _recv(b) == b"over the record socket"
        b.send([b"back"])
        assert wait_readable(a, timeout=10, discipline="event")
        assert _recv(a) == b"back"
    finally:
        a.destroy()
        b.destroy()


def test_tcpw_large_messages_wrap_and_credits():
    """Messages larger than the ring force wrap-split writes, partial sends
    and credit returns, all riding the record stream's order."""
    a, b = _loopback(4096, TcpWindowDomain())
    try:
        payload = bytes(range(256)) * 64  # 16 KiB through a 4 KiB ring
        done = threading.Event()

        def pump():
            sent = 0
            while sent < len(payload):
                n = a.send([payload], sent)
                sent += n
                if n == 0:
                    time.sleep(0.002)  # credits in flight
            done.set()

        threading.Thread(target=pump, daemon=True).start()
        got = b""
        deadline = time.monotonic() + 20
        while len(got) < len(payload) and time.monotonic() < deadline:
            if wait_readable(b, timeout=5, discipline="event"):
                got += _recv(b)
        assert got == payload
        assert done.wait(5)
    finally:
        a.destroy()
        b.destroy()


def _landed(region, want: bytes, at: int = 0) -> bool:
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if bytes(region.buf[at:at + len(want)]) == want:
            return True
        time.sleep(0.01)
    return False


def test_tcpw_stale_write_discarded():
    """A write racing its region's teardown is dropped, never applied to
    freed memory and never a crash."""
    dom = TcpWindowDomain()
    region = dom.alloc(1024)
    win = dom.open_window(region.handle, 1024)
    win.write(0, b"live")
    assert _landed(region, b"live")
    region.close()  # unregisters the key
    win.write(0, b"dead")  # discarded by the applier
    time.sleep(0.2)
    win.close()


def test_tcpw_out_of_bounds_write_discarded():
    dom = TcpWindowDomain()
    region = dom.alloc(64)
    win = dom.open_window(region.handle, 64)
    win.write(60, b"0123456789")  # runs past the region: dropped whole
    win.write(0, b"ok")
    assert _landed(region, b"ok")
    assert bytes(region.buf[60:]) == b"\0\0\0\0"
    win.close()
    region.close()


def test_tcpw_windows_share_one_ordered_link():
    """All windows to one peer process share one connection, so a data
    write and a later credit write are never observed reordered."""
    dom = TcpWindowDomain()
    r1, r2 = dom.alloc(128), dom.alloc(128)
    w1 = dom.open_window(r1.handle, 128)
    w2 = dom.open_window(r2.handle, 128)
    server = _RecordServer.get()
    with _PeerLink._links_lock:
        keys = {k for k in _PeerLink._links if k[1] == server.port}
    assert len(keys) == 1
    for i in range(50):
        w1.write(0, bytes([i]))
        w2.write(0, bytes([i]))
    deadline = time.monotonic() + 5
    while (r1.buf[0], r2.buf[0]) != (49, 49) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert (r1.buf[0], r2.buf[0]) == (49, 49)
    for x in (w1, w2, r1, r2):
        x.close()


def test_tcpw_domain_mismatch_rejected():
    """A tcp_window peer meeting an shm peer fails at bootstrap."""
    a = Pair(TcpWindowDomain(), ring_size=4096)
    b = Pair(P.ShmDomain(), ring_size=4096)
    a.init()
    b.init()
    sa, sb = socket.socketpair()
    errs = []

    def side(pair, sock):
        try:
            pair.connect_over_socket(sock)
        except ValueError as exc:
            errs.append(str(exc))

    t = threading.Thread(target=side, args=(b, sb), daemon=True)
    t.start()
    side(a, sa)
    t.join(10)
    a.destroy()
    b.destroy()
    assert any("domain mismatch" in e for e in errs)


@pytest.mark.parametrize("writer,owner", [("port", "ref"), ("ref", "port")])
def test_tcpw_record_wire_across_packages(writer, owner):
    """The record wire is the reference's: a window of one package lands
    bytes in a region of the other's record server, and a record under the
    wrong secret does not."""
    doms = {"ref": ref_tcpw.TcpWindowDomain(), "port": TcpWindowDomain()}
    region = doms[owner].alloc(256)
    win = doms[writer].open_window(region.handle, 256)
    try:
        win.write(8, b"crossing")
        assert _landed(region, b"crossing", at=8)
        host, port, key_hex, _secret = region.handle[5:].rsplit(":", 3)
        bad = doms[writer].open_window(
            f"tcpw:{host}:{port}:{key_hex}:{'00' * 32}", 256)
        try:
            bad.write(100, b"forged")
        except OSError:
            pass  # the applier may already have dropped the shared link
        time.sleep(0.2)
        assert bytes(region.buf[100:106]) == b"\0" * 6
        bad.close()
    finally:
        win.close()
        region.close()
    assert T._REC.format == ref_tcpw._REC.format
    assert (T._HELLO, T._MAC_LEN) == (ref_tcpw._HELLO, ref_tcpw._MAC_LEN)


def test_forged_records_cannot_land_bytes():
    """Write authorization is the per-region HMAC secret, which travels
    only inside the handle: a forger who knows everything on the wire
    short of it cannot land a byte."""
    dom = TcpWindowDomain()
    region = dom.alloc(256)
    _, _, key_hex, _secret_hex = region.handle[5:].rsplit(":", 3)
    key = bytes.fromhex(key_hex)
    server = _RecordServer.get()

    def forge(records, hello=T._HELLO):
        s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
        try:
            try:
                s.sendall(hello)
                for rec in records:
                    s.sendall(rec)
            except (BrokenPipeError, ConnectionResetError):
                return b""
            s.settimeout(5)
            try:
                return s.recv(1)
            except socket.timeout:
                return b"open"
            except ConnectionResetError:
                return b""
        finally:
            s.close()

    payload = b"A" * 32
    hdr = T._REC.pack(key, 0, len(payload))
    assert forge([hdr + b"\x00" * T._MAC_LEN + payload]) == b""
    bad = T._record_mac(b"x" * 32, hdr, payload)
    assert forge([hdr + bad + payload]) == b""
    assert forge([b"\xde\xad" * 40], hello=b"XXXX") == b""
    big_hdr = T._REC.pack(key, 0, 1024)
    assert forge([big_hdr + b"\x00" * T._MAC_LEN + b"B" * 1024]) == b"open"
    flood = [T._REC.pack(os.urandom(16), 0, 4) + b"\x00" * T._MAC_LEN
             + b"XXXX" for _ in range(1100)]
    assert forge(flood) == b""
    time.sleep(0.1)
    assert bytes(region.buf) == b"\0" * 256, "forged bytes landed"
    win = dom.open_window(region.handle, 256)
    win.write(0, b"legit")
    assert _landed(region, b"legit")
    win.close()
    region.close()


# ---------------------------------------------------------------------------
# in one process, over the RPC stack
# ---------------------------------------------------------------------------

def test_rendezvous_over_tcpw_frames_its_complete(platform):
    """1 MiB each way on RDMA_BPEV over tcp_window: both payloads land one
    sided in tcp_window regions, and each COMPLETE rides the framed path,
    which the shared record stream orders after the bytes."""
    platform("RDMA_BPEV", TPURPC_RING_DOMAIN="tcp_window",
             TPURPC_RING_BUFFER_SIZE_KB="256")
    srv = PORT.server.Server(max_workers=4)
    srv.add_method("/x.S/Echo", PORT.server.unary_unary_rpc_method_handler(
        lambda req, ctx: bytes(req)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    big = bytes(range(256)) * 4096
    try:
        with PORT.channel.Channel(f"127.0.0.1:{port}") as ch:
            echo = ch.unary_unary("/x.S/Echo")
            assert echo(b"warm", timeout=30) == b"warm"
            link = ch._conn.rdv
            assert link._pool_kinds[0] == "tcp_window"
            before = link.stats()
            assert echo(big, timeout=60) == big
            after = link.stats()
            srv_link = srv._connections[0].rdv
    finally:
        srv.stop(grace=1)
    assert after["sent"] - before["sent"] == 1
    assert after["received"] - before["received"] == 1
    # the request's COMPLETE: framed, though the rings are armed
    assert after["ctrl_frames"] - before["ctrl_frames"] >= 1
    assert srv_link.stats()["sent"] >= 1


def test_tls_e2e_over_tcp_window_domain(platform):
    """TLS with the cross-host ring domain: the bootstrap and notify socket
    are encrypted, the one-sided record stream is a separate plaintext
    connection (the domain's documented boundary)."""
    from torch_tls import make_pki

    certs = make_pki.load()
    platform("RDMA_BPEV", TPURPC_RING_DOMAIN="tcp_window",
             TPURPC_RING_BUFFER_SIZE_KB="256")
    rpc = PORT.rpc
    srv = PORT.server.Server(max_workers=4)
    srv.add_method("/t.S/Echo", PORT.server.unary_unary_rpc_method_handler(
        lambda req, ctx: bytes(req)))
    creds = rpc.ssl_server_credentials([(certs["srv_key"],
                                         certs["srv_cert"])])
    port = srv.add_secure_port("127.0.0.1:0", creds)
    srv.start()
    try:
        cc = rpc.ssl_channel_credentials(root_certificates=certs["ca"])
        with rpc.secure_channel(f"localhost:{port}", cc) as ch:
            mc = ch.unary_unary("/t.S/Echo")
            assert bytes(mc(b"secure-tcpw", timeout=20)) == b"secure-tcpw"
            big = bytes(range(256)) * 4096  # 1 MiB: wraps and credits
            assert bytes(mc(big, timeout=60)) == big
            pair = ch._conn.endpoint.pair
            assert pair.domain.kind == "tcp_window"
            assert hasattr(pair.notify_sock, "pending")  # an SSLSocket
    finally:
        srv.stop(grace=0)


# ---------------------------------------------------------------------------
# across processes (spawned children, under the launch lock)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _launch_lock():
    fd = torch_ranks._lock()
    try:
        yield
    finally:
        torch_ranks._unlock(fd)


_PRELUDE = r"""
import os, sys
os.nice(10)
sys.path.insert(0, {repo!r})
"""


def _env(**kw):
    env = dict(os.environ, TPURPC_TORCH_DEVICE="cpu", **kw)
    env.pop("JAX_PLATFORMS", None)
    return env


def _script(body: str) -> str:
    return _PRELUDE.format(repo=REPO) + body


def _run_cross_process(server_src: str, client_src: str, env: dict,
                       client_timeout: float = 120) -> str:
    """Spawn the server script, read its port (bounded), run the client
    script against it, kill the server; the client's stdout."""
    with _launch_lock():
        srv = subprocess.Popen([sys.executable, "-c", _script(server_src)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True, env=env)
        try:
            sel = selectors.DefaultSelector()
            sel.register(srv.stdout, selectors.EVENT_READ)
            if not sel.select(timeout=120):
                srv.kill()
                raise AssertionError("server never printed its port: "
                                     + srv.stderr.read()[:2000])
            port = srv.stdout.readline().strip()
            if not port.isdigit():
                srv.kill()
                raise AssertionError(f"bad port line {port!r}: "
                                     + srv.stderr.read()[:2000])
            cli = subprocess.run(
                [sys.executable, "-c", _script(client_src), port],
                capture_output=True, text=True, env=env,
                timeout=client_timeout)
            assert cli.returncode == 0, cli.stderr[-3000:]
            assert "CLIENT_OK" in cli.stdout
            return cli.stdout
        finally:
            srv.kill()
            srv.wait()


_ECHO_PAIR_SERVER = r"""
import socket
from tpurpc_torch.core.pair import Pair, PairState
from tpurpc_torch.core.poller import wait_readable
from tpurpc_torch.core.tcpw import TcpWindowDomain

lst = socket.socket()
lst.bind(("127.0.0.1", 0))
lst.listen(1)
print(lst.getsockname()[1], flush=True)
sock, _ = lst.accept()
pair = Pair(TcpWindowDomain(), ring_size=8192)
pair.init()
pair.connect_over_socket(sock)
buf = bytearray(1 << 16)
echoed = 0
while echoed < 3:
    if wait_readable(pair, timeout=10, discipline="event"):
        n = pair.recv_into(buf)
        if n:
            pair.send([b"echo:", bytes(buf[:n])])
            echoed += 1
        elif pair.get_status() is not PairState.CONNECTED:
            break
pair.disconnect()
pair.destroy()
"""

_ECHO_PAIR_CLIENT = r"""
import socket, time
from tpurpc_torch.core.pair import Pair
from tpurpc_torch.core.poller import wait_readable
from tpurpc_torch.core.tcpw import TcpWindowDomain

sock = socket.create_connection(("127.0.0.1", int(sys.argv[1])))
pair = Pair(TcpWindowDomain(), ring_size=8192)
pair.init()
pair.connect_over_socket(sock)
buf = bytearray(1 << 16)
for i in range(3):
    msg = f"msg-{i}".encode() * (i + 1)
    pair.send([msg])
    got = b""
    deadline = time.monotonic() + 10
    while len(got) < len(msg) + 5 and time.monotonic() < deadline:
        if wait_readable(pair, timeout=5, discipline="event"):
            got += bytes(buf[:pair.recv_into(buf)])
    assert got == b"echo:" + msg, got
pair.destroy()
print("CLIENT_OK", flush=True)
"""


def test_tcpw_cross_process_echo():
    """Two processes, no shared memory: each ring lives in its process's
    heap, and every one-sided write crosses a real socket."""
    _run_cross_process(_ECHO_PAIR_SERVER, _ECHO_PAIR_CLIENT, _env())


_RPC_SERVER = r"""
import tpurpc_torch.rpc as rpc
from tpurpc_torch.utils.config import get_config

assert get_config().ring_domain == "tcp_window", get_config().ring_domain
srv = rpc.Server(max_workers=4)
srv.add_method("/x.S/Echo", rpc.unary_unary_rpc_method_handler(
    lambda req, ctx: bytes(req) + b"/tcpw"))
port = srv.add_insecure_port("127.0.0.1:0")
srv.start()
print(port, flush=True)
srv.wait_for_termination(timeout=120)
"""

_RPC_CLIENT = r"""
import tpurpc_torch.rpc as rpc
from tpurpc_torch.utils.config import get_config

assert get_config().ring_domain == "tcp_window"
with rpc.insecure_channel(f"127.0.0.1:{sys.argv[1]}") as ch:
    echo = ch.unary_unary("/x.S/Echo")
    for i in range(5):
        assert echo(b"m%d" % i, timeout=30) == b"m%d/tcpw" % i
    big = bytes(range(256)) * 4096  # 1 MiB: chunking and credits
    assert echo(big, timeout=60) == big + b"/tcpw"
print("CLIENT_OK", flush=True)
"""


def test_tcpw_full_rpc_cross_process():
    """Unmodified RPC apps between processes, selected by the environment
    alone (RDMA_BP + TPURPC_RING_DOMAIN=tcp_window)."""
    _run_cross_process(_RPC_SERVER, _RPC_CLIENT, _env(
        GRPC_PLATFORM_TYPE="RDMA_BP", TPURPC_RING_DOMAIN="tcp_window",
        GRPC_RDMA_RING_BUFFER_SIZE_KB="256"))


_QPS = r"""
import json, threading, time
import tpurpc_torch.rpc as rpc
from tpurpc_torch.utils.config import get_config

assert get_config().ring_domain == "tcp_window"
srv = rpc.Server(max_workers=4)
srv.add_method("/q.S/Ping", rpc.unary_unary_rpc_method_handler(
    lambda req, ctx: bytes(req)))
port = srv.add_insecure_port("127.0.0.1:0")
srv.start()
counts = []

def client():
    n = 0
    with rpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        ping = ch.unary_unary("/q.S/Ping")
        end = time.monotonic() + 1.5
        while time.monotonic() < end:
            assert ping(b"x" * 64, timeout=30) == b"x" * 64
            n += 1
    counts.append(n)

ts = [threading.Thread(target=client) for _ in range(2)]
t0 = time.monotonic()
for t in ts:
    t.start()
for t in ts:
    t.join(60)
dt = time.monotonic() - t0
srv.stop(grace=0)
print(json.dumps({"rpcs": sum(counts), "rate": sum(counts) / dt}))
"""


def test_tcpw_qps_scenario():
    """Two closed-loop clients of 64-byte unary calls for 1.5 s over the
    tcp_window ring platform (the reference runs its qps rig here)."""
    import json

    with _launch_lock():
        out = subprocess.run(
            [sys.executable, "-c", _script(_QPS)], capture_output=True,
            text=True, timeout=180,
            env=_env(GRPC_PLATFORM_TYPE="RDMA_BP",
                     TPURPC_RING_DOMAIN="tcp_window",
                     GRPC_RDMA_RING_BUFFER_SIZE_KB="256"))
    assert out.returncode == 0, out.stderr[-3000:]
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["rpcs"] > 20 and stats["rate"] > 0


_TPU_SERVER = r"""
import numpy as np
import tpurpc_torch.rpc as rpc
from tpurpc_torch.torchshim.service import add_tensor_method
from tpurpc_torch.utils.config import get_config

assert get_config().ring_domain == "tcp_window", get_config().ring_domain

def fn(tree):
    x = tree["x"]
    rings = [c.endpoint.device_ring for c in list(srv._connections)]
    # the request's tensor is a view of its connection's device ring
    ptrs = {r.buf.untyped_storage().data_ptr() for r in rings}
    return {"y": x * 3,
            "ring": np.int64(x.untyped_storage().data_ptr() in ptrs),
            "placed": np.int64(max(r.stats()["head"] for r in rings))}

srv = rpc.Server(max_workers=4)
add_tensor_method(srv, "Call", fn, device=True)
port = srv.add_insecure_port("127.0.0.1:0")
srv.start()
print(port, flush=True)
srv.wait_for_termination(timeout=120)
"""

_TPU_CLIENT = r"""
import numpy as np
import torch
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.torchshim.service import TensorClient
from tpurpc_torch.utils.config import get_config

assert get_config().ring_domain == "tcp_window"
with Channel(f"127.0.0.1:{sys.argv[1]}") as ch:
    cli = TensorClient(ch)
    for k in range(3):
        x = torch.arange(2048 * (k + 1), dtype=torch.float32).reshape(64, -1)
        out = cli.call("Call", {"x": x}, timeout=60)
        assert torch.equal(torch.as_tensor(out["y"]), x * 3)
        assert int(out["ring"]) == 1
    # the three requests' tensors were placed into the device ring
    assert int(out["placed"]) >= 3 * 2048 * 4, int(out["placed"])
print("CLIENT_OK", flush=True)
"""


def test_tpu_platform_over_tcpw_cross_process():
    """GRPC_PLATFORM_TYPE=TPU (payloads land in the receiver's device ring)
    with TPURPC_RING_DOMAIN=tcp_window (the one-sided ring between
    processes): tensor bytes from another process land in the device ring
    by the environment alone."""
    _run_cross_process(_TPU_SERVER, _TPU_CLIENT, _env(
        GRPC_PLATFORM_TYPE="TPU", TPURPC_RING_DOMAIN="tcp_window",
        GRPC_RDMA_RING_BUFFER_SIZE_KB="1024",
        TPURPC_HBM_RING_SIZE_KB="1024"), client_timeout=240)
