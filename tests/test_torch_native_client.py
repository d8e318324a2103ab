"""Twins of ``test_native_client.py``: the C core's client binding
(``rpc/native_client.py``) across the packages.

Every case runs its scenario on a cross pair, the port's ``NativeChannel``
against a reference ``Server`` and the reference's ``NativeChannel``
against a port ``Server``, and holds the observation (replies, status
codes by name, details) against the reference pair's. Served on TCP by
the Python plane, as the reference's cases are; the ring cases run in a
child process (the platform is read once per process), each package's
server adopting the ring connection onto its own library.
"""

import concurrent.futures as cf
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import pytest

from torch_native import DIR_IDS, DIRS, code_name, on_platform, twin  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: each package's C sources and public headers
SRC = {"ref": os.path.join(REPO, "native"),
       "port": os.path.join(REPO, "tpurpc_torch", "native")}


@pytest.fixture(autouse=True)
def _tcp(on_platform):  # noqa: F811
    on_platform("TCP")


def _py_server(S):
    rpc = S.rpc
    srv = rpc.Server(max_workers=4)
    srv.add_method("/n.S/Echo",
                   rpc.unary_unary_rpc_method_handler(lambda r, c: bytes(r)))

    def double_each(req_iter, ctx):
        for m in req_iter:
            yield bytes(m) * 2

    srv.add_method("/n.S/Dbl", rpc.stream_stream_rpc_method_handler(
        double_each))

    def fail(r, c):
        c.abort(S.status.StatusCode.FAILED_PRECONDITION, "nope")

    srv.add_method("/n.S/Fail", rpc.unary_unary_rpc_method_handler(fail))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _hang_server(S, release):
    srv = S.rpc.Server(max_workers=2)
    srv.add_method("/n.S/Hang", S.rpc.unary_unary_rpc_method_handler(
        lambda r, c: release.wait(30) or b"late"))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _served(scenario):
    """A scenario body ``fn(C, ch)`` over a NativeChannel of ``C`` to the
    standard Python server of ``S``."""
    def run(C, S):
        srv, port = _py_server(S)
        try:
            with C.NativeChannel("127.0.0.1", port) as ch:
                return scenario(C, ch)
        finally:
            srv.stop(grace=0)
    return run


@_served
def _unary_and_ping(C, ch):
    echo = ch.unary_unary("/n.S/Echo")
    big = bytes(range(256)) * 8192  # 2 MiB: frame fragmentation
    return ch.ping(5) < 5, echo(b"hi", timeout=10), echo(big, timeout=30) == big


@_served
def _serializers(C, ch):
    echo = ch.unary_unary("/n.S/Echo",
                          request_serializer=lambda s: s.encode(),
                          response_deserializer=lambda b: b.decode())
    return echo("text", timeout=10)


@_served
def _status_mapping(C, ch):
    out = []
    for path in ("/n.S/Fail", "/n.S/Missing"):
        with pytest.raises(C.status.RpcError) as ei:
            ch.unary_unary(path)(b"", timeout=10)
        code, details = code_name(ei.value)
        out.append((code, "nope" in details))
    return out


@_served
def _streaming(C, ch):
    return list(ch.stream_stream("/n.S/Dbl")(iter([b"a", b"bb", b"ccc"]),
                                              timeout=10))


@_served
def _futures_pipelined(C, ch):
    echo = ch.unary_unary("/n.S/Echo")
    futs = [echo.future(b"m%d" % i, timeout=30) for i in range(64)]
    return [f.result(timeout=30) for f in futs]


@_served
def _future_error_and_deserializer(C, ch):
    with pytest.raises(C.status.RpcError) as ei:
        ch.unary_unary("/n.S/Fail").future(b"x", timeout=10).result(
            timeout=30)
    echo = ch.unary_unary("/n.S/Echo",
                          request_serializer=lambda s: s.encode(),
                          response_deserializer=lambda b: b.decode())
    return code_name(ei.value), echo.future("hi", timeout=10).result(
        timeout=30)


def _future_deadline(C, S):
    release = threading.Event()
    srv, port = _hang_server(S, release)
    try:
        with C.NativeChannel("127.0.0.1", port) as ch:
            with pytest.raises(C.status.RpcError) as ei:
                ch.unary_unary("/n.S/Hang").future(
                    b"x", timeout=0.3).result(timeout=30)
            return ei.value.code().name
    finally:
        release.set()
        srv.stop(grace=0)


@_served
def _future_user_cancel(C, ch):
    echo = ch.unary_unary("/n.S/Echo")
    f1 = echo.future(b"one", timeout=10)
    f1.cancel()  # may or may not win against the in-flight completion
    return [echo.future(b"n%d" % i, timeout=10).result(30) for i in range(8)]


def _futures_closed_while_inflight(C, S):
    release = threading.Event()
    srv, port = _hang_server(S, release)
    try:
        ch = C.NativeChannel("127.0.0.1", port)
        hang = ch.unary_unary("/n.S/Hang")
        futs = [hang.future(b"x", timeout=20) for _ in range(4)]
        time.sleep(0.2)  # the calls reach the server
        ch.close()
        raised = 0
        for f in futs:
            with pytest.raises(C.status.RpcError):
                f.result(timeout=10)
            raised += 1
        return raised
    finally:
        release.set()
        srv.stop(grace=0)


def _futures_survive_server_death(C, S):
    srv = S.rpc.Server(max_workers=4)
    srv.add_method("/n.S/Echo", S.rpc.unary_unary_rpc_method_handler(
        lambda r, c: bytes(r)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    ch = C.NativeChannel("127.0.0.1", port)
    try:
        echo = ch.unary_unary("/n.S/Echo")
        futs = [echo.future(b"x" * 512, timeout=20) for _ in range(32)]
        srv.stop(grace=0)  # yank the server mid-batch
        done, not_done = cf.wait(futs, timeout=45)
        outcomes = set()
        for f in done:
            try:
                outcomes.add(f.result() == b"x" * 512)
            except C.status.RpcError:
                outcomes.add("error")
        hung = len(not_done)
    finally:
        ch.close()
        srv.stop(grace=0)
    # the world keeps turning: a new server and channel round-trip
    srv2 = S.rpc.Server(max_workers=2)
    srv2.add_method("/n.S/Echo", S.rpc.unary_unary_rpc_method_handler(
        lambda r, c: bytes(r)))
    port2 = srv2.add_insecure_port("127.0.0.1:0")
    srv2.start()
    try:
        with C.NativeChannel("127.0.0.1", port2) as ch2:
            after = ch2.unary_unary("/n.S/Echo")(b"hi", timeout=10)
    finally:
        srv2.stop(grace=0)
    # every future resolved: a late success or an error, never a hang
    return hung, outcomes <= {True, "error"}, after


def _child(C, S, body: str, env: dict) -> str:
    """``body`` in a fresh interpreter with ``srv_rpc`` (the server
    package's rpc) and ``NativeChannel`` (the client package's) bound;
    returns its stdout."""
    roots = {"ref": "tpurpc", "port": "tpurpc_torch"}
    code = (f"import {roots[S.name]}.rpc as srv_rpc\n"
            f"from {roots[C.name]}.rpc.native_client import NativeChannel\n"
            + body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, **env), timeout=180,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


_RING_BODY = """\
srv = srv_rpc.Server(max_workers=4)
srv.add_method('/n.S/Echo',
               srv_rpc.unary_unary_rpc_method_handler(lambda r, c: bytes(r)))
port = srv.add_insecure_port('127.0.0.1:0')
srv.start()
adopted = srv._native_dp is not None
with NativeChannel('127.0.0.1', port) as ch:
    echo = ch.unary_unary('/n.S/Echo')
    small = echo(b'ring', timeout=20)
    big = bytes(range(256)) * 4096
    print('RING', small, echo(big, timeout=60) == big, adopted)
srv.stop(grace=0)
"""


def _channel_over_ring_platform(C, S):
    out = _child(C, S, _RING_BODY, {"GRPC_PLATFORM_TYPE": "RDMA_BP",
                                    "GRPC_RDMA_RING_BUFFER_SIZE_KB": "1024"})
    return [ln for ln in out.splitlines() if ln.startswith("RING")]


_LEASE_BODY = """\
import hashlib
srv = srv_rpc.Server(max_workers=4)
def digest_each(req_iter, ctx):
    for m in req_iter:
        b = bytes(m)
        yield ('%d:%s' % (len(b), hashlib.sha256(b).hexdigest())).encode()
srv.add_method('/n.S/Digest', srv_rpc.stream_stream_rpc_method_handler(
    digest_each))
port = srv.add_insecure_port('127.0.0.1:0')
srv.start()
msgs = [
    [bytes(range(256)) * 8192, b'tail' * 7],      # 2 MiB and more: 3 frags
    [b'x' * 100],                                 # the classic path
    [b'y' * (1 << 20), b'z' * 513],               # one frame and a bit
]
with NativeChannel('127.0.0.1', port) as ch:
    call = ch.stream_stream('/n.S/Digest')
    for got, m in zip(call(iter(msgs), timeout=60), msgs):
        joined = b''.join(m)
        want = ('%d:%s' % (len(joined),
                           hashlib.sha256(joined).hexdigest())).encode()
        print('LEASE', got == want, got.split(b':')[0].decode())
srv.stop(grace=0)
"""


def _stream_lease_gather_multifragment(C, S):
    out = _child(C, S, _LEASE_BODY, {"GRPC_PLATFORM_TYPE": "RDMA_BPEV",
                                     "GRPC_RDMA_RING_BUFFER_SIZE_KB": "8192"})
    return [ln for ln in out.splitlines() if ln.startswith("LEASE")]


_ECHO_SRV = (
    '#include <cstdio>\n#include "tpurpc/server.h"\n'
    'static int cb(tpr_server_call *c, const uint8_t *d, size_t n,'
    ' void *) { tpr_srv_send(c, d, n); return 0; }\n'
    'int main() { tpr_server *s = tpr_server_create(0);\n'
    '  tpr_server_register_callback(s, "/n.S/Echo", cb, nullptr);\n'
    '  tpr_server_start(s); printf("PORT %d\\n", tpr_server_port(s));\n'
    '  fflush(stdout); getchar(); tpr_server_destroy(s); }\n')


@pytest.fixture(scope="module")
def echo_bins(tmp_path_factory):
    """The C++ callback echo server, built from each package's sources."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ toolchain")
    out = tmp_path_factory.mktemp("native_echo")
    src = out / "echo_srv.cc"
    src.write_text(_ECHO_SRV)
    bins = {}
    for name, root in SRC.items():
        binp = out / f"echo_srv_{name}"
        subprocess.run(
            [gxx, "-std=c++17", "-O2", str(src),
             *[os.path.join(root, "src", f) for f in
               ("tpurpc_server.cc", "tpr_rdv.cc", "tpr_obs.cc", "ring.cc")],
             "-I", os.path.join(root, "include"),
             "-lpthread", "-lrt", "-o", str(binp)],
            check=True, timeout=180, capture_output=True)
        bins[name] = str(binp)
    return bins


def _native_vs_python_latency(C, S, bins):
    """The fast path must be faster, against a C++ callback echo server
    (built from the server package's sources) so that the server's cost is
    constant and small."""
    proc = subprocess.Popen([bins[S.name]], stdout=subprocess.PIPE,
                            stdin=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline().split()[1])
        n = 500
        with C.NativeChannel("127.0.0.1", port) as ch:
            echo = ch.unary_unary("/n.S/Echo")
            echo(b"warm", timeout=10)
            t0 = time.perf_counter()
            for _ in range(n):
                echo(b"x", timeout=10)
            native_s = time.perf_counter() - t0
        with C.rpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            echo = ch.unary_unary("/n.S/Echo")
            echo(b"warm", timeout=10)
            t0 = time.perf_counter()
            for _ in range(n):
                echo(b"x", timeout=10)
            py_s = time.perf_counter() - t0
        sys.stderr.write(f"{C.name}->{S.name}: native "
                         f"{native_s / n * 1e6:.0f}us/call vs python "
                         f"{py_s / n * 1e6:.0f}us/call\n")
        # the margin absorbs scheduling hiccups; the real ratio is ~3x
        return native_s < py_s * 1.2
    finally:
        proc.stdin.close()
        proc.wait(timeout=10)


def _compressed_frame_fails_stream_not_connection(C, S):
    """A MESSAGE with FLAG_COMPRESSED addressed to one stream fails THAT
    stream UNIMPLEMENTED (the native client links no decompressor), not
    the connection: a frame-level fake server (the server package's
    framing) forges it."""
    if S.name == "ref":
        from tpurpc.core.endpoint import TcpEndpoint
        from tpurpc.rpc import frame as fr
    else:
        from tpurpc_torch.core.endpoint import TcpEndpoint
        from tpurpc_torch.rpc import frame as fr

    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]
    server_err: list = []

    def fake_server():
        try:
            sock, _ = lsock.accept()
            ep = TcpEndpoint(sock)
            reader = fr.FrameReader(ep, expect_preface=True)
            writer = fr.FrameWriter(ep)
            sids = []  # HEADERS arrival order = call submission order
            while len(sids) < 2:
                f = reader.read_frame(timeout=15)
                assert f is not None, "client hung up early"
                if f is fr.CONSUMED:
                    continue
                if f.type == fr.HEADERS:
                    sids.append(f.stream_id)
            a, b = sids
            forged = b"\x1f\x8b-not-really-gzip"
            ep.write([fr.HEADER_FMT.pack(
                fr.MESSAGE, fr.FLAG_COMPRESSED | fr.FLAG_END_STREAM,
                a, len(forged)), forged])
            writer.send(fr.MESSAGE, 0, b, b"fine")
            writer.send(fr.TRAILERS, 0, b, fr.trailers_payload(
                S.status.StatusCode.OK, ""))
            while True:  # drain until EOF so that the client closes cleanly
                f = reader.read_frame(timeout=15)
                if f is None:
                    break
        except Exception as exc:  # surfaced by the assert below
            server_err.append(exc)

    t = threading.Thread(target=fake_server, daemon=True)
    t.start()
    try:
        with C.NativeChannel("127.0.0.1", port) as ch:
            echo = ch.unary_unary("/n.S/Echo")
            fut_a = echo.future(b"a", timeout=15)
            fut_b = echo.future(b"b", timeout=15)
            with pytest.raises(C.status.RpcError) as ei:
                fut_a.result(timeout=20)
            code, details = code_name(ei.value)
            other = fut_b.result(timeout=20)
    finally:
        lsock.close()
        t.join(timeout=5)
    assert not server_err, server_err
    return code, "compressed" in details, other


SCENARIOS = {
    "unary_and_ping": _unary_and_ping,
    "serializers": _serializers,
    "status_mapping": _status_mapping,
    "streaming": _streaming,
    "futures_pipelined": _futures_pipelined,
    "future_error_and_deserializer": _future_error_and_deserializer,
    "future_deadline": _future_deadline,
    "future_user_cancel_keeps_puller_alive": _future_user_cancel,
    "futures_closed_while_inflight": _futures_closed_while_inflight,
    "futures_survive_server_death": _futures_survive_server_death,
    "channel_over_ring_platform": _channel_over_ring_platform,
    "stream_lease_gather_multifragment": _stream_lease_gather_multifragment,
    "compressed_frame_fails_stream_not_connection":
        _compressed_frame_fails_stream_not_connection,
}

#: what the reference pair observes, where a case pins it
EXPECT = {
    "unary_and_ping": (True, b"hi", True),
    "serializers": "text",
    "status_mapping": [("FAILED_PRECONDITION", True), ("UNIMPLEMENTED", False)],
    "streaming": [b"aa", b"bbbb", b"cccccc"],
    "futures_pipelined": [b"m%d" % i for i in range(64)],
    "future_error_and_deserializer": (("FAILED_PRECONDITION", "nope"), "hi"),
    "future_deadline": "DEADLINE_EXCEEDED",
    "future_user_cancel_keeps_puller_alive": [b"n%d" % i for i in range(8)],
    "futures_closed_while_inflight": 4,
    "futures_survive_server_death": (0, True, b"hi"),
    "channel_over_ring_platform": ["RING b'ring' True True"],
    "stream_lease_gather_multifragment": [
        "LEASE True 2097180", "LEASE True 100", "LEASE True 1049089"],
    "compressed_frame_fails_stream_not_connection":
        ("UNIMPLEMENTED", True, b"fine"),
}


@pytest.mark.parametrize("client,server", DIRS, ids=DIR_IDS)
@pytest.mark.parametrize("case", list(SCENARIOS))
def test_native_client_twin(case, client, server):
    assert twin(SCENARIOS[case], client, server) == EXPECT[case]


@pytest.mark.parametrize("client,server", DIRS, ids=DIR_IDS)
def test_native_vs_python_latency(client, server, echo_bins):
    """Each package's native fast path beats its own Python channel against
    the C++ echo server of the other package's sources."""
    assert twin(_native_vs_python_latency, client, server, echo_bins) is True
