"""The port's native data plane below and around the RPC surface.

* the ring's C fast path (``core/ring.py`` over ``native/src/ring.cc``):
  ``read``, ``read_into``, ``drain_into``, ``read_many`` and
  ``scan_complete`` give the same bytes and the same ring state as the
  pure-Python path, and either writer leaves the ring memory byte-equal to
  the reference writer's;
* the pair: the fused native send (``tpr_send_fast``) delivers what the
  Python send delivers, and the ``waitflag`` capability negotiates between
  a port pair and a reference pair in all four combinations of each
  side's library on and off: a sender skips the notify byte only for a
  peer that advertised the words and is not asleep, and a sleeper is
  never left asleep;
* the path choice: for each platform and switch, the port picks the
  native plane exactly when the reference does (the channel's fast path,
  the server's adoption);
* tensor methods on an adopted server, called through a port ``Channel``
  (the native fast path), through ``NativeChannel`` with a pipeline, and
  through ``duplex(native=True)``, reply as the reference's adopted server
  does; ``rdv_counters`` count the bulk messages one-sided;
* the asyncio surface over the native planes (the twin of
  ``test_aio.py::test_aio_over_ring_platform_round4_planes`` and of its
  ``aio.NativeChannel`` case), across the packages.
"""

import asyncio
import contextlib
import os
import re
import socket
import threading
import time

import numpy as np
import pytest
import torch

from tpurpc.core import pair as ref_pair
from tpurpc.core import poller as ref_poller
from tpurpc.core import ring as ref_ring
from tpurpc.jaxshim import service as ref_svc
from tpurpc_torch.core import pair as port_pair
from tpurpc_torch.core import poller as port_poller
from tpurpc_torch.core import ring as port_ring
from tpurpc_torch.torchshim import service as port_svc
from torch_native import (DIR_IDS, DIRS, PKG, PORT, REF, libs,  # noqa: F401
                          on_platform)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def native_state(pkg, on: bool):
    """``pkg``'s native library on or off for the block (``TPURPC_NATIVE``
    read by a fresh load); loaded again afterwards."""
    if on:
        yield
        return
    saved = os.environ.get("TPURPC_NATIVE")
    pkg.native.reset_for_tests()
    os.environ["TPURPC_NATIVE"] = "0"
    try:
        assert pkg.native.load() is None
    finally:
        if saved is None:
            del os.environ["TPURPC_NATIVE"]
        else:
            os.environ["TPURPC_NATIVE"] = saved
    try:
        yield
    finally:
        pkg.native.reset_for_tests()
        assert pkg.native.load() is not None


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

CAP = 4096


def _messages(seed=7, n=120):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 700, size=n)
    return [rng.integers(0, 256, size=int(s), dtype=np.uint8).tobytes()
            for s in sizes]


def _writer(mod, buf, native: bool):
    mv = memoryview(buf)

    def write(off, data):
        mv[off:off + len(data)] = data

    w = mod.RingWriter(CAP, write, mapped=mv if native else None)
    assert (w._nat is not None) == native
    return w


def _reader(mod, buf, native: bool):
    r = mod.RingReader(buf, CAP)
    if not native:
        r._nat = None
    assert (r._nat is not None) == native
    return r


def _drive(mod, w_native, r_native, how):
    """Write the seeded messages through a ring of ``CAP`` bytes (it wraps
    many times), draining with ``how``; returns what came out, the ring
    memory after the last write, and the reader's final state."""
    buf = bytearray(CAP)
    w = _writer(mod, buf, w_native)
    r = _reader(mod, buf, r_native)
    out = []
    pending = list(_messages())
    while pending or r.has_message():
        while pending and len(pending[0]) <= w.writable_payload():
            w.writev([pending.pop(0)])
        assert r.readable() > 0
        if how == "read":
            out.append(r.read(CAP))
        elif how == "read_into":
            dst = bytearray(333)  # partial reads resume across calls
            n = r.read_into(dst)
            out.append(bytes(dst[:n]))
        elif how == "drain_into":
            dst = bytearray(CAP)
            n, _msgs = r.drain_into(dst)
            out.append(bytes(dst[:n]))
        elif how == "read_many":
            descs, span = r.scan_complete()
            views = r.read_many()
            assert [len(v) for v in views] == [ln for _off, ln in descs]
            out.append(b"".join(bytes(v) for v in views))
        w.update_remote_head(r.take_publish())
    return b"".join(out), bytes(buf), (r.head, r.seq, w.tail, w.seq)


@pytest.mark.parametrize("how", ["read", "read_into", "drain_into",
                                 "read_many"])
@pytest.mark.parametrize("w_native,r_native",
                         [(True, True), (True, False), (False, True)],
                         ids=["native", "native-writer", "native-reader"])
def test_ring_native_paths_match_python_and_reference(how, w_native,
                                                      r_native):
    libs()
    want = b"".join(_messages())
    ref = _drive(ref_ring, False, False, how)
    py = _drive(port_ring, False, False, how)
    got = _drive(port_ring, w_native, r_native, how)
    assert ref[0] == py[0] == got[0] == want
    # the same wire: the ring memory and the positions are the reference's
    assert got[1:] == py[1:] == ref[1:]


def test_ring_write_into_released_peer_window_raises():
    libs()
    buf = bytearray(CAP)
    mv = memoryview(buf)
    w = port_ring.RingWriter(CAP, lambda off, data: None, mapped=mv)
    assert w._nat is not None
    mv.release()
    with pytest.raises(port_ring.RingCorruption):
        w.writev([b"x" * 8])


# ---------------------------------------------------------------------------
# the pair
# ---------------------------------------------------------------------------

def _loopback_echo(native: bool):
    with native_state(PORT, native):
        a, b = port_pair.create_loopback_pair(ring_size=8192)
    fast = []
    real = a._send_fast
    a._send_fast = lambda views, cfg: fast.append(real(views, cfg)) or fast[-1]
    try:
        got = bytearray()
        for m in _messages(seed=11, n=60):
            sent = 0
            while sent < len(m):
                sent += a.send([m[:7], m[7:]], byte_idx=sent)
                got += b.recv()
        got += b.recv()
        used = [x for x in fast if x is not None]
        return bytes(got), bool(used), a.total_sent
    finally:
        a.destroy()
        b.destroy()


def test_pair_fused_send_delivers_what_the_python_send_does():
    libs()
    want = b"".join(_messages(seed=11, n=60))
    py = _loopback_echo(False)
    nat = _loopback_echo(True)
    assert py == (want, False, len(want))
    assert nat == (want, True, len(want))


def _cross(ref_on: bool, port_on: bool):
    """A reference pair and a port pair over shm, joined by a socketpair,
    each built with its own library on or off."""
    with native_state(REF, ref_on), native_state(PORT, port_on):
        r = ref_pair.Pair(ref_pair.ShmDomain(), ring_size=8192)
        p = port_pair.Pair(port_pair.ShmDomain(), ring_size=8192)
        r.init()
        p.init()
        sr, sp = socket.socketpair()
        err = []

        def side():
            try:
                p.connect_over_socket(sp)
            except BaseException as exc:
                err.append(exc)

        t = threading.Thread(target=side, daemon=True)
        t.start()
        r.connect_over_socket(sr)
        t.join(10)
        assert not err, err
    return r, p


def _notifies(pair):
    sent = []
    real = pair._notify

    def counted(token):
        sent.append(token)
        return real(token)

    pair._notify = counted
    return sent


def _one_way(sender, receiver, poller, ref_on, port_on):
    """Sends with nobody waiting, then sends to a receiver asleep on its
    notify fd; returns (notifies while nobody waited, the bytes, whether
    the sleeper woke)."""
    with native_state(REF, ref_on), native_state(PORT, port_on):
        sent = _notifies(sender)
        early = [b"e%03d" % i for i in range(10)]
        for m in early:
            assert sender.send([m]) == len(m)
        idle_notifies = len(sent)
        got = bytearray()
        while len(got) < 40:
            assert poller.wait_readable(receiver, timeout=5,
                                        discipline="event")
            got += receiver.recv()
        woke = []

        def sleeper():
            ok = poller.wait_readable(receiver, timeout=10,
                                      discipline="event")
            woke.append(ok)

        t = threading.Thread(target=sleeper)
        t.start()
        time.sleep(0.2)  # the sleeper is in its select, its flag up
        assert sender.send([b"late"]) == 4
        t.join(15)
        got += receiver.recv()
        return idle_notifies, bytes(got), woke == [True]


@pytest.mark.parametrize("ref_on", [True, False], ids=["ref-on", "ref-off"])
@pytest.mark.parametrize("port_on", [True, False],
                         ids=["port-on", "port-off"])
def test_waitflag_negotiates_across_packages(ref_on, port_on):
    libs()
    r, p = _cross(ref_on, port_on)
    try:
        assert ("waitflag" in r.peer_caps) == port_on
        assert ("waitflag" in p.peer_caps) == ref_on
        want = b"".join(b"e%03d" % i for i in range(10)) + b"late"
        # the reference sends to the port, then the port to the reference;
        # a notify is skipped only toward a peer that advertised the words
        assert _one_way(r, p, port_poller, ref_on, port_on) == (
            0 if (port_on and ref_on) else 10, want, True)
        assert _one_way(p, r, ref_poller, ref_on, port_on) == (
            0 if (port_on and ref_on) else 10, want, True)
    finally:
        r.destroy()
        p.destroy()


# ---------------------------------------------------------------------------
# the path choice
# ---------------------------------------------------------------------------

#: (adopted, channel fast path, compressing channel's fast path) per case
CHOICES = {
    "tcp": ("TCP", {}, (False, False, False)),
    "tcp-forced": ("TCP", {"TPURPC_NATIVE_FAST_UNARY": "1"},
                   (False, True, False)),
    "bp": ("RDMA_BP", {}, (True, True, False)),
    "event": ("RDMA_EVENT", {}, (True, True, False)),
    "bpev": ("RDMA_BPEV", {}, (True, True, False)),
    "bpev-no-fast": ("RDMA_BPEV", {"TPURPC_NATIVE_FAST_UNARY": "0"},
                     (True, False, False)),
    "bpev-no-server": ("RDMA_BPEV", {"TPURPC_NATIVE_SERVER": "0"},
                       (False, True, False)),
    "tpu": ("TPU", {}, (False, False, False)),
}


@pytest.mark.parametrize("case", list(CHOICES))
def test_native_plane_chosen_exactly_when_the_reference_does(on_platform,
                                                              case):
    plat, env, want = CHOICES[case]
    on_platform(plat, **env)

    def choice(pkg):
        srv = pkg.rpc.Server(max_workers=2)
        srv.add_method("/c.S/E", pkg.rpc.unary_unary_rpc_method_handler(
            lambda r, c: bytes(r)))
        port = srv.add_insecure_port("127.0.0.1:0")
        srv.start()
        try:
            with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
                fast = ch._native_fast() is not None
                reply = bytes(ch.unary_unary("/c.S/E")(b"p", timeout=20))
            with pkg.rpc.Channel(f"127.0.0.1:{port}",
                                 compression="gzip") as ch:
                gz_fast = ch._native_fast() is not None
            return (srv._native_dp is not None, fast, gz_fast), reply
        finally:
            srv.stop(grace=0)

    assert choice(PORT) == choice(REF) == (want, b"p")


# ---------------------------------------------------------------------------
# tensor methods on an adopted server
# ---------------------------------------------------------------------------

def _tensor_server(pkg):
    srv = pkg.rpc.Server(max_workers=8)
    svc = ref_svc if pkg is REF else port_svc
    # exact reductions only: the packages' sums differ in their last bits
    svc.add_tensor_method(srv, "Affine", lambda t: {
        "y": t["x"] * 2 + 1, "n": t["x"].max()})
    svc.add_tensor_method(srv, "Head", lambda t: {"h": t["x"][:4]})

    def total(trees):
        for t in trees:
            yield {"s": t["x"].max()}

    svc.add_tensor_method(srv, "Total", total, kind="stream_stream")
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _np(tree):
    return {k: np.asarray(v.numpy() if torch.is_tensor(v) else v)
            for k, v in tree.items()}


def _tensor_calls(pkg, xs, bulk):
    """Unary calls through the channel's fast path (small and bulk) and a
    NativeChannel pipeline, and a native duplex of bulk tensors; the rdv
    delta. A unary request passes the C loop one buffer, which rendezvous
    above TPURPC_RENDEZVOUS_MIN_KB; a stream's tensor write is a gather
    list, which the send lease places in the ring framed (in both
    packages), so the duplex moves nothing one-sided."""
    svc = ref_svc if pkg is REF else port_svc
    mk = (lambda a: a) if pkg is REF else torch.from_numpy
    srv, port = _tensor_server(pkg)
    try:
        adopted = srv._native_dp is not None
        c0 = pkg.nc.rdv_counters()
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            cli = svc.TensorClient(ch)
            unary = [_np(cli.call("Affine", {"x": mk(x)}, timeout=30))
                     for x in xs]
            unary += [_np(cli.call("Head", {"x": mk(b)}, timeout=60))
                      for b in bulk]
            fast = ch._native_ch is not None
            sums = [_np(t)["s"].item() for t in cli.duplex(
                "Total", ({"x": mk(b)} for b in bulk), timeout=60,
                native=True)]
        with pkg.NativeChannel("127.0.0.1", port, inline_read=True) as nch:
            pl = svc.TensorClient(nch).pipeline("Affine", depth=8)
            futs = [pl.call_async({"x": mk(x)}, timeout=30) for x in xs]
            piped = [_np(f.result(30)) for f in futs]
        c1 = pkg.nc.rdv_counters()
        delta = {k: c1[k] - c0[k] for k in ("rdv_sent", "rdv_recv")}
        return adopted, fast, unary, piped, sums, delta
    finally:
        srv.stop(grace=0)


def test_adopted_server_serves_tensor_methods_as_the_reference(on_platform):
    on_platform("RDMA_BPEV", TPURPC_RENDEZVOUS_MIN_KB="256")
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((8, 128)).astype(np.float32) for _ in range(6)]
    bulk = [rng.standard_normal(1 << 18).astype(np.float32)  # 1 MiB each
            for _ in range(3)]
    ref = _tensor_calls(REF, xs, bulk)
    got = _tensor_calls(PORT, xs, bulk)
    assert got[:2] == ref[:2] == (True, True)
    for a, b in zip(got[2] + got[3], ref[2] + ref[3]):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert got[4] == ref[4]
    # each bulk unary request goes one-sided and its reply does not: the
    # client's library counts the sends, the server's the receives (here
    # one library); the duplex adds nothing
    assert got[5] == ref[5] == {"rdv_sent": 3, "rdv_recv": 3}


# ---------------------------------------------------------------------------
# the asyncio surface
# ---------------------------------------------------------------------------

def _aio_round4(C, S):
    srv = S.rpc.Server(max_workers=4)
    srv.add_method("/a.S/Echo", S.rpc.unary_unary_rpc_method_handler(
        lambda r, c: bytes(r), inline=True))

    def dbl(it, c):
        for m in it:
            yield bytes(m) * 2

    srv.add_method("/a.S/Dbl", S.rpc.stream_stream_rpc_method_handler(dbl))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        adopted = srv._native_dp is not None

        async def main():
            async with C.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                echo = ch.unary_unary("/a.S/Echo")
                out = await asyncio.gather(
                    *[echo(f"m{i}".encode(), timeout=30) for i in range(16)])

                async def gen():
                    yield b"x"
                    yield b"yy"

                got = [bytes(r) async for r in ch.stream_stream("/a.S/Dbl")(
                    gen(), timeout=30)]
                return [bytes(o) for o in out], got

        return adopted, asyncio.run(main())
    finally:
        srv.stop(grace=0)


@pytest.mark.parametrize("client,server", DIRS, ids=DIR_IDS)
def test_aio_over_ring_platform_round4_planes(on_platform, client, server):
    on_platform("RDMA_BP")
    want = _aio_round4(REF, REF)
    assert _aio_round4(PKG[client], PKG[server]) == want == (
        True, ([f"m{i}".encode() for i in range(16)], [b"xx", b"yyyy"]))


def _aio_native_channel(C, S):
    srv = S.rpc.Server(max_workers=4)
    srv.add_method("/a.S/Echo", S.rpc.unary_unary_rpc_method_handler(
        lambda r, c: bytes(r) + b"?", inline=True))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        async def main():
            async with C.aio.NativeChannel("127.0.0.1", port) as ch:
                echo = ch.unary_unary("/a.S/Echo")
                outs = await asyncio.gather(*[echo(b"m%d" % i, timeout=30)
                                              for i in range(64)])
                return outs, await ch.ping() < 5

        return asyncio.run(main())
    finally:
        srv.stop(grace=0)


@pytest.mark.parametrize("client,server", DIRS, ids=DIR_IDS)
def test_aio_native_channel(on_platform, client, server):
    """64 coroutines in flight on one connection through the completion
    queue, on TCP as the reference's case runs."""
    on_platform("TCP")
    want = _aio_native_channel(REF, REF)
    assert _aio_native_channel(PKG[client], PKG[server]) == want == (
        [b"m%d?" % i for i in range(64)], True)


# ---------------------------------------------------------------------------
# the C tree names the port, never the reference's modules or JAX
# ---------------------------------------------------------------------------

def test_port_c_tree_names_no_reference_module_or_jax():
    root = os.path.join(REPO, "tpurpc_torch", "native")
    ref_path = re.compile(r"(?<![\w/])tpurpc/(?:core|rpc|obs|jaxshim|tpu|utils"
                          r"|models|serving|wire|ops|parallel)/")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]
    assert len(files) == 15, files
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        assert not re.search(r"jax", src, re.I), path
        assert not ref_path.search(src), (path, ref_path.search(src))
        assert "native/build" not in src, path


def test_h2_channel_factories_take_the_native_switch():
    """A divergence held on purpose: ``TensorClient.duplex`` passes the
    channel's factory ``tpurpc_native=`` (as the reference's does), and the
    port's ``H2Channel`` factories take and ignore extra keywords, so a
    tensor stream runs over h2; the reference's ``H2Channel`` refuses the
    keyword (ROADMAP C)."""
    from tpurpc.wire.h2_client import H2Channel as RefH2Channel
    from tpurpc_torch.wire.h2_client import H2Channel as PortH2Channel

    srv = PORT.rpc.Server(max_workers=2)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    port_ch = PortH2Channel(f"127.0.0.1:{port}")
    ref_ch = RefH2Channel(f"127.0.0.1:{port}")
    try:
        for kind in ("unary_unary", "unary_stream", "stream_unary",
                     "stream_stream"):
            assert callable(getattr(port_ch, kind)("/x.S/M",
                                                    tpurpc_native=False))
            with pytest.raises(TypeError):
                getattr(ref_ch, kind)("/x.S/M", tpurpc_native=False)
    finally:
        port_ch.close()
        ref_ch.close()
        srv.stop(grace=0)
