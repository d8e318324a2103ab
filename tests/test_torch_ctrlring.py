"""The descriptor-ring control plane (``tpurpc_torch/core/ctrlring.py``)
against the reference's (``tpurpc/core/ctrlring.py``).

Twins of ``tests/test_ctrlring.py``: the ring protocol (post/drain order,
seq stamps, the frame_seq gate, ring-full fallback, the parked/kick
handshake, nonce checks, the stale-ring rule), the hello negotiation, the
steady state with zero framed control ops, peer death with ring control
in flight, the async-domain COMPLETE, and the coalesced framed path
(``FrameWriter.batch``, ``_CtrlFrameCoalescer``, the migrate burst, here
counted in the endpoint's writevs). Each protocol case runs on both
packages; the ring's bytes are compared across them, and a port peer and
a reference peer negotiate the ring with each other, both ways.

Left out, with their items in ROADMAP: the ringcheck model and mutants
(A12), the watchdog's ``ctrl-ring`` stage and the lens ``ctrl`` hop (A4),
and the native-plane cases (A7).
"""

import threading
import time

import numpy as np
import pytest
import torch

import tpurpc.core.ctrlring as ref_ctrl
import tpurpc.core.rendezvous as ref_rdv
import tpurpc_torch.core.ctrlring as port_ctrl
import tpurpc_torch.core.rendezvous as port_rdv
from tpurpc.core import pair as ref_pair
from tpurpc.jaxshim import TensorClient as RefClient
from tpurpc.jaxshim import add_tensor_method as ref_add_tensor_method
from tpurpc.obs import metrics as ref_metrics
from tpurpc.rpc import frame as ref_fr
from tpurpc_torch.core import pair as port_pair
from tpurpc_torch.rpc import frame as port_fr
from tpurpc_torch.torchshim.service import TensorClient, add_tensor_method
from torch_call_plane import PORT, REF, platform  # noqa: F401

CTRL = {"ref": ref_ctrl, "port": port_ctrl}
RDV = {"ref": ref_rdv, "port": port_rdv}
FR = {"ref": ref_fr, "port": port_fr}
PAIR = {"ref": ref_pair, "port": port_pair}
PKGS = ["ref", "port"]


def _open_peer(producer, desc):
    """A producer window of module ``producer`` onto the ring whose hello
    descriptor is ``desc``."""
    (nslots, slot_bytes, nbytes, nonce,
     klen) = producer._DESC.unpack_from(desc)
    pos = producer._DESC.size
    kind = desc[pos:pos + klen].decode()
    handle = desc[pos + klen:].decode()
    return producer.CtrlPeer(kind, handle, nslots, slot_bytes, nbytes, nonce)


def _pair_rings(consumer, producer=None):
    """An (rx, tx) pair the unit tests drive directly: the consumer-owned
    ring plus a producer window opened from its descriptor."""
    rx = consumer.CtrlRing(kind="shm", nslots=8)
    return rx, _open_peer(producer or consumer, rx.descriptor())


# ---------------------------------------------------------------------------
# the ring protocol, on each package
# ---------------------------------------------------------------------------

def _roundtrip(rx, tx):
    posted = [tx.post(3, 100 + i, bytes([i]) * (i + 1), 0) in (1, 2)
              for i in range(5)]
    got = []
    n = rx.drain(lambda op, sid, pl: got.append((op, sid, bytes(pl))),
                 lambda: 0)
    return posted, n, got, tx.backlog()


@pytest.mark.parametrize("name", PKGS)
def test_post_drain_roundtrip_in_order(name):
    rx, tx = _pair_rings(CTRL[name])
    try:
        posted, n, got, backlog = _roundtrip(rx, tx)
    finally:
        tx.close()
        rx.close()
    assert posted == [True] * 5 and n == 5
    assert got == [(3, 100 + i, bytes([i]) * (i + 1)) for i in range(5)]
    assert backlog == 0  # one cons_head publish per batch


@pytest.mark.parametrize("name", PKGS)
def test_ring_full_refuses_then_recovers(name):
    rx, tx = _pair_rings(CTRL[name])
    try:
        assert all(tx.post(1, i, b"x", 0) for i in range(rx.nslots))
        assert tx.post(1, 99, b"x", 0) == 0  # full: framed fallback
        assert tx.backlog() == rx.nslots
        got = []
        rx.drain(lambda *a: got.append(a), lambda: 0)
        assert len(got) == rx.nslots
        assert tx.post(1, 99, b"x", 0)  # space returned
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("name", PKGS)
def test_oversized_payload_refused(name):
    mod = CTRL[name]
    rx, tx = _pair_rings(mod)
    try:
        assert tx.post(1, 1, b"y" * (mod.MAX_CTRL_PAYLOAD + 1), 0) == 0
        assert tx.post(1, 1, b"y" * mod.MAX_CTRL_PAYLOAD, 0)
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("name", PKGS)
def test_frame_seq_gate_defers_until_frames_dispatch(name):
    """A record stamped with frame_seq N is invisible until the consumer
    has dispatched N frames."""
    rx, tx = _pair_rings(CTRL[name])
    try:
        assert tx.post(3, 1, b"a", 2)
        assert tx.post(3, 2, b"b", 4)
        got = []
        sink = lambda op, sid, pl: got.append(sid)  # noqa: E731
        assert rx.drain(sink, lambda: 0) == 0     # both gated
        assert rx.drain(sink, lambda: 2) == 1     # first passes
        assert got == [1]
        assert rx.drain(sink, lambda: 3) == 0     # head of line gates
        assert rx.drain(sink, lambda: 4) == 1
        assert got == [1, 2]
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("name", PKGS)
def test_parked_flag_requests_kick(name):
    rx, tx = _pair_rings(CTRL[name])
    try:
        rx.set_parked(False)
        assert tx.post(1, 1, b"a", 0) == 1   # consumer polling: no kick
        rx.set_parked(True)
        assert tx.post(1, 2, b"b", 0) == 2   # parked: the caller kicks
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("name", PKGS)
def test_peer_open_rejects_wrong_nonce(name):
    mod = CTRL[name]
    rx = mod.CtrlRing(kind="shm", nslots=8)
    try:
        desc = rx.descriptor()
        (nslots, slot_bytes, nbytes, _nonce,
         klen) = mod._DESC.unpack_from(desc)
        pos = mod._DESC.size
        kind = desc[pos:pos + klen].decode()
        handle = desc[pos + klen:].decode()
        with pytest.raises(OSError):
            mod.CtrlPeer(kind, handle, nslots, slot_bytes, nbytes,
                         b"\x00" * 16)
    finally:
        rx.close()


@pytest.mark.parametrize("name", PKGS)
def test_stale_ring_write_lands_in_dead_memory(name):
    """A late slot store after link death lands in orphaned memory, never
    in a ring a new link reads: rings are per connection, never pooled."""
    mod = CTRL[name]
    rx, tx = _pair_rings(mod)
    rx.close()                      # link death: the consumer side is gone
    assert tx.post(3, 7, b"late", 0) in (0, 1, 2)  # no crash either way
    rx2, tx2 = _pair_rings(mod)
    try:
        got = []
        assert rx2.drain(lambda *a: got.append(a), lambda: 0) == 0
        assert got == []
    finally:
        tx2.close()
        rx2.close()
        tx.close()
    assert rx.drain(lambda *a: None, lambda: 0) == 0  # the dead ring too


def test_reader_drain_waits_out_a_concurrent_drainer():
    """The port's connection reader drains with ``wait=True``: while a
    sender thread's drain is delivering a record, a skipping drain returns
    at once, and the reader's waits until that delivery is done, so a frame
    it dispatches next can never overtake the record."""
    rx, tx = _pair_rings(port_ctrl)
    inside, release = threading.Event(), threading.Event()
    order = []

    def slow(op, sid, pl):
        inside.set()
        release.wait(5)
        order.append("delivered")

    try:
        assert tx.post(3, 1, b"c", 0)
        t = threading.Thread(target=lambda: rx.drain(slow, lambda: 0))
        t.start()
        assert inside.wait(5)
        assert rx.drain(lambda *a: None, lambda: 0) == 0  # skips
        reader = threading.Thread(target=lambda: (
            rx.drain(lambda *a: None, lambda: 0, wait=True),
            order.append("reader")))
        reader.start()
        time.sleep(0.05)
        assert order == []  # still waiting on the sender's drain
        release.set()
        t.join(5)
        reader.join(5)
        assert order == ["delivered", "reader"]
    finally:
        release.set()
        tx.close()
        rx.close()


@pytest.mark.parametrize("name", PKGS)
def test_plane_negotiation_ladder(name):
    """An empty blob (a peer without rings) and a garbage blob leave the
    plane framed; only a valid descriptor arms it."""
    mod = CTRL[name]
    a = mod.CtrlPlane("test-a")
    b = mod.CtrlPlane("test-b")
    try:
        assert not a.on_hello(b"") and not a.armed
        assert not a.on_hello(b"\x07garbage") and not a.armed
        assert a.on_hello(b.hello_blob()) and a.armed
        kicks = []
        assert a.post(3, 1, b"p", 0, kick=lambda: kicks.append(1))
        assert kicks == [1]  # a fresh ring starts parked: one kick
        got = []
        assert b.drain(lambda op, sid, pl: got.append((op, sid)),
                       lambda: 0) == 1
        assert got == [(3, 1)]
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("name", PKGS)
def test_disabled_plane_advertises_nothing(name, monkeypatch):
    monkeypatch.setenv("TPURPC_CTRL_RING", "0")
    mod = CTRL[name]
    a = mod.CtrlPlane("test-off")
    b = mod.CtrlPlane("test-on")
    try:
        assert a.hello_blob() == b"" and not mod.enabled()
        assert not a.on_hello(b.hello_blob()) and not a.armed
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# the wire bytes, across packages
# ---------------------------------------------------------------------------

def test_descriptor_and_slot_bytes_equal_reference():
    """The 64-byte header, the 128-byte slot records and the hello
    descriptor are the reference's, byte for byte (the nonce and the shm
    name aside, which are random per ring)."""
    for fmt in ("_HDR", "_SLOT_HDR", "_STAMP", "_DESC", "_BLOB_LEN",
                "_CONS_HEAD", "_PARKED"):
        assert getattr(port_ctrl, fmt).format == getattr(ref_ctrl, fmt).format
    for const in ("_MAGIC", "_VERSION", "SLOT_BYTES", "_HDR_BYTES",
                  "_CONS_HEAD_OFF", "_PARKED_OFF", "_NONCE_OFF",
                  "MAX_CTRL_PAYLOAD"):
        assert getattr(port_ctrl, const) == getattr(ref_ctrl, const)
    rings = {}
    try:
        for name in PKGS:
            rx, tx = _pair_rings(CTRL[name])
            rings[name] = (rx, tx)
            for i in range(11):  # wraps the 8 slots after a drain
                tx.post(1 + i % 4, 2 * i + 1, bytes(range(i * 7, i * 9)),
                        i)
                if i == 6:
                    rx.drain(lambda *a: None, lambda: 1 << 30)
        views = {}
        for name, (rx, tx) in rings.items():
            raw = bytearray(rx.region.buf[:rx.nbytes])
            raw[32:48] = b"\x00" * 16  # the nonce
            desc = rx.descriptor()
            pos = CTRL[name]._DESC.size
            # nslots, slot_bytes, nbytes | (nonce) | klen, kind
            views[name] = (bytes(raw), desc[:16], desc[32:pos + 3])
        assert views["port"] == views["ref"]
        planes = {n: CTRL[n].CtrlPlane("bytes-" + n) for n in PKGS}
        try:
            blobs = {n: p.hello_blob() for n, p in planes.items()}
            lens = {n: len(b) - len(p.rx.region.handle)
                    for (n, b), p in zip(blobs.items(), planes.values())}
            assert lens["port"] == lens["ref"]
            assert blobs["port"][:2] == blobs["ref"][:2]
        finally:
            for p in planes.values():
                p.close()
    finally:
        for rx, tx in rings.values():
            tx.close()
            rx.close()


@pytest.mark.parametrize("consumer,producer", [("ref", "port"),
                                               ("port", "ref")])
def test_cross_package_producer_and_consumer(consumer, producer):
    """A port producer posts into a reference ring, and the reverse: the
    records, the frame_seq gate and the parked flag read the same."""
    rx, tx = _pair_rings(CTRL[consumer], CTRL[producer])
    try:
        posted, n, got, backlog = _roundtrip(rx, tx)
        assert posted == [True] * 5 and n == 5 and backlog == 0
        assert got == [(3, 100 + i, bytes([i]) * (i + 1)) for i in range(5)]
        assert tx.post(3, 9, b"gated", 3)
        assert rx.drain(lambda *a: None, lambda: 2) == 0
        assert rx.drain(lambda *a: None, lambda: 3) == 1
        rx.set_parked(True)
        assert tx.post(1, 1, b"k", 0) == 2
    finally:
        tx.close()
        rx.close()


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

PAYLOAD = np.ones((512, 512), np.float32)  # 1 MiB


def _consume(req_iter):
    total = 0
    for tree in req_iter:
        x = tree["x"]
        total += (x.numel() * x.element_size() if torch.is_tensor(x)
                  else np.asarray(x).nbytes)
    yield {"bytes": np.int64(total)}


def _sink_server(pkg):
    if pkg is REF:
        srv = REF.server.Server(max_workers=4, native_dataplane=False)
        ref_add_tensor_method(srv, "Sink", _consume, kind="stream_stream")
    else:
        srv = PORT.server.Server(max_workers=4, native_dataplane=False)
        add_tensor_method(srv, "Sink", _consume, kind="stream_stream")
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _duplex(pkg, ch, k):
    trees = ({"x": PAYLOAD if pkg is REF else torch.from_numpy(PAYLOAD)}
             for _ in range(k))
    if pkg is REF:
        return list(RefClient(ch).duplex("Sink", trees, native=False,
                                          timeout=120))
    return list(TensorClient(ch).duplex("Sink", trees, native=False,
                                        timeout=120))


def _ref_counts():
    m = ref_metrics.registry().metrics()
    return {"sent": m["rdv_transfers_sent"].snapshot(),
            "ctrl_frames": m["rdv_ctrl_frames"].snapshot(),
            "ctrl_posts": m["ctrl_ring_posts"].snapshot()}


def _port_counts(links):
    return {k: sum(link.stats()[k] for link in links)
            for k in ("sent", "ctrl_frames", "ctrl_posts")}


def _links(ch, srv):
    """The port links of a scenario: the channel's and the server's (the
    reference's count process-wide)."""
    out = []
    if isinstance(ch, PORT.channel.Channel) and ch._conn is not None:
        out.append(ch._conn.rdv)
    if isinstance(srv, PORT.server.Server):
        out += [c.rdv for c in list(srv._connections)]
    return [link for link in out if link is not None]


def _counts(ch, srv):
    port = _port_counts(_links(ch, srv))
    ref = _ref_counts()
    return {k: port[k] + ref[k] for k in port}


def _steady_stream(server_pkg, client_pkg, n=8):
    """A warm stream (hello, first claims, standing grants), then ``n``
    standing transfers: the deltas of transfers, framed control ops and
    ring posts over both packages' counters, and the armed planes."""
    srv, port = _sink_server(server_pkg)
    try:
        with client_pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
            _duplex(client_pkg, ch, 2)
            before = _counts(ch, srv)
            replies = _duplex(client_pkg, ch, n)
            after = _counts(ch, srv)
            armed = []
            if client_pkg is PORT:
                armed.append(ch._conn.ctrl is not None
                             and ch._conn.ctrl.armed)
            if server_pkg is PORT:
                armed += [c.ctrl is not None and c.ctrl.armed
                          for c in srv._connections]
    finally:
        srv.stop(grace=1)
    total = int(np.asarray(replies[-1]["bytes"]).ravel()[0])
    delta = {k: after[k] - before[k] for k in after}
    return total, delta, armed


@pytest.mark.parametrize("name", ["TCP", "RDMA_BPEV"])
def test_steady_state_stream_zero_control_frames(platform, name):
    """After warm-up, a stream of standing transfers does one one-sided
    write and one ring slot per message: no control op is framed, on both
    packages."""
    platform(name)
    for pkg in (REF, PORT):
        total, delta, armed = _steady_stream(pkg, pkg)
        assert total == 8 * PAYLOAD.nbytes, pkg.name
        assert delta["sent"] == 8 and delta["ctrl_frames"] == 0, (
            pkg.name, delta)
        assert delta["ctrl_posts"] >= 8, (pkg.name, delta)
        assert all(armed), armed


@pytest.mark.parametrize("name", ["TCP", "RDMA_BPEV"])
@pytest.mark.parametrize("server,client", [("ref", "port"),
                                           ("port", "ref")])
def test_cross_package_peers_negotiate_the_ring(platform, name, server,
                                                client):
    """A port channel against a reference server, and the reverse: the
    hello blobs open each other's rings, and a steady stream frames no
    control op."""
    platform(name)
    pkgs = {"ref": REF, "port": PORT}
    total, delta, armed = _steady_stream(pkgs[server], pkgs[client])
    assert total == 8 * PAYLOAD.nbytes
    assert delta["sent"] == 8 and delta["ctrl_frames"] == 0, delta
    assert delta["ctrl_posts"] >= 8, delta
    assert armed and all(armed), armed


def test_disabled_env_keeps_framed_control(platform):
    """TPURPC_CTRL_RING=0: transfers still rendezvous, and their control
    ops are framed, on both packages."""
    platform("RDMA_BPEV", TPURPC_CTRL_RING="0")
    for pkg in (REF, PORT):
        srv, port = _sink_server(pkg)
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                before = _counts(ch, srv)
                _duplex(pkg, ch, 4)
                after = _counts(ch, srv)
                planes = ([ch._conn.ctrl] + [c.ctrl for c in srv._connections]
                          if pkg is PORT else [])
        finally:
            srv.stop(grace=1)
        delta = {k: after[k] - before[k] for k in after}
        assert delta["sent"] > 0 and delta["ctrl_frames"] > 0, delta
        assert delta["ctrl_posts"] == 0, delta
        assert planes == [None] * len(planes)


BIG = b"\x6b" * (1 << 20)


def _peer_death(pkg, monkeypatch):
    """The server's sender wedges after its claim (COMPLETE never sent),
    then the server dies: the call gets a status, and the client's link
    releases the claimed region."""
    wedge = threading.Event()
    claimed = threading.Event()
    real = pkg.RdvLink._rdv_write

    def wedged(self, claim, segs, total):
        claimed.set()
        while not wedge.wait(0.05):
            if self.closed:
                raise OSError("link closed while wedged")
        return real(self, claim, segs, total)

    monkeypatch.setattr(pkg.RdvLink, "_rdv_write", wedged)
    srv, port = PORT.server.Server(max_workers=4,
                                   native_dataplane=False), None
    srv.add_method("/pulse.S/Big", PORT.server.unary_unary_rpc_method_handler(
        lambda req, ctx: BIG))
    srv.add_method("/pulse.S/Warm", PORT.server.unary_unary_rpc_method_handler(
        lambda req, ctx: b"ok"))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    outcome = []
    try:
        with PORT.channel.Channel(f"127.0.0.1:{port}") as ch:
            assert ch.unary_unary("/pulse.S/Warm", tpurpc_native=False)(
                b"w", timeout=30) == b"ok"
            conn = ch._conn
            deadline = time.monotonic() + 10
            while not conn.ctrl.armed and time.monotonic() < deadline:
                time.sleep(0.01)
            armed = conn.ctrl.armed

            def call():
                try:
                    ch.unary_unary("/pulse.S/Big", tpurpc_native=False)(
                        b"x", timeout=60)
                    outcome.append("OK")
                except PORT.status.RpcError as exc:
                    outcome.append(exc.code().name)

            t = threading.Thread(target=call)
            t.start()
            assert claimed.wait(15), "claim never observed"
            leased = conn.rdv.stats()["claimed_leases"]
            srv.stop(grace=0)  # the peer dies with ring control in flight
            t.join(30)
            hung = t.is_alive()
            released = conn.rdv.stats()["claimed_leases"]
            rings_closed = conn.ctrl.rx is None and conn.ctrl.tx is None
    finally:
        wedge.set()
        srv.stop(grace=0)
    return armed, leased >= 1, hung, outcome, released, rings_closed


@pytest.mark.parametrize("name", ["TCP", "RDMA_BPEV"])
def test_peer_death_with_ring_control_in_flight(platform, monkeypatch, name):
    platform(name)
    armed, leased, hung, outcome, released, closed = _peer_death(
        port_rdv, monkeypatch)
    assert armed and leased and not hung
    assert outcome and outcome[0] in ("UNAVAILABLE", "CANCELLED",
                                      "DEADLINE_EXCEEDED"), outcome
    assert released == 0 and closed


def _async_complete(name):
    rdv, pair = RDV[name], PAIR[name]
    framed, ring = [], []
    link = rdv.RdvLink("t", lambda op, sid, pl: framed.append(op),
                       lambda sid, fl, body: None)
    link.ctrl_post = lambda op, sid, pl: ring.append(op) or True

    def mk_claim(view):
        c = rdv._Claim(7, "k", "h", 0, 1 << 20, b"", standing=False)
        link._windows[("k", "h")] = pair.Window(
            write=lambda off, data: None, view=view)
        return c

    link.rdv_complete(mk_claim(None), 1, 0, 64)  # async domain: framed
    out = [list(framed), list(ring)]
    framed.clear()
    link.rdv_complete(mk_claim(memoryview(bytearray(8))), 1, 0, 64)
    return out + [list(framed), list(ring)]


@pytest.mark.parametrize("name", PKGS)
def test_async_domain_complete_stays_framed(name):
    """A COMPLETE whose payload went through a domain with no mapped view
    (tcp_window records) rides the framed path, which the record stream
    orders after the bytes; a view-backed one rides the ring."""
    c = RDV[name].OP_COMPLETE
    assert _async_complete(name) == [[c], [], [], [c]]


# ---------------------------------------------------------------------------
# the coalesced framed path
# ---------------------------------------------------------------------------

class _FakeEndpoint:
    def __init__(self):
        self.writes = []

    def write(self, segs):
        if isinstance(segs, (bytes, bytearray, memoryview)):
            segs = [segs]
        self.writes.append(b"".join(bytes(s) for s in segs))


class _ReplayEndpoint:
    def __init__(self, blob):
        self._blob = memoryview(bytes(blob))
        self._pos = 0

    def read_into(self, dst, timeout=None):
        n = min(len(dst), len(self._blob) - self._pos)
        dst[:n] = self._blob[self._pos:self._pos + n]
        self._pos += n
        return n


def _batch_writes(fr):
    ep = _FakeEndpoint()
    w = fr.FrameWriter(ep)
    with w.batch():
        for sid in (1, 3, 5):
            w.send_many([(fr.HEADERS, 0, sid, b"h" * 8),
                         (fr.MESSAGE, fr.FLAG_END_STREAM, sid, b"m" * 16)])
    r = fr.FrameReader(_ReplayEndpoint(ep.writes[0]))
    seen = []
    while True:
        f = r.read_frame()
        if f is None:
            break
        seen.append((f.type, f.stream_id))
    return ep.writes, w.frames_sent, seen


@pytest.mark.parametrize("name", PKGS)
def test_framewriter_batch_one_writev(name):
    fr = FR[name]
    writes, frames_sent, seen = _batch_writes(fr)
    assert len(writes) == 1  # six frames, ONE gathered writev
    assert frames_sent == 6
    assert seen == [(fr.HEADERS, 1), (fr.MESSAGE, 1), (fr.HEADERS, 3),
                    (fr.MESSAGE, 3), (fr.HEADERS, 5), (fr.MESSAGE, 5)]


def test_framewriter_batches_and_coalesces_like_reference():
    """The same frames through each package's writer, batched, coalesced
    or plain, fragmenting or not, give the same writev segments' bytes and
    the same frame counts."""
    def run(fr):
        out = [_batch_writes(fr)[:2]]
        for coalesce in (False, True):
            ep = _FakeEndpoint()
            w = fr.FrameWriter(ep, coalesce=coalesce)
            w.send(fr.PING, 0, 0, b"\x00tpurpc-rdv1")
            w.send_many([(fr.MESSAGE, 0, 1, [b"a" * 10, b"b" * 20]),
                         (fr.TRAILERS, fr.FLAG_END_STREAM, 1, b"t" * 7)])
            w.send(fr.MESSAGE, 0, 3, b"z" * ((1 << 20) + 5))  # fragments
            w.send_many([(fr.MESSAGE, 0, 5, b"y" * ((1 << 20) + 1)),
                         (fr.TRAILERS, 0, 5, b"")])
            w.send(fr.CTRL_KICK, 0, 0, b"")
            out.append((ep.writes, w.frames_sent))
        return out

    assert run(port_fr) == run(ref_fr)


@pytest.mark.parametrize("name", PKGS)
def test_ctrl_frame_coalescer_self_clocking(name):
    """Ops arriving while a flush is in flight leave in ONE multi-op
    send."""
    sent_single, sent_multi = [], []
    gate, release = threading.Event(), threading.Event()

    def send_op(op, sid, payload):
        sent_single.append((op, sid))
        gate.set()
        release.wait(5)

    def send_ops(ops):
        sent_multi.append([o[:2] for o in ops])

    co = RDV[name]._CtrlFrameCoalescer(send_op, send_ops)
    t = threading.Thread(target=lambda: co.send(3, 1, b"a"))
    t.start()
    assert gate.wait(5)  # the first op is mid-flush
    co.send(3, 2, b"b")  # queued while in flight
    co.send(3, 3, b"c")
    release.set()
    t.join(5)
    assert sent_single == [(3, 1)]
    assert sent_multi == [[(3, 2), (3, 3)]]  # one flush for the burst


def _headers_per_write(blob: bytes):
    """HEADERS frames in one writev's bytes."""
    hdr = port_fr.HEADER_FMT
    pos = n = 0
    while pos + hdr.size <= len(blob):
        ftype, _fl, _sid, ln = hdr.unpack_from(blob, pos)
        n += ftype == port_fr.HEADERS
        pos += hdr.size + ln
    return n


def test_migrate_burst_one_writev(platform):
    """Migrating three live sequences sends the OfferKv burst (and the
    CompleteKv burst) as one writev each (``Channel.batch_calls``), and
    every sequence moves."""
    platform("TCP")
    from tpurpc_torch.serving.disagg import migrate, serve_decode
    from tpurpc_torch.torchshim.generate import ToyDecodeModel

    srv_a, port_a, sched_a, state_a = serve_decode(
        ToyDecodeModel(step_delay_s=0.004, device="cpu"), kv_blocks=256,
        name="pulse-src")
    srv_b, port_b, sched_b, state_b = serve_decode(
        ToyDecodeModel(step_delay_s=0.004, device="cpu"), kv_blocks=256,
        name="pulse-dst")
    ch_b = PORT.channel.Channel(f"127.0.0.1:{port_b}")
    writes = []
    try:
        conn = ch_b._connection()
        ep = conn.writer._ep
        real = ep.write

        def counting(data):
            segs = [data] if isinstance(data, (bytes, bytearray,
                                               memoryview)) else data
            writes.append(b"".join(bytes(s) for s in segs))
            return real(data)

        ep.write = counting
        prompts = [[3, 1, 4, 1], [2, 7, 1, 8], [1, 6, 1, 8]]
        streams = [sched_a.submit(np.array(p, np.int32), max_tokens=200)
                   for p in prompts]
        for s in streams:  # a few tokens, so that KV exists
            for _ in range(3):
                s.next(timeout=5)
        moved, failed = migrate(state_a, ch_b, f"127.0.0.1:{port_b}")
    finally:
        ch_b.close()
        for srv, sched, state in ((srv_a, sched_a, state_a),
                                  (srv_b, sched_b, state_b)):
            srv.stop(grace=0)
            sched.close()
            state.close()
            state.mgr.close()
    assert (moved, failed) == (3, 0)
    per_write = [_headers_per_write(w) for w in writes]
    assert per_write.count(3) >= 2, per_write  # offers, then completes
