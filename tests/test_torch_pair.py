"""The port's pair against the reference's: twins of ``tests/test_pair.py``
on ``create_loopback_pair``, each run on both packages with the
observations compared, plus park episodes across the packages.

A scenario is a function of one package's pair and poller modules that
returns plain values (bytes received, states by name, counters, pool
deltas); the test runs it on the reference and on the port and asserts
the two observations are equal. Park episodes are driven as the
reference's tests drive them: ``maybe_park(now, 0.0)`` starts one and a
bounded pump of both notify streams completes it. Every wait is bounded.
"""

import os
import selectors
import socket
import subprocess
import sys
import threading
import time
import types

import pytest

import torch_ranks
import tpurpc_torch.rpc as PORT_RPC
from torch_call_plane import counted_plain, platform  # noqa: F401
from tpurpc.core import _native as ref_native
from tpurpc.core import pair as ref_pair
from tpurpc.core import poller as ref_poller
from tpurpc.utils import config as ref_config
from tpurpc_torch.core import _native as port_native
from tpurpc_torch.core import pair as port_pair
from tpurpc_torch.core import poller as port_poller
from tpurpc_torch.utils import config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = types.SimpleNamespace(name="ref", P=ref_pair, poller=ref_poller,
                            config=ref_config)
PORT = types.SimpleNamespace(name="port", P=port_pair, poller=port_poller,
                             config=port_config)


@pytest.fixture(autouse=True)
def _fresh_singletons():
    ref_native.load()  # the reference's first-use build, outside any wait
    port_native.load()  # and the port's, outside deadlines too
    yield
    for pkg in (REF, PORT):
        pkg.poller.Poller.reset()
        pkg.poller.PairPool.reset()
        pkg.P.RingPool.reset()
        pkg.config.set_config(None)


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on each package; assert the
    observations agree and return the port's."""
    got = {pkg.name: scenario(pkg, *args) for pkg in (REF, PORT)}
    assert got["port"] == got["ref"], got
    return got["port"]


def _wait_readable(pkg, pair, timeout=5, discipline="event"):
    return pkg.poller.wait_readable(pair, timeout=timeout,
                                    discipline=discipline)


def _destroy(*pairs):
    for p in pairs:
        p.destroy()


# ---------------------------------------------------------------------------
# lifecycle, flow control, wakeups
# ---------------------------------------------------------------------------

def _roundtrip(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    try:
        out = [a.state.name]
        a.send([b"ping"])
        assert _wait_readable(pkg, b)
        out.append(b.recv())
        b.send([b"pong", b"!"])
        assert _wait_readable(pkg, a)
        out.append(a.recv())
        out.append((a.total_sent, a.total_recv))
        return out
    finally:
        _destroy(a, b)


def test_loopback_roundtrip():
    assert both(_roundtrip) == ["CONNECTED", b"ping", b"pong!", (4, 5)]


def _partial_send(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=1024)
    try:
        payload = bytes(range(256)) * 40  # 10240 bytes, far past the ring
        sent = a.send([payload])
        first, stalled = sent, a.want_write
        retry = a.send([payload], byte_idx=sent)
        received = bytearray()
        deadline = time.monotonic() + 10
        while ((sent < len(payload) or len(received) < len(payload))
               and time.monotonic() < deadline):
            received += b.recv()
            if sent < len(payload):
                sent += a.send([payload], byte_idx=sent)
        return (0 < first < len(payload), stalled, retry,
                bytes(received) == payload, a.want_write)
    finally:
        _destroy(a, b)


def test_partial_send_and_credit_resume():
    assert both(_partial_send) == (True, True, 0, True, False)


def _chunking(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=1 << 16)
    try:
        payload = b"z" * 1000
        n = a.send([payload])
        got = bytearray()
        deadline = time.monotonic() + 10
        while len(got) < 1000 and time.monotonic() < deadline:
            got += b.recv()
        return n, bytes(got) == payload, b.reader.seq
    finally:
        _destroy(a, b)


def test_send_chunking_respects_chunk_size(monkeypatch):
    monkeypatch.setenv("TPURPC_SEND_CHUNK_SIZE", "128")
    for pkg in (REF, PORT):
        pkg.config.set_config(None)
    # eight 128-byte ring messages in one call, in both packages
    assert both(_chunking) == (1000, True, 8)


def _graceful_close(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    try:
        a.send([b"last words"])
        a.disconnect()
        out = [a.state.name]
        assert _wait_readable(pkg, b)
        out.append(b.get_status().name)
        out.append(b.recv())
        return out
    finally:
        _destroy(a, b)


def test_graceful_close_half_close_then_drain():
    assert both(_graceful_close) == ["DISCONNECTED", "HALF_CLOSED",
                                     b"last words"]


def _abrupt_death(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    try:
        b.notify_sock.close()  # the peer dies without a disconnect
        b.notify_sock = None
        deadline = time.monotonic() + 5
        while (a.get_status() is pkg.P.PairState.CONNECTED
               and time.monotonic() < deadline):
            a.drain_notifications()
            time.sleep(0.01)
        try:
            a.send([b"into the void"])
            raised = None
        except BrokenPipeError:
            raised = "BrokenPipeError"
        return a.state.name, raised
    finally:
        _destroy(a, b)


def test_abrupt_peer_death_detected():
    assert both(_abrupt_death) == ("ERROR", "BrokenPipeError")


def _tripwire(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    try:
        with a._send_guard:
            try:
                a.send([b"nope"])
                return None
            except AssertionError as exc:
                return str(exc)
    finally:
        _destroy(a, b)


def test_reentrancy_tripwire():
    assert both(_tripwire) == "concurrent entry into Pair.send"


def _pool_revival(pkg):
    pool = pkg.poller.PairPool(max_idle_per_key=4)
    p1 = pool.take("server:1234")
    try:
        p1._mark_error("synthetic")
        pool.putback("server:1234", p1)
        idle = pool.idle_count("server:1234")
        p2 = pool.take("server:1234")
        return idle, p2 is p1, p2.state.name, p2.error
    finally:
        p1.destroy()
        pool.drain()


def test_pair_pool_revival():
    assert both(_pool_revival) == (1, True, "INITIALIZED", None)


def _hybrid_wakeup(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    poller = pkg.poller.Poller.get()
    poller.add_pollable(b)
    release = threading.Event()

    def late_send():
        release.wait(10)
        a.send([b"wake up"])

    t = threading.Thread(target=late_send)
    t.start()
    try:
        # the send is held until the waiter is in its wait
        threading.Timer(0.15, release.set).start()
        ok = _wait_readable(pkg, b, timeout=10, discipline="hybrid")
        return ok, b.recv()
    finally:
        release.set()
        t.join(10)
        poller.remove_pollable(b)
        _destroy(a, b)


def test_poller_hybrid_wakeup():
    assert both(_hybrid_wakeup) == (True, b"wake up")


def _busy_spin(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    try:
        t0 = time.monotonic()
        early = _wait_readable(pkg, b, timeout=0.05, discipline="busy")
        bounded = time.monotonic() - t0 < 2
        a.send([b"x"])
        return early, bounded, _wait_readable(pkg, b, timeout=1,
                                              discipline="busy")
    finally:
        _destroy(a, b)


def test_busy_discipline_bounded_spin():
    assert both(_busy_spin) == (False, True, True)


def _shm_same_process(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096,
                                      domain=pkg.P.ShmDomain())
    try:
        a.send([b"via /dev/shm"])
        assert _wait_readable(pkg, b)
        return b.recv(), a.recv_region.handle.startswith("shm:")
    finally:
        _destroy(a, b)


def test_shm_domain_same_process():
    assert both(_shm_same_process) == (b"via /dev/shm", True)


_ECHO_CHILD = r"""
import os, socket, sys
os.nice(10)
sys.path.insert(0, {repo!r})
from tpurpc_torch.core.pair import Pair, PairState, ShmDomain
from tpurpc_torch.core.poller import wait_readable
sock = socket.create_connection(("127.0.0.1", int(sys.argv[1])), timeout=30)
pair = Pair(ShmDomain(), ring_size=8192)
pair.init()
pair.connect_over_socket(sock)
echoed = 0
while echoed < 3:
    if wait_readable(pair, timeout=10, discipline="event"):
        data = pair.recv()
        if data:
            pair.send([b"echo:", data])
            echoed += 1
        elif pair.get_status() is not PairState.CONNECTED:
            break
pair.destroy()
print("CHILD_OK", flush=True)
"""


def _cross_process_echo(pkg):
    """The parent is ``pkg``'s pair; the child, a spawned process, is the
    port's echo server. Rings in POSIX shm, bootstrap and events over a
    loopback socket."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    lst.settimeout(60)
    env = dict(os.environ, TPURPC_TORCH_DEVICE="cpu")
    env.pop("JAX_PLATFORMS", None)
    fd = torch_ranks._lock()
    child = subprocess.Popen(
        [sys.executable, "-c", _ECHO_CHILD.format(repo=REPO),
         str(lst.getsockname()[1])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    got = []
    try:
        sock, _ = lst.accept()
        pair = pkg.P.Pair(pkg.P.ShmDomain(), ring_size=8192)
        pair.init()
        pair.connect_over_socket(sock)
        try:
            for i in range(3):
                msg = f"msg-{i}".encode() * (i + 1)
                pair.send([msg])
                out = b""
                deadline = time.monotonic() + 10
                while (len(out) < len(msg) + 5
                       and time.monotonic() < deadline):
                    if _wait_readable(pkg, pair, timeout=5):
                        out += pair.recv()
                got.append(out == b"echo:" + msg)
            pair.disconnect()
        finally:
            pair.destroy()
        out, err = child.communicate(timeout=60)
        assert child.returncode == 0, err[-3000:]
        got.append("CHILD_OK" in out)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        lst.close()
        torch_ranks._unlock(fd)
    return got


def test_shm_cross_process_echo():
    assert both(_cross_process_echo) == [True, True, True, True]


def _asymmetric(pkg):
    domain = pkg.P.LocalDomain()
    a = pkg.P.Pair(domain, ring_size=1024)
    b = pkg.P.Pair(domain, ring_size=65536)
    a.init()
    b.init()
    sa, sb = socket.socketpair()
    t = threading.Thread(target=b.connect_over_socket, args=(sb,))
    t.start()
    a.connect_over_socket(sa)
    t.join(10)
    try:
        caps = (a.writer.layout.capacity, b.writer.layout.capacity)
        a.send([b"a" * 2000])  # fits b's ring
        return caps, b.recv() == b"a" * 2000
    finally:
        _destroy(a, b)


def test_asymmetric_ring_sizes():
    assert both(_asymmetric) == ((65536, 1024), True)


def test_bootstrap_negotiates_park_and_rdv_caps():
    """Both packages advertise ``rdv`` (rendezvous on) and ``park``, and
    ``waitflag`` when their own native library is loaded."""
    expect = {"park"}
    if os.environ.get("TPURPC_RENDEZVOUS", "1").lower() not in (
            "0", "off", "false"):
        expect.add("rdv")
    a, b = port_pair.create_loopback_pair()
    try:
        extra = {"waitflag"} if port_native.load() is not None else set()
        assert a.peer_caps == b.peer_caps == frozenset(expect | extra)
    finally:
        _destroy(a, b)
    ra, rb = ref_pair.create_loopback_pair()
    try:
        extra = {"waitflag"} if ref_native.load() is not None else set()
        assert ra.peer_caps == frozenset(expect | extra)
    finally:
        _destroy(ra, rb)


def _notify_count(pkg, a, msgs):
    sent = []
    orig = a._notify

    def counting(token):
        sent.append(token)
        orig(token)

    a._notify = counting
    for m in msgs:
        a.send([m])
    del a._notify
    return sent


def test_peer_without_waitflag_always_notified():
    """A peer that advertised no ``waitflag`` gets a data token on every
    send, in both packages; the port never skips one (it has no waiter
    words)."""
    msgs = [b"x", b"yy", b"zzz"]
    for pkg in (REF, PORT):
        a, b = pkg.P.create_loopback_pair()
        try:
            a.peer_caps = frozenset()  # a legacy peer
            assert _notify_count(pkg, a, msgs) == [b"d"] * 3
        finally:
            _destroy(a, b)


def test_address_caps_roundtrip_and_legacy_blob():
    import json

    for P in (ref_pair, port_pair):
        addr = P.Address("t", "local", 4096, "r", "s", caps=["park"])
        # the same bytes in both packages, and each parses the other's
        assert addr.to_bytes() == ref_pair.Address(
            "t", "local", 4096, "r", "s", caps=["park"]).to_bytes()
        assert P.Address.from_bytes(addr.to_bytes()).caps == {"park"}
        legacy = json.dumps({"tag": "t", "domain": "local",
                             "ring_size": 4096, "ring": "r",
                             "status": "s"}).encode()
        assert P.Address.from_bytes(legacy).caps == frozenset()


# ---------------------------------------------------------------------------
# idle-pair parking
# ---------------------------------------------------------------------------

def _pump(a, b):
    """One unconditional drain of both notify streams."""
    if b.drain_notifications():
        b.kick()
    if a.drain_notifications():
        a.kick()


def _pump_until(a, b, pred, rounds=2000):
    for _ in range(rounds):
        if pred():
            return True
        _pump(a, b)
        time.sleep(0.001)
    return pred()


def _park(a, b):
    assert a.maybe_park(time.monotonic(), 0.0), "idle pair refused to park"
    assert _pump_until(a, b, lambda: a._parked or not a._park_pending)
    return a._parked


def _send_all(a, b, sender, payload):
    sent = 0
    deadline = time.monotonic() + 5
    while sent < len(payload) and time.monotonic() < deadline:
        _pump(a, b)
        sent += sender.send([payload], sent)
    return sent


def _recv_n(pkg, pair, n):
    got = bytearray()
    deadline = time.monotonic() + 5
    while len(got) < n and time.monotonic() < deadline:
        if _wait_readable(pkg, pair, timeout=1):
            got += pair.recv()
    return bytes(got)


def _park_and_wake(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    try:
        pool = pkg.P.RingPool.get()
        base = pool.stats()["free_bytes"]
        parked = _park(a, b)
        st = pool.stats()
        out = [parked, st["free_bytes"] - base,
               a.recv_region is None and a.reader is None,
               a.resident_bytes_est() <= 4096]
        # the peer's demand wakes the pair: the first send reports 0 with
        # the WAKE in flight, the retry lands on the re-armed rings
        payload = b"wake-traffic" * 8
        sent = b.send([payload])
        out.append(sent)
        out.append(_pump_until(a, b, lambda: not a._parked))
        sent += _send_all(a, b, b, payload[sent:]) if sent < len(payload) \
            else 0
        out.append(_recv_n(pkg, a, len(payload)) == payload)
        out.append(a.parked_epochs)
        return out
    finally:
        _destroy(a, b)


def test_park_releases_rings_and_unpark_restores_traffic():
    assert both(_park_and_wake) == [True, 4096 + port_pair.STATUS_BYTES,
                                    True, True, 0, True, True, 1]


def _epochs(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    out = []
    try:
        for epoch in range(1, 4):
            assert _park(a, b)
            if epoch % 2:
                a.unpark()  # local demand
            else:
                b.send([b"x"])  # remote demand
            assert _pump_until(a, b, lambda: not a._parked
                               and a.writer is not None
                               and b.writer is not None)
            msg = f"epoch-{epoch}".encode()
            _send_all(a, b, b, msg)
            got = _recv_n(pkg, a, len(msg))
            a.send([b"ack"])
            assert _wait_readable(pkg, b)
            out.append((got, b.recv(), a.parked_epochs))
        return out
    finally:
        _destroy(a, b)


def test_park_epochs_survive_both_wake_directions():
    assert both(_epochs) == [(b"epoch-1", b"ack", 1), (b"epoch-2", b"ack", 2),
                             (b"epoch-3", b"ack", 3)]


def _park_abort(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    try:
        started = a.maybe_park(time.monotonic(), 0.0)  # PARK not yet seen
        payload = b"raced-bytes!"
        n = b.send([payload])  # lands in a's live ring
        resolved = _pump_until(a, b, lambda: not a._park_pending)
        out = [started, n, resolved, a._parked, a.recv()]
        # the retained re-arm restored b's exact write position
        out.append(_pump_until(a, b, lambda: b.writer is not None
                               and not b._peer_parked))
        out.append(b.send([b"after"]))
        assert _wait_readable(pkg, a)
        out.append(a.recv())
        return out
    finally:
        _destroy(a, b)


def test_park_aborts_when_bytes_race_the_ack():
    assert both(_park_abort) == [True, 12, True, False, b"raced-bytes!",
                                 True, 5, b"after"]


def _parked_recv_send(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    try:
        out = [_park(a, b), a.recv()]  # parked, not closed
        sent = a.send([b"local-demand"])  # a local send unparks
        out.append(a._parked)
        _send_all(a, b, a, b"local-demand"[sent:]) if sent < 12 else None
        assert _wait_readable(pkg, b)
        out.append(b.recv())
        return out
    finally:
        _destroy(a, b)


def test_parked_pair_recv_reads_zero_and_send_unparks():
    assert both(_parked_recv_send) == [True, b"", False, b"local-demand"]


def _maintenance(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    out = []
    try:
        with a._send_guard.maintenance():
            try:
                a._send_guard.__enter__()
            except pkg.P._ParkBusy:
                out.append("ParkBusy")
        with a._send_guard:
            try:
                a._send_guard.__enter__()
            except AssertionError as exc:
                out.append(str(exc))
        a.send([b"still-works"])
        assert _wait_readable(pkg, b)
        out.append(b.recv())
        return out
    finally:
        _destroy(a, b)


def test_maintenance_guard_entry_is_retryable_not_a_tripwire():
    assert both(_maintenance) == ["ParkBusy", "concurrent entry into Pair.send",
                                  b"still-works"]


def _destroy_parked(pkg):
    a, b = pkg.P.create_loopback_pair(ring_size=4096)
    parked = _park(a, b)
    a.destroy()
    b.destroy()
    return parked, pkg.P.RingPool.get().stats()["leased_regions"]


def test_destroy_while_parked_forgets_pool_accounting():
    assert both(_destroy_parked) == (True, 0)


def test_ring_pool_zeroes_caps_and_drains():
    """RingPool's accounting in both packages: a released region comes back
    zeroed to the next lease of its size class, a non-pooled domain's is
    closed, the byte cap holds, and drain empties the free list."""
    for P in (ref_pair, port_pair):
        pool = P.RingPool()
        dom = P.LocalDomain()
        r = pool.lease(dom, 4096)
        r.buf[:4] = b"junk"
        assert pool.stats() == {"free_bytes": 0, "free_regions": 0,
                                "leased_bytes": 4096, "leased_regions": 1}
        pool.release(r)
        assert pool.stats() == {"free_bytes": 4096, "free_regions": 1,
                                "leased_bytes": 0, "leased_regions": 0}
        again = pool.lease(dom, 4096)
        assert again is r and bytes(again.buf[:4]) == bytes(4)
        pool.forget(again)
        assert pool.stats()["leased_regions"] == 0

        class Odd(P.LocalDomain):
            kind = "odd"

        closed = []
        odd = P.LocalDomain.alloc(Odd(), 64)
        odd.handle = "odd:" + odd.handle
        odd._close, inner = (lambda: closed.append(1)), odd._close
        pool.release(odd)
        assert closed == [1] and pool.stats()["free_regions"] == 0
        inner()
        pool._MAX_FREE_BYTES = 8192
        regions = [pool.lease(dom, 4096) for _ in range(3)]
        for reg in regions:
            pool.release(reg)
        assert pool.stats()["free_bytes"] == 8192  # the third was closed
        pool.drain()
        assert pool.stats()["free_regions"] == 0
        again.close()


# ---------------------------------------------------------------------------
# the park protocol across the packages
# ---------------------------------------------------------------------------

def test_park_tokens_are_the_references():
    for name in ("NOTIFY_DATA", "NOTIFY_CREDIT", "NOTIFY_EXIT", "NOTIFY_PARK",
                 "NOTIFY_PARK_ACK", "NOTIFY_PARK_NACK", "NOTIFY_WAKE",
                 "NOTIFY_REARM", "NOTIFY_REARM_KEEP", "_BOOTSTRAP_MAGIC",
                 "STATUS_BYTES", "_MAX_BLOB"):
        assert getattr(port_pair, name) == getattr(ref_pair, name), name


def _rearm_frame(P, pair, retained):
    frames = []
    pair._send_frame = lambda payload, timeout_s=5.0: frames.append(
        payload) or True
    try:
        pair._send_rearm(retained=retained)
    finally:
        del pair._send_frame
    return frames[0]


@pytest.mark.parametrize("retained", [False, True])
def test_rearm_frame_is_byte_identical(retained):
    """The same Address makes the same REARM frame in both packages: the
    token, the bootstrap magic, a little-endian length and the Address
    JSON (its caps made equal, as a port peer's and a native-less
    reference peer's are)."""
    frames = {}
    for name, P in (("ref", ref_pair), ("port", port_pair)):
        a, b = P.create_loopback_pair(ring_size=4096)
        try:
            a.tag = "tagfixed"
            a.recv_region.handle = "local:ring"
            a.status_region.handle = "local:status"
            orig = a.local_address

            def addr(orig=orig, P=P):
                got = orig()
                return P.Address(got.tag, got.domain_kind, got.ring_size,
                                 got.ring_handle, got.status_handle,
                                 caps=["park", "rdv"])

            a.local_address = addr
            frames[name] = _rearm_frame(P, a, retained)
        finally:
            a.destroy()
            b.destroy()
    assert frames["port"] == frames["ref"]
    tok = b"R" if retained else b"r"
    assert frames["port"][:5] == tok + b"TRB1"


def _cross_pairs(initiator: str):
    """A reference pair and a port pair over shm, joined by a socketpair;
    returns ``(parker, peer)`` with the ``initiator`` package parking."""
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
    return (r, p) if initiator == "ref" else (p, r)


def _cross_wait(pkg_of, pair, timeout=1):
    return pkg_of(pair).poller.wait_readable(pair, timeout=timeout,
                                             discipline="event")


def _pkg_of(pair):
    return REF if isinstance(pair, ref_pair.Pair) else PORT


@pytest.mark.parametrize("initiator", ["ref", "port"])
@pytest.mark.parametrize("waker", ["parker", "peer"])
def test_cross_package_park_and_wake(initiator, waker):
    """A park episode between the packages: ``initiator``'s pair parks (its
    regions enter its RingPool), then the parked pair itself or its peer
    sends; the wake completes on both sides and the bytes sent into the
    parked connection arrive intact, both ways."""
    a, b = _cross_pairs(initiator)
    try:
        pool = _pkg_of(a).P.RingPool.get()
        free0 = pool.stats()["free_bytes"]
        assert _park(a, b)
        assert b._peer_parked and b.writer is None
        assert pool.stats()["free_bytes"] - free0 == 8192 + 128
        assert a.recv() == b""
        payload = bytes(range(256)) * 20  # 5120 bytes
        sender, receiver = (a, b) if waker == "parker" else (b, a)
        sent = _send_all(a, b, sender, payload)
        assert sent == len(payload)
        got = bytearray()
        deadline = time.monotonic() + 5
        while len(got) < len(payload) and time.monotonic() < deadline:
            _pump(a, b)
            got += receiver.recv()
        assert bytes(got) == payload
        assert not a._parked and not b._peer_parked
        assert a.parked_epochs == 1
        # and the other way on the re-armed rings
        receiver.send([b"reply"])
        got = b""
        deadline = time.monotonic() + 5
        while len(got) < 5 and time.monotonic() < deadline:
            _pump(a, b)
            got += sender.recv()
        assert got == b"reply"
    finally:
        a.destroy()
        b.destroy()


# ---------------------------------------------------------------------------
# parking under a live RPC connection (the port's server and channel)
# ---------------------------------------------------------------------------

def _both_parked(srv, ch, timeout=15.0):
    """Wait until both ends of the channel's one ring connection are
    parked; the two pairs."""
    cli = ch._conn.endpoint.pair
    srv_pair = srv._connections[0].endpoint.pair
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        # a pair's flag goes up a moment before the parked set takes it
        if (cli._parked and srv_pair._parked
                and port_poller.Poller.get().parked_count() >= 2):
            return cli, srv_pair
        time.sleep(0.01)
    raise AssertionError(f"not parked: client {cli._parked}, "
                         f"server {srv_pair._parked}")


def test_device_ring_connection_parks_and_wakes(platform, counted_plain):
    """``GRPC_PLATFORM_TYPE=TPU`` on the CPU with ``TPURPC_PAIR_PARK_S``:
    after a call both ends park (their host rings go to the pool, the
    parked set holds both), the device ring keeps its storage and tail,
    and the next call wakes the connection and lands at that tail, with
    the same reply."""
    import numpy as np
    import torch

    from chip_smoke import CallPlaneServer
    from torch_call_plane import small_classify
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.torchshim.service import TensorClient

    platform("TPU", TPURPC_PAIR_PARK_S="0.2", TPURPC_HBM_RING_SIZE_KB="1024",
             TPURPC_RING_BUFFER_SIZE_KB="256")
    rig = CallPlaneServer(small_classify())
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    try:
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            client = TensorClient(ch)
            first = client.call("Classify", {"images": torch.from_numpy(x)},
                                timeout=30)
            hbm = rig.ring()
            ptr, tail = hbm.buf.data_ptr(), hbm.stats()["tail"]
            cli, srv_pair = _both_parked(rig.server, ch)
            assert port_poller.Poller.get().parked_count() >= 2
            stats = port_pair.RingPool.get().stats()
            assert stats["free_bytes"] >= 2 * ((256 << 10) + 128)
            assert cli.resident_bytes_est() == srv_pair.resident_bytes_est() \
                == 256
            second = client.call("Classify", {"images": torch.from_numpy(x)},
                                 timeout=30)
            assert not cli._parked and not srv_pair._parked
            assert cli.parked_epochs >= 1 and srv_pair.parked_epochs >= 1
            assert hbm.buf.data_ptr() == ptr
            assert hbm.stats()["tail"] == tail + x.nbytes
            for key in ("logits", "top1"):
                assert torch.equal(first[key], second[key])
    finally:
        rig.server.stop(grace=0)
        port_pair.RingPool.reset()


def test_park_keeps_the_descriptor_ring_and_rendezvous_state(platform):
    """Parking releases only the pair's receive ring and status page, as
    the reference's does: the connection's descriptor rings and its
    rendezvous link (standing grants, landing regions) live beside the
    pair and are untouched, so a stream after the wake still moves one-
    sided with its control ops on the same descriptor ring (no control
    op framed)."""
    import numpy as np

    platform("RDMA_BPEV", TPURPC_PAIR_PARK_S="0.2")
    payload = np.arange(1 << 18, dtype=np.float32).tobytes()  # 1 MiB
    srv = PORT_RPC.Server(max_workers=4, native_dataplane=False)
    srv.add_method("/p.S/Len", PORT_RPC.unary_unary_rpc_method_handler(
        lambda r, c: str(len(bytes(r))).encode()))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with PORT_RPC.Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary("/p.S/Len", tpurpc_native=False)
            for _ in range(3):  # hello, claims, standing grants
                assert mc(payload, timeout=30) == b"1048576"
            conn = ch._conn
            ctrl_rx = conn.ctrl.rx if conn.ctrl is not None else None
            before = conn.rdv.stats()
            _both_parked(srv, ch)
            # the park touched neither plane
            assert conn.ctrl is None or conn.ctrl.rx is ctrl_rx
            assert conn.rdv.stats() == before
            for _ in range(3):
                assert mc(payload, timeout=30) == b"1048576"
            after = conn.rdv.stats()
            assert after["sent"] - before["sent"] == 3
            assert after["ctrl_frames"] == before["ctrl_frames"]
    finally:
        srv.stop(grace=0)
        port_pair.RingPool.reset()
