"""The transport's observability hooks in the port against the reference's:
the host ring (``core/ring.py``), the pair (``core/pair.py``), the poller
(``core/poller.py``), the endpoint and its listener (``core/endpoint.py``),
the descriptor rings (``core/ctrlring.py``) and the frame writer
(``rpc/frame.py``).

Each scenario runs on both packages with the same seeded inputs and the
observations must be equal: counter and histogram deltas, lens hop bytes,
fleet-gauge readings of the scenario's own objects, flight events under the
scenario's own tags, and the profiler stage of equivalent frames. Counters
are process-wide, so only deltas are read. Twins of
``tests/test_flight.py::test_pair_stall_emits_edge_events``,
``tests/test_lens.py::test_streaming_hops_account_ring_traffic`` and
``tests/test_ctrlring.py``'s watchdog and lens cases are here.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

from torch_call_plane import PORT, REF, both, poll
from torch_obs import (clean_obs, counter, fleet_reading, hist,  # noqa: F401
                       hop, mod)


def events(pkg, tag: int, since_ns: int = 0):
    """Names of the flight events under ``tag``, oldest first."""
    return [e["event"] for e in pkg.flight.snapshot(since_ns=since_ns)
            if e["tag"] == tag]


def _seeded(n: int, seed: int = 7) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


# ---------------------------------------------------------------------------
# the host ring
# ---------------------------------------------------------------------------

def _ring_pair(pkg, capacity: int):
    ring = mod(pkg, "core.ring")
    buf = bytearray(capacity)

    def place(off, data):
        buf[off:off + len(data)] = bytes(data)

    return ring.RingWriter(capacity, place), ring.RingReader(buf, capacity)


@pytest.mark.parametrize("size", [1, 1500, 4000])
def test_streaming_hops_account_ring_traffic(size):
    """A ring write and drain land the payload's bytes in the ``send_ring``
    and ``peer_ring`` hops (every ring byte is a copy byte) and in the
    ``ring_*`` counters, with busy time on both hops."""
    def scenario(pkg):
        w, r = _ring_pair(pkg, 8192)
        names = ("ring_msgs_written", "ring_bytes_written",
                 "ring_msgs_read", "ring_bytes_read")
        c0 = [counter(pkg, n) for n in names]
        s0, p0 = hop(pkg, "send_ring"), hop(pkg, "peer_ring")
        payload = _seeded(size)
        w.writev([payload])
        out = bytearray(size)
        got, nmsgs = r.drain_into(out)
        s1, p1 = hop(pkg, "send_ring"), hop(pkg, "peer_ring")
        return (bytes(out) == payload, got, nmsgs,
                [counter(pkg, n) - c for n, c in zip(names, c0)],
                s1[0] - s0[0], s1[2] - s0[2], p1[0] - p0[0], p1[2] - p0[2],
                s1[1] > s0[1], p1[1] > p0[1])

    assert both(scenario) == (True, size, 1, [1, size, 1, size],
                              size, size, size, size, True, True)


@pytest.mark.parametrize("n", [2, 5])
def test_write_many_counts_one_batch(n):
    def scenario(pkg):
        w, r = _ring_pair(pkg, 1 << 14)
        c0 = counter(pkg, "ring_msgs_written"), counter(pkg, "ring_bytes_written")
        s0 = hop(pkg, "send_ring")[0]
        msgs = [_seeded(100 + 37 * i, seed=i) for i in range(n)]
        wrote = w.write_many(msgs)
        out = bytearray(sum(len(m) for m in msgs))
        got = r.drain_into(out)
        return (wrote, got, bytes(out) == b"".join(msgs),
                counter(pkg, "ring_msgs_written") - c0[0],
                counter(pkg, "ring_bytes_written") - c0[1],
                hop(pkg, "send_ring")[0] - s0)

    total = sum(100 + 37 * i for i in range(n))
    assert both(scenario) == ((n, total), (total, n), True, n, total, total)


@pytest.mark.parametrize("how", ["writev", "write_many"])
def test_ring_writer_credit_starve_edges(clean_obs, how):
    """A writer that meets a full ring emits one ``credit-starve-begin``
    per episode, however often it retries, and one ``credit-starve-end``
    when a write resumes, under its owner's tag."""
    def scenario(pkg):
        w, r = _ring_pair(pkg, 1024)
        tag = pkg.flight.tag_for("ringtwin:" + how)
        w.flight_tag = tag
        t0 = time.monotonic_ns()
        fill = _seeded(w.writable_payload())
        w.writev([fill])
        ring = mod(pkg, "core.ring")
        for _ in range(3):
            if how == "writev":
                try:
                    w.writev([b"x" * 64])
                except ring.RingFull:
                    pass
            else:
                assert w.write_many([b"x" * 64]) == (0, 0)
        r.drain_into(bytearray(len(fill)))
        w.update_remote_head(r.take_publish())
        if how == "writev":
            w.writev([b"y" * 64])
        else:
            w.write_many([b"y" * 64, b"z" * 8])
        return events(pkg, tag, t0), w.in_flight()

    assert both(scenario)[0] == ["credit-starve-begin", "credit-starve-end"]


def test_ring_fleet_gauges_read_the_ring_state():
    def scenario(pkg):
        w, r = _ring_pair(pkg, 4096)
        w.writev([_seeded(1000)])
        r.drain_into(bytearray(1000))
        return (fleet_reading(pkg, "ring_in_flight_bytes", w),
                fleet_reading(pkg, "ring_credit_unpublished_bytes", r))

    # one message of 1000 bytes spans 8 + 1000 + 8 ring bytes
    assert both(scenario) == (1016.0, 1016.0)


# ---------------------------------------------------------------------------
# the pair
# ---------------------------------------------------------------------------

def _loopback(pkg, ring_size: int):
    return mod(pkg, "core.pair").create_loopback_pair(ring_size=ring_size)


@pytest.mark.parametrize("ring,send", [(4096, 16384), (8192, 65536)])
def test_pair_stall_emits_edge_events(clean_obs, ring, send):
    """A send past the peer's credits opens a write stall and a credit
    starvation under the pair's tag; draining and resuming closes both
    (the reference's fused native send orders the two begin edges the
    other way round, so the edges are compared as a multiset)."""
    def scenario(pkg):
        a, b = _loopback(pkg, ring)
        try:
            sent = a.send([b"z" * send])
            stalled = sent < send and a.want_write
            first = sorted(events(pkg, a._ftag))
            b.recv(1 << 20)
            a.send([b"tail"])
            return stalled, first, sorted(events(pkg, a._ftag))
        finally:
            a.destroy()
            b.destroy()

    stalled, first, after = both(scenario)
    assert stalled
    assert first == ["credit-starve-begin", "pair-connect",
                     "write-stall-begin"]
    assert after == ["credit-starve-begin", "credit-starve-end",
                     "pair-connect", "write-stall-begin", "write-stall-end"]


def test_pair_lifecycle_events(clean_obs):
    """``pair-connect`` carries the peer's ring size; a graceful close is
    ``pair-disconnect``; an error is ``peer-death``."""
    def scenario(pkg):
        a, b = _loopback(pkg, 8192)
        try:
            a.disconnect()
            b._mark_error("twin: peer gone")
            snap = pkg.flight.snapshot()
            return ([(e["event"], e["a1"]) for e in snap
                     if e["tag"] == a._ftag],
                    [e["event"] for e in snap if e["tag"] == b._ftag])
        finally:
            a.destroy()
            b.destroy()

    assert both(scenario) == ([("pair-connect", 8192), ("pair-disconnect", 0)],
                              ["pair-connect", "peer-death"])


def test_pair_fleet_gauges():
    def scenario(pkg):
        a, b = _loopback(pkg, 4096)
        try:
            names = ("pairs_connected", "pairs_write_stalled",
                     "pairs_msg_waiting", "pairs_parked")
            idle = [fleet_reading(pkg, n, a) for n in names]
            a.send([b"q" * 8000])  # past the credits: a write stall
            busy = [fleet_reading(pkg, n, a) for n in names]
            waiting = fleet_reading(pkg, "pairs_msg_waiting", b)
            resident = fleet_reading(pkg, "pair_resident_bytes_est", a)
            a.disconnect()
            return (idle, busy, waiting, resident > 4096,
                    fleet_reading(pkg, "pairs_connected", a),
                    fleet_reading(pkg, "pairs_write_stalled", a))
        finally:
            a.destroy()
            b.destroy()

    assert both(scenario) == ([1.0, 0.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0],
                              1.0, True, 0.0, 0.0)


@pytest.mark.parametrize("size", [100, 70000])
def test_pair_wire_hop_and_batch_histograms(size):
    """``Pair.send`` is the ``wire`` hop of the ring plane and records its
    ring messages in ``ring_write``; the drain records ``ring_drain``."""
    def scenario(pkg):
        a, b = _loopback(pkg, 1 << 18)
        try:
            w0 = hop(pkg, "wire")[0]
            rw0, rd0 = hist(pkg, "ring_write"), hist(pkg, "ring_drain")
            payload = _seeded(size)
            sent = a.send([payload])
            out = bytearray(size)
            got = 0
            deadline = time.monotonic() + 5
            while got < size and time.monotonic() < deadline:
                got += b.recv_into(memoryview(out)[got:])
            rw1, rd1 = hist(pkg, "ring_write"), hist(pkg, "ring_drain")
            return (sent, bytes(out) == payload, hop(pkg, "wire")[0] - w0,
                    rw1[0] - rw0[0], rw1[1] - rw0[1], rd1[0] - rd0[0],
                    rd1[1] - rd0[1])
        finally:
            a.destroy()
            b.destroy()

    got = both(scenario)
    assert got[:3] == (size, True, size)
    assert got[3] == 1 and got[5] >= 1 and got[4] == got[6] >= 1


def test_ring_pool_counters_and_gauges():
    def scenario(pkg):
        pair = mod(pkg, "core.pair")
        pool = pair.RingPool()
        dom = pair.LocalDomain()
        a0, h0 = counter(pkg, "ring_pool_alloc"), counter(pkg, "ring_pool_hit")
        leased = pkg.metrics.gauge("ring_pool_leased_bytes")
        free = pkg.metrics.gauge("ring_pool_free_bytes")
        r1 = pool.lease(dom, 4096)
        g1 = (leased.snapshot(), free.snapshot())
        pool.release(r1)
        g2 = (leased.snapshot(), free.snapshot())
        r2 = pool.lease(dom, 4096)
        g3 = (leased.snapshot(), free.snapshot())
        pool.forget(r2)
        r2.close()
        g4 = leased.snapshot()
        pool.drain()
        return (counter(pkg, "ring_pool_alloc") - a0,
                counter(pkg, "ring_pool_hit") - h0, g1, g2, g3, g4,
                free.snapshot())

    assert both(scenario) == (1, 1, (4096.0, 0.0), (0.0, 4096.0),
                              (4096.0, 0.0), 0.0, 0.0)


# ---------------------------------------------------------------------------
# the poller
# ---------------------------------------------------------------------------

def test_poller_registered_pairs_gauge():
    def scenario(pkg):
        poller = mod(pkg, "core.poller")
        a, b = _loopback(pkg, 4096)
        p = poller.Poller(thread_num=1)  # never started: no sweeps
        try:
            before = fleet_reading(pkg, "poller_registered_pairs", p)
            p.add_pollable(a)
            p.add_pollable(b)
            mid = fleet_reading(pkg, "poller_registered_pairs", p)
            p.remove_pollable(a)
            return before, mid, fleet_reading(pkg, "poller_registered_pairs",
                                              p)
        finally:
            a.destroy()
            b.destroy()

    assert both(scenario) == (0.0, 2.0, 1.0)


@pytest.mark.parametrize("discipline", ["event", "busy"])
def test_wait_counters_by_discipline(discipline):
    """An event wait that times out sleeps once (``wait_sleep``); a busy
    wait whose message lands while it spins ends in ``wait_spin_hit``."""
    def scenario(pkg):
        poller = mod(pkg, "core.poller")
        a, b = _loopback(pkg, 4096)
        names = ("wait_sleep", "wait_spin_hit", "wait_spin_miss",
                 "wait_spin_skipped")
        try:
            c0 = [pkg.stats.counters_snapshot().get(n, 0) for n in names]
            if discipline == "busy":
                t = threading.Timer(0.05, lambda: a.send([b"m" * 64]))
                t.start()
                ok = poller.wait_readable(b, timeout=5, discipline="busy")
                t.join()
            else:
                ok = poller.wait_readable(b, timeout=0.05,
                                          discipline="event")
            c1 = [pkg.stats.counters_snapshot().get(n, 0) for n in names]
            return ok, [y - x for x, y in zip(c0, c1)]
        finally:
            a.destroy()
            b.destroy()

    ok, deltas = both(scenario)
    if discipline == "busy":
        assert ok is True and deltas == [0, 1, 0, 0]
    else:
        assert ok is False and deltas == [1, 0, 0, 0]


@pytest.mark.skipif(len(os.sched_getaffinity(0)) < 2,
                    reason="hybrid degrades to event on one hart")
def test_hybrid_mode_flips_are_flight_edges(clean_obs):
    """A hybrid waiter whose activity EWMA decayed skips its spin
    (``wait_spin_skipped``) and adopts the event leg (``poller-mode-ev``
    under the pair's tag); a hot pair flips back (``poller-mode-bp``)."""
    def scenario(pkg):
        poller = mod(pkg, "core.poller")
        a, b = _loopback(pkg, 4096)
        try:
            s0 = pkg.stats.counters_snapshot().get("wait_spin_skipped", 0)
            b.activity_ewma = 0.0
            poller.wait_readable(b, timeout=0.02, discipline="hybrid")
            b.activity_ewma = 1.0
            t = threading.Timer(0.05, lambda: a.send([b"x" * 16]))
            t.start()
            poller.wait_readable(b, timeout=5, discipline="hybrid")
            t.join()
            return (pkg.stats.counters_snapshot().get("wait_spin_skipped", 0)
                    - s0, [e for e in events(pkg, b._ftag)
                           if e.startswith("poller")])
        finally:
            a.destroy()
            b.destroy()

    assert both(scenario) == (1, ["poller-mode-ev", "poller-mode-bp"])


def test_poller_sweeps_count_scans_and_batch_wakeups():
    def scenario(pkg):
        poller = mod(pkg, "core.poller")
        a, b = _loopback(pkg, 4096)
        p = poller.Poller(thread_num=1)
        snap = pkg.stats.counters_snapshot
        idle0 = snap().get("poller_scan_idle", 0)
        wk0 = hist(pkg, "poller_batch_wakeups")[0]
        try:
            p.add_pollable(b)
            p.start()
            idle = poll(lambda: snap().get("poller_scan_idle", 0) > idle0, 5)
            a.send([b"w" * 32])
            woke = poll(lambda: hist(pkg, "poller_batch_wakeups")[0] > wk0, 5)
            return bool(idle), bool(woke)
        finally:
            p.stop()
            a.destroy()
            b.destroy()

    assert both(scenario) == (True, True)


# ---------------------------------------------------------------------------
# the endpoint and its listener
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["bytes", "gather"])
def test_tcp_write_is_the_wire_hop(shape):
    def scenario(pkg):
        ep_mod = mod(pkg, "core.endpoint")
        s1, s2 = socket.socketpair()
        ep = ep_mod.TcpEndpoint(s1)
        try:
            payload = _seeded(5000)
            b0 = hop(pkg, "wire")
            ep.write(payload if shape == "bytes"
                     else [payload[:1000], memoryview(payload)[1000:]])
            b1 = hop(pkg, "wire")
            got = b""
            while len(got) < len(payload):
                got += s2.recv(65536)
            return got == payload, b1[0] - b0[0], b1[2] - b0[2]
        finally:
            ep.close()
            s2.close()

    assert both(scenario) == (True, 5000, 5000)


def _listener(pkg, pushback):
    ep_mod = mod(pkg, "core.endpoint")
    got = []
    return ep_mod.EndpointListener("127.0.0.1", 0, got.append,
                                   admission=lambda: pushback), got


@pytest.mark.parametrize("pushback", [25, 100])
def test_accept_gate_sheds_with_event(clean_obs, pushback):
    """A shed connection bumps ``accept_shed`` and emits ``accept-shed``
    under ``accept:<port>`` with the handshakes in flight and the
    pushback."""
    def scenario(pkg):
        lst, got = _listener(pkg, pushback)
        try:
            shed0 = counter(pkg, "accept_shed")
            s = socket.create_connection(("127.0.0.1", lst.port), timeout=5)
            try:
                ok = poll(lambda: counter(pkg, "accept_shed") > shed0, 5)
            finally:
                s.close()
            tag = pkg.flight.tag_for(f"accept:{lst.port}")
            evs = [(e["event"], e["a1"], e["a2"])
                   for e in pkg.flight.snapshot() if e["tag"] == tag]
            return bool(ok), counter(pkg, "accept_shed") - shed0, evs, got
        finally:
            lst.close()

    assert both(scenario) == (True, 1, [("accept-shed", 0, pushback)], [])


def test_reconnect_storm_counts_every_shed(clean_obs):
    """A small storm at a gate that sheds everything: every connection is
    counted and recorded once, and none reaches the endpoint factory."""
    def scenario(pkg):
        lst, got = _listener(pkg, 40)
        try:
            shed0 = counter(pkg, "accept_shed")
            socks = [socket.create_connection(("127.0.0.1", lst.port),
                                              timeout=5) for _ in range(12)]
            try:
                poll(lambda: counter(pkg, "accept_shed") - shed0 >= 12, 10)
            finally:
                for s in socks:
                    s.close()
            tag = pkg.flight.tag_for(f"accept:{lst.port}")
            n_ev = sum(1 for e in pkg.flight.snapshot()
                       if e["tag"] == tag and e["event"] == "accept-shed")
            return counter(pkg, "accept_shed") - shed0, n_ev, len(got)
        finally:
            lst.close()

    assert both(scenario) == (12, 12, 0)


# ---------------------------------------------------------------------------
# the descriptor rings
# ---------------------------------------------------------------------------

def _ctrl_rings(pkg, ftag=0, nslots=8):
    ctrl = mod(pkg, "core.ctrlring")
    rx = ctrl.CtrlRing(kind="shm", nslots=nslots)
    desc = rx.descriptor()
    (n, slot_bytes, nbytes, nonce, klen) = ctrl._DESC.unpack_from(desc)
    pos = ctrl._DESC.size
    kind = desc[pos:pos + klen].decode()
    handle = desc[pos + klen:].decode()
    tx = ctrl.CtrlPeer(kind, handle, n, slot_bytes, nbytes, nonce,
                       ftag=ftag)
    return rx, tx


@pytest.mark.parametrize("n", [1, 5])
def test_ctrl_ring_counts_posts_records_and_batches(n):
    def scenario(pkg):
        rx, tx = _ctrl_rings(pkg)
        try:
            c0 = counter(pkg, "ctrl_ring_posts"), counter(pkg,
                                                          "ctrl_ring_records")
            b0, h0 = hop(pkg, "ctrl"), hist(pkg, "ctrl_ring_batch")
            for i in range(n):
                tx.post(3, 10 + i, bytes([i]) * (i + 3), 0)
            backlog = fleet_reading(pkg, "ctrl_ring_backlog", tx)
            got = []
            rx.drain(lambda *a: got.append(a), lambda: 0)
            h1 = hist(pkg, "ctrl_ring_batch")
            return (len(got), counter(pkg, "ctrl_ring_posts") - c0[0],
                    counter(pkg, "ctrl_ring_records") - c0[1],
                    hop(pkg, "ctrl")[0] - b0[0], h1[0] - h0[0], h1[1] - h0[1],
                    backlog, fleet_reading(pkg, "ctrl_ring_backlog", tx))
        finally:
            tx.close()
            rx.close()

    nbytes = sum(i + 3 for i in range(n))
    assert both(scenario) == (n, n, n, nbytes, 1, n, float(n), 0.0)


def test_ctrl_ring_full_is_a_stall_bracket(clean_obs):
    def scenario(pkg):
        tag = pkg.flight.tag_for("ctrl:twin-full")
        rx, tx = _ctrl_rings(pkg, ftag=tag)
        try:
            f0 = counter(pkg, "ctrl_ring_full_fallbacks")
            for i in range(rx.nslots):
                tx.post(1, i, b"x", 0)
            refused = [tx.post(1, 99, b"x", 0) for _ in range(3)]
            rx.drain(lambda *a: None, lambda: 0)
            placed = bool(tx.post(1, 100, b"x", 0))
            return (refused, placed,
                    counter(pkg, "ctrl_ring_full_fallbacks") - f0,
                    [(e["event"], e["a1"]) for e in pkg.flight.snapshot()
                     if e["tag"] == tag])
        finally:
            tx.close()
            rx.close()

    assert both(scenario) == ([0, 0, 0], True, 3,
                              [("ctrl-stall-begin", 8), ("ctrl-stall-end", 0)])


def test_ctrl_plane_adopt_spin_park_edges(clean_obs):
    """A plane that adopts its peer's ring emits ``ctrl-adopt``; its first
    drained batch turns it hot (``ctrl-spin``), and a park after that
    turns it cold (``ctrl-park``): edges, once each."""
    def scenario(pkg):
        ctrl = mod(pkg, "core.ctrlring")
        pa = ctrl.CtrlPlane("twin-a")
        pb = ctrl.CtrlPlane("twin-b")
        try:
            if pa.rx is None or pb.rx is None:
                return "no shm"
            adopted = (pa.on_hello(pb.hello_blob()),
                       pb.on_hello(pa.hello_blob()))
            kicks0 = counter(pkg, "ctrl_ring_kicks")
            pb.park()
            placed = pa.post(3, 1, b"op", 0, lambda: None)
            got = []
            for _ in range(2):
                pb.drain(lambda *a: got.append(a), lambda: 0)
            pb.unpark()
            pa.post(3, 2, b"op2", 0, lambda: None)
            pb.drain(lambda *a: got.append(a), lambda: 0)
            pb.park()
            pb.park()
            evs = [(e["event"], e["a1"]) for e in pkg.flight.snapshot()
                   if e["tag"] == pb._ftag]
            return (adopted, placed, len(got),
                    counter(pkg, "ctrl_ring_kicks") - kicks0, evs)
        finally:
            pa.close()
            pb.close()

    got = both(scenario)
    assert got[:4] == ((True, True), True, 2, 1)
    assert [e for e, _ in got[4]] == ["ctrl-adopt", "ctrl-spin", "ctrl-park"]


def test_watchdog_names_ctrl_ring_stage():
    """An aged ring-full stall bracket outranks the rendezvous story."""
    def scenario(pkg):
        wd = pkg.watchdog.StallWatchdog(sweep_s=10, min_stall_s=0.2)
        now = time.monotonic_ns()
        ev = {
            "now_ns": now, "open_lease": 0, "open_edges": {},
            "open_rdv": {(7, "o", 1): now - int(2e9)},
            "open_ctrl": {7: now - int(2e9)},
            "ctrl_ring_backlog": 3,
            "open_swap": {}, "open_mig": {}, "open_step": {},
            "last_step_end_ns": 0, "last_step_batch": 0, "last_h2_ns": 0,
            "pairs_write_stalled": 0, "batcher_queue_depth": 0,
            "pairs_msg_waiting": 0, "decode_waiting": 0, "decode_running": 0,
        }
        stage, _ = wd._attribute(ev, "client", int(2e9))
        ev2 = dict(ev, open_ctrl={}, ctrl_ring_backlog=0)
        stage2, _ = wd._attribute(ev2, "client", int(2e9))
        return stage, stage2, "ctrl-ring" in pkg.watchdog.STAGES

    assert both(scenario) == ("ctrl-ring", "rendezvous", True)


def test_watchdog_reads_a_live_ctrl_stall_bracket(clean_obs):
    """The bracket a real full ring leaves in the flight ring is what the
    watchdog gathers as ``open_ctrl`` evidence."""
    def scenario(pkg):
        tag = pkg.flight.tag_for("ctrl:twin-live")
        rx, tx = _ctrl_rings(pkg, ftag=tag)
        try:
            for i in range(rx.nslots + 1):
                tx.post(1, i, b"x", 0)
            wd = pkg.watchdog.get()
            ev = wd._gather_evidence(time.monotonic_ns())
            open_tags = set(ev["open_ctrl"])
            rx.drain(lambda *a: None, lambda: 0)
            tx.post(1, 0, b"x", 0)
            ev2 = wd._gather_evidence(time.monotonic_ns())
            return tag in open_tags, tag in set(ev2["open_ctrl"])
        finally:
            tx.close()
            rx.close()

    assert both(scenario) == (True, False)


def test_lens_ctrl_hop_declared_and_excluded_from_slowest():
    def scenario(pkg):
        rows = [
            {"hop": "rendezvous", "bytes": 1 << 30, "busy_ms": 500.0,
             "gbps": 2.0, "copy_bytes": 0, "what": ""},
            {"hop": "ctrl", "bytes": 4096, "busy_ms": 400.0,
             "gbps": 0.00001, "copy_bytes": 0, "what": ""},
        ]
        return "ctrl" in pkg.lens.HOP_NAMES, pkg.lens.slowest_hop(rows)

    assert both(scenario) == (True, "rendezvous")


# ---------------------------------------------------------------------------
# the frame writer
# ---------------------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.writes = []

    def write(self, segs):
        if isinstance(segs, (bytes, bytearray, memoryview)):
            segs = [segs]
        self.writes.append(b"".join(bytes(s) for s in segs))


@pytest.mark.parametrize("streams", [1, 3])
def test_frame_batch_records_ctrl_call_batch(streams):
    def scenario(pkg):
        fr = mod(pkg, "rpc.frame")
        sink = _Sink()
        w = fr.FrameWriter(sink)
        h0 = hist(pkg, "ctrl_call_batch")
        with w.batch():
            for sid in range(1, 2 * streams, 2):
                w.send_many([(fr.HEADERS, 0, sid, b"h" * 8),
                             (fr.MESSAGE, fr.FLAG_END_STREAM, sid, b"m" * 16)])
        h1 = hist(pkg, "ctrl_call_batch")
        return len(sink.writes), h1[0] - h0[0], h1[1] - h0[1]

    assert both(scenario) == (1, 1, 2 * streams)


def test_coalescing_writer_records_resp_coalesce():
    def scenario(pkg):
        fr = mod(pkg, "rpc.frame")
        sink = _Sink()
        w = fr.FrameWriter(sink, coalesce=True)
        h0 = hist(pkg, "resp_coalesce")
        w.send_many([(fr.HEADERS, 0, 1, b"h"), (fr.MESSAGE, 0, 1, b"m"),
                     (fr.TRAILERS, fr.FLAG_END_STREAM, 1, b"t")])
        h1 = hist(pkg, "resp_coalesce")
        return len(sink.writes), h1[0] - h0[0], h1[1] - h0[1]

    assert both(scenario) == (1, 1, 1)


# ---------------------------------------------------------------------------
# profiler stages: equivalent frames classify alike
# ---------------------------------------------------------------------------

class _Code:
    def __init__(self, filename, name):
        self.co_filename = filename
        self.co_name = name


class _Frame:
    def __init__(self, filename, name):
        self.f_code = _Code(filename, name)
        self.f_back = None


#: (module, [(the reference's function, the port's equivalent)])
STAGE_TWINS = [
    ("core.ring", [("writev", "writev"), ("write_many", "write_many"),
                   ("drain_into", "drain_into")]),
    ("core.pair", [("send", "send"), ("_send_inner", "_send_inner"),
                   ("recv_into", "recv_into"), ("recv", "recv"),
                   ("spin", "spin")]),
    ("core.poller", [("_wait", "_wait"), ("wait_readable", "wait_readable"),
                     ("wait_writable", "wait_writable"),
                     ("_scan_edges", "_scan_edges"), ("_run", "_run")]),
    ("core.endpoint", [("write", "write"), ("_ssl_send_all", "_ssl_send_all"),
                       ("read", "read"), ("read_into", "read_into"),
                       ("_await_readable", "_await_readable")]),
    ("core.ctrlring", [("read_frame_polled", "read_frame_polled"),
                       ("drain", "drain"), ("post", "post")]),
    ("rpc.frame", [("send", "send"), ("send_many", "send_many"),
                   ("_send_fragmented", "_send_fragmented"),
                   ("_flush_pending", "_flush_pending"),
                   ("encode_frame", "encode_frame")]),
    # shares the basename endpoint.py with core.endpoint: both register
    ("tpu.endpoint", [("decode_tensor_to_ring", "decode_tensor_to_ring"),
                      ("decode_tree_to_ring", "decode_tree_to_ring"),
                      ("_parse_tensor_record", "_parse_tensor_record")]),
    ("tpu.hbm_ring", [("place", "place"), ("place_many", "place_many"),
                      ("_pallas_place", "_land_locked"), ("view", "view")]),
    ("core.rendezvous", [("send_message", "send_message"),
                         ("_rdv_write", "_rdv_write"),
                         ("rdv_claim", "rdv_claim"), ("on_offer", "on_offer"),
                         ("on_complete", "on_complete")]),
    ("shim.codec", [("encode_tensor", "encode_tensor"),
                    ("encode_tree", "encode_tree"),
                    ("decode_tensor", "decode_tensor"),
                    ("decode_tree_at", "decode_tree_at"),
                    ("to_jax", "to_torch")]),
    ("shim.service", [("_loop", "_loop"),
                      ("_split_compatible", "_split_compatible"),
                      ("_concat_pad", "_concat_pad"),
                      ("_complete_loop", "_complete_loop"), ("_run", "_run"),
                      ("_merge_loop", "_merge_loop"),
                      ("_dispatch_group", "_dispatch_group"),
                      ("_run_one", "_run_one")]),
    ("wire.grpc_h2", [("send_message", "send_message"),
                      ("_send_unary_fused", "_send_unary_fused"),
                      ("_on_data", "_on_data"), ("_read_loop", "_read_loop")]),
    ("wire.h2_client", [("_send_message", "_send_message"),
                        ("_on_data", "_on_data"),
                        ("_read_loop", "_read_loop")]),
]


@pytest.mark.parametrize("module,pairs", STAGE_TWINS,
                         ids=[m for m, _ in STAGE_TWINS])
def test_equivalent_frames_take_the_same_stage(module, pairs):
    def scenario(pkg):
        f = mod(pkg, module).__file__
        out = []
        for ref_fn, port_fn in pairs:
            fn = ref_fn if pkg is REF else port_fn
            assert callable(_resolve(mod(pkg, module), fn)), fn
            stage, _ = pkg.profiler.StageProfiler.classify(_Frame(f, fn))
            out.append(stage)
        return out

    stages = both(scenario)
    assert "unattributed" not in stages and "other" not in stages


def _resolve(module, name):
    """The function ``name`` in ``module``, at module level or on a class."""
    if hasattr(module, name):
        return getattr(module, name)
    for obj in vars(module).values():
        if isinstance(obj, type) and name in vars(obj):
            return getattr(obj, name)
    return None
