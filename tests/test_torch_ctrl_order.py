"""Framed rendezvous control keeps each reply its own (a port fault fixed,
and a stated divergence: ROADMAP C).

With the descriptor rings off (``TPURPC_CTRL_RING=0``) a rendezvous
COMPLETE leaves through the link's frame coalescer. A sender whose
COMPLETE queued behind another thread's in-flight flush used to return at
once and write its stream's TRAILERS, which could reach the peer before
the COMPLETE: the stream closed with no message ("unary call received no
response"). The coalescer now returns a COMPLETE's sender only once the op
is written. The reference keeps the fault, so these tests run the port
alone.

With the rings on, a COMPLETE record stamps the writer's ``frames_sent``
as its ``frame_seq``, and the peer delivers it once it has dispatched that
many frames. A frame another thread had written but not yet counted let a
record overtake its own stream's HEADERS, and the body was dropped
("deadline exceeded awaiting request"); the writer now counts each frame
under the lock it writes it under (the last test).
"""

import threading
import time

import pytest

from torch_call_plane import PORT, platform  # noqa: F401
from tpurpc_torch.core import rendezvous as rdv

ECHO = "/ctrl.S/Echo"


def _echo_server(workers):
    srv = PORT.server.Server(max_workers=workers, native_dataplane=False)
    srv.add_method(ECHO, PORT.server.unary_unary_rpc_method_handler(
        lambda req, ctx: bytes(req)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _links(ch, srv):
    links = [ch._conn.rdv] if ch._conn is not None else []
    return links + [c.rdv for c in list(srv._connections)]


def _concurrent(threads=8, calls=6):
    """``threads`` callers share one connection, ``calls`` 300 KiB echoes
    each: every reply must be its own request."""
    import sys

    srv, port = _echo_server(threads)
    bad, errors = [], []
    try:
        with PORT.channel.Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary(ECHO, tpurpc_native=False)
            assert bytes(mc(b"tiny", timeout=10)) == b"tiny"

            def worker(t):
                try:
                    for k in range(calls):
                        req = bytes([t, k]) * (150 * 1024)
                        if bytes(mc(req, timeout=60)) != req:
                            bad.append((t, k))
                except Exception as exc:   # surfaced by the assert below
                    errors.append(repr(exc))

            old = sys.getswitchinterval()
            sys.setswitchinterval(1e-5)
            try:
                ts = [threading.Thread(target=worker, args=(t,))
                      for t in range(threads)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(120)
            finally:
                sys.setswitchinterval(old)
            alive = any(t.is_alive() for t in ts)
            stats = [link.stats() for link in _links(ch, srv)]
    finally:
        srv.stop(grace=1)
    counts = {k: sum(s[k] for s in stats)
              for k in ("sent", "received", "fallbacks", "ctrl_posts")}
    framed = sum(s["ctrl_frames"] for s in stats)
    return alive, errors, bad, counts, framed > 0


@pytest.mark.parametrize("pump", ["0", "1"])
def test_framed_control_keeps_each_reply_its_own(platform, pump):
    """8 threads x 6 calls of 300 KiB on one ``RDMA_BPEV`` connection with
    framed control ops, reader thread and inline pump alike: no reply is
    lost or crossed, and every payload moved by rendezvous."""
    platform("RDMA_BPEV", TPURPC_CTRL_RING="0", TPURPC_INLINE_PUMP=pump)
    assert _concurrent() == (False, [], [], {"sent": 96, "received": 96,
                                             "fallbacks": 0,
                                             "ctrl_posts": 0}, True)


# ---------------------------------------------------------------------------
# the coalescer's contract, driven directly
# ---------------------------------------------------------------------------

class _Wire:
    """A fake connection: records every write; the first multi-op write
    (or, with ``block_first``, the first write) waits on ``gate``."""

    def __init__(self, block_first=False, fail=False):
        self.writes = []
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.block_first = block_first
        self.fail = fail

    def _write(self, ops):
        if self.block_first and not self.writes:
            self.entered.set()
            self.gate.wait(10)
            if self.fail:
                raise OSError("connection closed")
        self.writes.append(list(ops))

    def send_op(self, op, sid, payload):
        self._write([(op, sid, payload)])

    def send_ops(self, ops):
        self._write(ops)


def _behind_a_flush(wait, fail=False):
    """Thread A's op is being written (held); thread B queues an op behind
    it. Returns (B returned before A's write finished, the writes, B's
    error)."""
    wire = _Wire(block_first=True, fail=fail)
    co = rdv._CtrlFrameCoalescer(wire.send_op, wire.send_ops)
    a_err = []

    def a():
        try:
            co.send(1, 1, b"a")
        except OSError as exc:
            a_err.append(exc)

    ta = threading.Thread(target=a)
    ta.start()
    assert wire.entered.wait(10)
    b_done = threading.Event()
    tb = threading.Thread(target=lambda: (co.send(2, 3, b"b", wait=wait),
                                          b_done.set()))
    tb.start()
    early = b_done.wait(0.2)
    wire.gate.set()
    ta.join(10)
    tb.join(10)
    return early, b_done.is_set(), wire.writes, len(a_err)


def test_queued_complete_returns_only_once_written():
    early, done, writes, _ = _behind_a_flush(wait=True)
    assert (early, done) == (False, True)
    assert writes == [[(1, 1, b"a")], [(2, 3, b"b")]]


def test_queued_op_without_wait_returns_at_once():
    early, done, writes, _ = _behind_a_flush(wait=False)
    assert (early, done) == (True, True)
    assert writes == [[(1, 1, b"a")], [(2, 3, b"b")]]


def test_failed_flush_releases_its_waiters():
    """A flush that fails (the connection died) drops the queue and wakes
    every waiter: control sends are best effort, and nobody hangs."""
    early, done, writes, a_errors = _behind_a_flush(wait=True, fail=True)
    assert (early, done, writes, a_errors) == (False, True, [], 1)


def test_many_waiters_leave_in_one_batch_in_order():
    wire = _Wire(block_first=True)
    co = rdv._CtrlFrameCoalescer(wire.send_op, wire.send_ops)
    ta = threading.Thread(target=co.send, args=(9, 1, b"first"))
    ta.start()
    assert wire.entered.wait(10)
    ts = []
    for k in range(5):
        t = threading.Thread(target=co.send, args=(rdv.OP_COMPLETE, 2 * k + 3,
                                                   b"%d" % k),
                             kwargs={"wait": True})
        t.start()
        ts.append(t)
        deadline = time.monotonic() + 5
        while len(co._pending) < k + 1 and time.monotonic() < deadline:
            time.sleep(0.001)
    wire.gate.set()
    for t in [ta] + ts:
        t.join(10)
    assert wire.writes == [[(9, 1, b"first")],
                           [(rdv.OP_COMPLETE, 2 * k + 3, b"%d" % k)
                            for k in range(5)]]
    assert co._out == co._queued == 6


def test_link_waits_for_complete_only():
    """``RdvLink`` frames a COMPLETE with ``wait=True`` and every other
    control op without."""
    seen = []

    class Spy:
        def send(self, op, sid, payload, wait=False):
            seen.append((op, wait))

    link = rdv.RdvLink("spy", lambda *a: None, lambda *a: None,
                       send_ops=lambda ops: None)
    link._coalescer = Spy()
    for op in (rdv.OP_OFFER, rdv.OP_CLAIM, rdv.OP_COMPLETE, rdv.OP_RELEASE):
        link._ctrl_send(op, 1, b"")
    assert seen == [(rdv.OP_OFFER, False), (rdv.OP_CLAIM, False),
                    (rdv.OP_COMPLETE, True), (rdv.OP_RELEASE, False)]
    assert link.stats()["ctrl_frames"] == 4


def test_frames_sent_counts_every_frame_on_the_wire():
    """When ``send`` returns, ``frames_sent`` covers every frame already
    written, other threads' too: a thread paused between its write and its
    count holds the writer's lock, so another thread's later frame cannot
    be counted past it. (The reference counts after the lock: ROADMAP C.)"""
    from tpurpc_torch.rpc import frame as fr

    wire = []

    class Endpoint:
        def write(self, segs):
            wire.append(bytes(b"".join(bytes(s) for s in segs)))

    w = fr.FrameWriter(Endpoint())
    wrote = threading.Event()
    release = threading.Event()
    count = w._count_frames

    def paused_count(n):
        if threading.current_thread().name == "paused":
            wrote.set()
            release.wait(5)
        count(n)

    w._count_frames = paused_count
    tb = threading.Thread(target=w.send, args=(fr.PING, 0, 0, b"b"),
                          name="paused")
    tb.start()
    assert wrote.wait(5)
    seen = []

    def later():
        w.send(fr.HEADERS, 0, 1, b"a")
        seen.append((w.frames_sent, len(wire)))

    ta = threading.Thread(target=later)
    ta.start()
    ta.join(0.3)
    release.set()
    ta.join(5)
    tb.join(5)
    assert seen == [(2, 2)]
