"""The process-wide timer wheel (``tpurpc_torch.utils.timers``) against the
reference's (``tpurpc.utils.timers``), and the three timer sites of the
port that moved onto it: the pipelined call's deadline, the native
plane's GOAWAY linger and the h2 plane's linger.

Each package has its own wheel thread; no test stops either one. A
scenario runs on each package and the observations must be equal.
"""

import threading
import time
import weakref

import pytest

from tpurpc.utils import timers as ref_timers
from tpurpc_torch.utils import timers as port_timers
from torch_call_plane import (PORT, REF, code_name, platform,  # noqa: F401
                              poll, serve)

TIMERS = {"ref": ref_timers, "port": port_timers}


def _schedules_and_cancels(timers):
    """The reference's ``test_timer_wheel_schedules_and_cancels``, as an
    observation."""
    fired = []
    ev = threading.Event()
    timers.schedule(0.05, lambda: (fired.append("a"), ev.set()))
    h = timers.schedule(0.05, lambda: fired.append("cancelled"))
    h.cancel()
    timers.schedule(0.01, lambda: 1 / 0)  # must not kill the wheel
    first = ev.wait(5)
    ev2 = threading.Event()
    timers.schedule(0.02, ev2.set)  # the wheel survived the exception
    survived = ev2.wait(5)
    time.sleep(0.15)
    # an earlier deadline fires first even when scheduled later
    order = []
    done = threading.Event()
    timers.schedule(0.10, lambda: (order.append(2), done.set()))
    timers.schedule(0.02, lambda: order.append(1))
    return first, survived, list(fired), done.wait(5), order


@pytest.mark.parametrize("name", ["ref", "port"])
def test_timer_wheel_schedules_and_cancels(name, capsys):
    got = _schedules_and_cancels(TIMERS[name])
    assert got == (True, True, ["a"], True, [1, 2])
    # the raising callback's traceback went to stderr, not into the wheel
    assert "ZeroDivisionError" in capsys.readouterr().err


def test_port_wheel_is_its_own():
    """Each package runs its own wheel: one singleton and one thread each,
    told apart by name."""
    assert port_timers.TimerWheel.get() is not ref_timers.TimerWheel.get()
    ev = threading.Event()
    names = []
    port_timers.schedule(0.0, lambda: (names.append(
        threading.current_thread().name), ev.set()))
    assert ev.wait(5)
    assert names == ["tpurpc-torch-timers"]


def _runs_off_the_wheel(timers):
    seen = {}
    done = threading.Event()

    def work():
        seen["work"] = threading.current_thread().name
        done.set()

    def tick():
        seen["tick"] = threading.current_thread().name
        timers.run_blocking(work)

    timers.schedule(0.0, tick)
    assert done.wait(5)
    return seen["tick"] != seen["work"], seen["work"].endswith(
        tuple(f"timerio_{i}" for i in range(4)))


@pytest.mark.parametrize("name", ["ref", "port"])
def test_run_blocking_runs_off_the_wheel_thread(name):
    assert _runs_off_the_wheel(TIMERS[name]) == (True, True)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_cancel_drops_the_closure(name):
    """A cancelled timer must not pin what its callback captured until its
    deadline: cancel drops the reference at once."""
    class Big:
        pass

    obj = Big()
    ref = weakref.ref(obj)
    h = TIMERS[name].schedule(3600.0, lambda o=obj: o)
    del obj
    assert ref() is not None
    h.cancel()
    assert ref() is None and h.cancelled


# ---------------------------------------------------------------------------
# The pipelined call's deadline: one wheel entry per call, no thread.
# ---------------------------------------------------------------------------

CALLS = 128
PATH = "/timers.S/Held"


def _peak_threads(pkg, timeout):
    """Peak ``threading.active_count()`` while CALLS pipelined calls are in
    flight on one connection (their handlers held on a gate), and whether
    every call answered."""
    gate = threading.Event()

    def held(req, ctx):
        gate.wait(30)
        return bytes(req)

    srv, port = serve(pkg, {PATH: ("unary_unary", held)}, max_workers=4)
    try:
        with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary(PATH)
            gate.set()
            assert mc(b"warm", timeout=30) == b"warm"  # dial, pool warm
            gate.clear()
            pipe = mc.pipeline(depth=CALLS)
            futs = [pipe.call_async(b"%d" % i, timeout=timeout)
                    for i in range(CALLS)]
            peak = threading.active_count()
            for _ in range(20):
                time.sleep(0.01)
                peak = max(peak, threading.active_count())
            gate.set()
            replies = [f.result(timeout=60) for f in futs]
    finally:
        gate.set()
        srv.stop(grace=1)
    return peak, replies == [b"%d" % i for i in range(CALLS)]


@pytest.mark.parametrize("name", ["ref", "port"])
def test_pipelined_deadlines_start_no_thread_per_call(platform, name):
    """128 calls with deadlines run on as many threads as 128 calls
    without: each deadline is an entry on the wheel (the port once started
    a thread per call)."""
    platform("TCP")
    pkg = {"ref": REF, "port": PORT}[name]
    plain, ok_plain = _peak_threads(pkg, None)
    timed, ok_timed = _peak_threads(pkg, 30.0)
    assert ok_plain and ok_timed
    assert timed - plain <= 8, (plain, timed)


def _expires(pkg):
    gate = threading.Event()

    def held(req, ctx):
        gate.wait(30)
        return b"late"

    srv, port = serve(pkg, {PATH: ("unary_unary", held)}, max_workers=2)
    try:
        with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary(PATH)
            pipe = mc.pipeline(depth=4)
            t0 = time.monotonic()
            fut = pipe.call_async(b"x", timeout=0.2)
            try:
                fut.result(timeout=10)
                code = "OK"
            except pkg.status.RpcError as exc:
                code = code_name(exc)
            late = time.monotonic() - t0 - 0.2
    finally:
        gate.set()
        srv.stop(grace=1)
    return code, late


@pytest.mark.parametrize("name", ["ref", "port"])
def test_pipelined_deadline_fails_deadline_exceeded(platform, name):
    platform("TCP")
    code, late = _expires({"ref": REF, "port": PORT}[name])
    assert code == "DEADLINE_EXCEEDED"
    assert -0.01 <= late < 0.5, late


# ---------------------------------------------------------------------------
# The GOAWAY lingers of both wire planes.
# ---------------------------------------------------------------------------

def test_native_plane_linger_closes_on_the_wheel(platform):
    """An idle draining connection closes after the linger, from a wheel
    entry (a TimerHandle), not a thread of its own."""
    platform("TCP")
    srv, port = serve(PORT, {PATH: ("unary_unary", lambda r, c: r)})
    try:
        with PORT.channel.Channel(f"127.0.0.1:{port}") as ch:
            assert ch.unary_unary(PATH)(b"a", timeout=10) == b"a"
            # the server lists a connection once its reader has started,
            # which can be after the first call returns
            assert poll(lambda: srv._connections)
            conn = srv._connections[0]
            # ... and retires the call's stream after its reply is written,
            # which can also be after the call returns: goaway() reports an
            # idle connection only once it is
            assert poll(lambda: not conn._streams)
            conn.GOAWAY_LINGER_S = 0.05
            # the wheel's one thread starts with the process's first entry:
            # have it running, so that the count below sees the linger's own
            ran = threading.Event()
            port_timers.schedule(0.0, ran.set)
            assert ran.wait(10)
            before = threading.active_count()
            assert conn.goaway(b"drain")
            conn.linger_then_close()
            assert isinstance(conn._linger_timer, port_timers.TimerHandle)
            assert threading.active_count() <= before
            deadline = time.monotonic() + 10
            while conn.alive and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not conn.alive
    finally:
        srv.stop(grace=0)


def test_h2_plane_linger_closes_on_the_wheel(platform):
    """The h2 server's linger (a port-only behaviour, ROADMAP C) moved onto
    the wheel unchanged: an idle draining connection closes after it."""
    platform("TCP")
    from tpurpc_torch.wire.h2_client import H2Channel

    srv, port = serve(PORT, {PATH: ("unary_unary", lambda r, c: r)})
    try:
        ch = H2Channel(f"127.0.0.1:{port}")
        try:
            assert bytes(ch.unary_unary(PATH)(b"h2", timeout=10)) == b"h2"
            conns = poll(lambda: [c for c in srv._connections
                                  if type(c).__name__ == "GrpcH2Connection"])
            assert conns and len(conns) == 1
            conn = conns[0]
            conn.GOAWAY_LINGER_S = 0.05
            conn.goaway(b"drain")
            conn.linger_then_close()
            assert isinstance(conn._linger_timer, port_timers.TimerHandle)
            deadline = time.monotonic() + 10
            while conn.alive and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not conn.alive
        finally:
            ch.close()
    finally:
        srv.stop(grace=0)
