"""The pipelined refused-replay migration (``PipelinedUnary.call_async``)
against the reference's: a call whose terminal is a refusal (a draining
server certifies that no handler ran) replays on another subchannel, up to
three times under the original deadline, with the refusing subchannel
excluded.

Each scenario runs a channel of each package (``both``) against servers
of one package (``srv``), and the observations must be equal: reply
bytes, status codes, which servers ran handlers, attempts counted at the
client (by wrapping the multicallable's ``_start``, the seam both
packages' pipelines dial through). ``tests/test_chaos.py``'s drain case is
the first, twinned with both packages' servers; the rest make a server
refuse every stream by marking it draining without a GOAWAY, so the
client learns of it only by the refusal.
"""

import threading
import time

import pytest

from torch_call_plane import (PKGS, PORT, REF, Counter, both, code_name,
                              platform, poll)  # noqa: F401

ECHO = "/replay.S/Echo"


def _servers(srv_pkg, n, delay=0.0):
    """``n`` started servers of ``srv_pkg``, each counting the calls its
    handler ran; ``[(server, port, counter)]``."""
    rigs = []
    for _ in range(n):
        srv = srv_pkg.server.Server(max_workers=8, native_dataplane=False)
        seen = Counter()

        def handler(req, ctx, _seen=seen):
            _seen.bump()
            if delay:
                time.sleep(delay)
            return bytes(req)

        srv.add_method(ECHO, srv_pkg.server.unary_unary_rpc_method_handler(
            handler))
        port = srv.add_insecure_port("127.0.0.1:0")
        srv.start()
        rigs.append((srv, port, seen))
    return rigs


def _stop(rigs):
    for srv, _, _ in rigs:
        srv.stop(grace=0)


def _mc(pkg, ch):
    return ch.unary_unary(ECHO, tpurpc_native=False)


def _refusing(srv):
    """The server refuses every new stream (RST|FLAG_REFUSED) without a
    GOAWAY: both packages' admission reads the server's drain flag."""
    srv._draining = True


def _dialed_then_refusing(ch, *servers):
    """Dial every subchannel of ``ch``, then make ``servers`` refuse: their
    connections are up and told nothing, so the client learns of the drain
    only by the refusal (a connection dialed into a draining server reads
    a GOAWAY at once, and the call would race it)."""
    for sc in ch._subchannels:
        sc.get()
    for srv in servers:
        _refusing(srv)


def _counted(mc, hook=None):
    """Wrap ``mc._start``: count the attempts (and run ``hook(n)`` before
    each). Both packages' pipelines dial every attempt through it."""
    real = mc._start
    n = Counter()

    def start(*a, **kw):
        k = n.bump()
        if hook is not None:
            hook(k)
        return real(*a, **kw)

    mc._start = start
    return n


@pytest.fixture
def tcp(platform):
    platform("TCP")


# ---------------------------------------------------------------------------
# tests/test_chaos.py::test_fleet_drain_zero_failed_rpcs, pipelined
# ---------------------------------------------------------------------------

def _drain_scenario(pkg, srv_pkg):
    rigs = _servers(srv_pkg, 3, delay=0.002)
    flight = srv_pkg.channel._flight
    t_ns = time.monotonic_ns()
    addrs = ",".join(f"127.0.0.1:{p}" for _, p, _ in rigs)
    try:
        with pkg.channel.Channel(f"ipv4:{addrs}",
                                 lb_policy="round_robin") as ch:
            mc = _mc(pkg, ch)
            attempts = _counted(mc)
            pipe = mc.pipeline(depth=4)
            futs = []
            drained = []
            t_end = time.monotonic() + 0.6
            while time.monotonic() < t_end:
                futs.append(pipe.call_async(b"x", timeout=30))
                time.sleep(0.002)
            dt = threading.Thread(
                target=lambda: drained.append(rigs[1][0].drain(linger=10)))
            dt.start()
            t_end = time.monotonic() + 1.2
            while time.monotonic() < t_end:
                futs.append(pipe.call_async(b"x", timeout=30))
                time.sleep(0.002)
            dt.join(timeout=30)
            failed = 0
            for f in futs:
                try:
                    failed += bytes(f.result(timeout=30)) != b"x"
                except (REF.status.RpcError, PORT.status.RpcError):
                    failed += 1
            settled = rigs[1][2].n
            more = [pipe.call_async(b"y", timeout=30) for _ in range(30)]
            more_ok = all(bytes(f.result(timeout=30)) == b"y" for f in more)
            pipe.close()
        edges = [e["event"] for e in flight.snapshot(since_ns=t_ns)
                 if e["event"] in ("drain-begin", "drain-end")]
        return (failed, drained, more_ok, rigs[1][2].n == settled,
                rigs[0][2].n + rigs[2][2].n > 0,
                attempts.n >= len(futs) + 30, edges)
    finally:
        _stop(rigs)


@pytest.mark.parametrize("plat", ["TCP", "RDMA_BPEV"])
@pytest.mark.parametrize("srv", ["port", "ref"])
def test_fleet_drain_zero_failed_pipelined_rpcs(platform, plat, srv):
    """Three servers under steady pipelined traffic, one drained
    mid-flight: no call fails, the drain finishes in its linger, the
    drained server runs no handler afterwards, and the server's flight
    ring holds drain-begin then drain-end."""
    platform(plat)
    assert both(_drain_scenario, PKGS[srv]) == (
        0, [True], True, True, True, True, ["drain-begin", "drain-end"])


# ---------------------------------------------------------------------------
# the replay's rules, with a server that refuses every stream
# ---------------------------------------------------------------------------

def _exclude_scenario(pkg, srv_pkg):
    rigs = _servers(srv_pkg, 2)
    addrs = ",".join(f"127.0.0.1:{p}" for _, p, _ in rigs)
    try:
        with pkg.channel.Channel(f"ipv4:{addrs}",
                                 lb_policy="round_robin") as ch:
            # both dialed: the policy walks both
            _dialed_then_refusing(ch, rigs[0][0])
            mc = _mc(pkg, ch)
            attempts = _counted(mc)
            pipe = mc.pipeline(depth=4)
            replies = [bytes(f.result(timeout=30)) for f in
                       [pipe.call_async(b"%d" % i, timeout=30)
                        for i in range(12)]]
            pipe.close()
        # round robin sends first attempts to the refuser as its turn
        # comes (it advances at replays' picks too, so how many varies);
        # each replays once, with the refuser excluded, onto the other
        return replies, rigs[0][2].n, rigs[1][2].n, 12 < attempts.n <= 24
    finally:
        _stop(rigs)


@pytest.mark.parametrize("srv", ["port", "ref"])
def test_replay_excludes_the_refusing_subchannel(tcp, srv):
    assert both(_exclude_scenario, PKGS[srv]) == (
        [b"%d" % i for i in range(12)], 0, 12, True)


def _cap_scenario(pkg, srv_pkg):
    rigs = _servers(srv_pkg, 2)
    addrs = ",".join(f"127.0.0.1:{p}" for _, p, _ in rigs)
    try:
        with pkg.channel.Channel(f"ipv4:{addrs}",
                                 lb_policy="round_robin") as ch:
            _dialed_then_refusing(ch, *(srv for srv, _, _ in rigs))
            mc = _mc(pkg, ch)
            attempts = _counted(mc)
            pipe = mc.pipeline(depth=1)
            fut = pipe.call_async(b"x", timeout=30)
            try:
                fut.result(timeout=30)
                out = ("ok",)
            except (REF.status.RpcError, PORT.status.RpcError) as exc:
                out = (code_name(exc), getattr(exc, "_tpurpc_refused",
                                               False))
            # the window's slot came back: a second call goes out at once
            again = pipe.call_async(b"y", timeout=30)
            try:
                again.result(timeout=30)
            except (REF.status.RpcError, PORT.status.RpcError):
                pass
            pipe.close()
        return out, attempts.n, rigs[0][2].n + rigs[1][2].n
    finally:
        _stop(rigs)


@pytest.mark.parametrize("srv", ["port", "ref"])
def test_replays_stop_at_three_and_the_final_refusal_is_marked(tcp, srv):
    """Every server refuses: the call makes 1 + 3 attempts, then fails
    UNAVAILABLE with ``_tpurpc_refused`` set; no handler ran."""
    assert both(_cap_scenario, PKGS[srv]) == (
        ("UNAVAILABLE", True), 8, 0)


def _raising_scenario(pkg, srv_pkg):
    rigs = _servers(srv_pkg, 2)
    addrs = ",".join(f"127.0.0.1:{p}" for _, p, _ in rigs)

    def hook(k):
        if k == 2:  # the replay's dial
            raise pkg.status.RpcError(
                pkg.status.StatusCode.RESOURCE_EXHAUSTED, "replay raised")

    try:
        with pkg.channel.Channel(f"ipv4:{addrs}",
                                 lb_policy="pick_first") as ch:
            _dialed_then_refusing(ch, rigs[0][0])
            mc = _mc(pkg, ch)
            attempts = _counted(mc, hook)
            pipe = mc.pipeline(depth=1)
            fut = pipe.call_async(b"x", timeout=30)
            try:
                fut.result(timeout=30)
                out = ("ok",)
            except (REF.status.RpcError, PORT.status.RpcError) as exc:
                out = (code_name(exc), exc.details())
            later = bytes(pipe.call_async(b"z", timeout=30).result(30))
            pipe.close()
        return out, later, attempts.n, rigs[0][2].n
    finally:
        _stop(rigs)


@pytest.mark.parametrize("srv", ["port", "ref"])
def test_a_replay_that_raises_fails_the_future_once(tcp, srv):
    """The first server refuses and the replay's dial raises: the future
    fails with that error, once, and the window slot is returned."""
    out, later, n, refuser_ran = both(_raising_scenario, PKGS[srv])
    assert out == ("RESOURCE_EXHAUSTED", "replay raised")
    assert refuser_ran == 0 and n >= 3 and later == b"z"


def _deadline_scenario(pkg, srv_pkg):
    rigs = _servers(srv_pkg, 2)
    addrs = ",".join(f"127.0.0.1:{p}" for _, p, _ in rigs)
    release = threading.Event()
    failed_at = []

    def hook(k):
        if k == 2:  # the replay's dial stalls past the call's deadline
            release.wait(10)

    try:
        with pkg.channel.Channel(f"ipv4:{addrs}",
                                 lb_policy="pick_first") as ch:
            _dialed_then_refusing(ch, rigs[0][0])
            mc = _mc(pkg, ch)
            _counted(mc, hook)
            pipe = mc.pipeline(depth=1)
            t0 = time.monotonic()
            fut = pipe.call_async(b"x", timeout=0.3)
            try:
                fut.result(timeout=10)
                out = ("ok",)
            except (REF.status.RpcError, PORT.status.RpcError) as exc:
                out = (code_name(exc), exc.details())
            failed_at.append(time.monotonic() - t0)
            release.set()
            # the stalled replay sees the call resolved and goes nowhere,
            # or lands after it: either way the future stays failed
            poll(lambda: rigs[1][2].n >= 0, timeout=0.2)
            pipe.close()
        return out, fut.exception() is not None, failed_at[0] < 5.0
    finally:
        release.set()
        _stop(rigs)


@pytest.mark.parametrize("srv", ["port", "ref"])
def test_deadline_expires_mid_replay(tcp, srv):
    """The original deadline covers every replay: with the replay's dial
    stalled, the future fails DEADLINE_EXCEEDED on time."""
    assert both(_deadline_scenario, PKGS[srv]) == (
        ("DEADLINE_EXCEEDED", "deadline exceeded awaiting pipelined "
                              "response"), True, True)


def test_a_replay_after_the_deadline_ends_its_watch(tcp):
    """The port alone (the reference keeps the entry: ROADMAP C): the
    deadline fails the future while the replay dials, the replay's attempt
    lands after it and is answered, and that attempt's stall-watchdog entry
    ends with its terminal instead of staying in flight."""
    wd = PORT.watchdog.get()

    def watched():
        return sum(1 for e in list(wd._inflight.values())
                   if e[0] == ECHO and e[3] == "client")

    rigs = _servers(PORT, 2)
    addrs = ",".join(f"127.0.0.1:{p}" for _, p, _ in rigs)
    release = threading.Event()
    try:
        with PORT.channel.Channel(f"ipv4:{addrs}",
                                  lb_policy="pick_first") as ch:
            _dialed_then_refusing(ch, rigs[0][0])
            mc = _mc(PORT, ch)
            _counted(mc, lambda k: k == 2 and release.wait(10))
            pipe = mc.pipeline(depth=1)
            before = watched()
            fut = pipe.call_async(b"x", timeout=0.3)
            code = code_name(fut.exception(timeout=10))
            release.set()
            landed = poll(lambda: rigs[1][2].n == 1)
            ended = poll(lambda: watched() == before)
            pipe.close()
    finally:
        release.set()
        _stop(rigs)
    assert (code, landed, ended) == ("DEADLINE_EXCEEDED", True, True)


def test_drained_connection_servicing_winds_down(platform):
    """Pump mode: a drained server's connection stays serviced while its
    calls run; once they are done the connection closes (a draining
    connection with no streams left dies at the client) and its servicing
    thread ends, while the pipeline still has calls in flight on the other
    server."""
    platform("RDMA_BPEV")
    rigs = _servers(PORT, 2)
    holds = [threading.Event(), threading.Event()]
    entered = threading.Event()

    def held(k):
        def handler(req, ctx):
            if k == 0:
                entered.set()
            holds[k].wait(10)
            return bytes(req)
        return handler

    for k in (0, 1):
        rigs[k][0].add_method("/replay.S/Held",
                              PORT.server.unary_unary_rpc_method_handler(
                                  held(k)))
    addrs = ",".join(f"127.0.0.1:{p}" for _, p, _ in rigs)
    drained = []
    try:
        with PORT.channel.Channel(f"ipv4:{addrs}",
                                  lb_policy="pick_first") as ch:
            for sc in ch._subchannels:
                sc.get()
            conn_a = ch._subchannels[0]._conn
            pipe = ch.unary_unary("/replay.S/Held").pipeline(depth=4)
            on_a = pipe.call_async(b"a", timeout=30)
            assert entered.wait(10)  # A admitted it: the drain waits for it
            dt = threading.Thread(target=lambda: drained.append(
                rigs[0][0].drain(linger=10)))
            dt.start()
            assert poll(lambda: conn_a.draining)
            on_b = [pipe.call_async(b"b", timeout=30) for _ in range(3)]

            def serviced():
                t = pipe._pump_threads.get(id(conn_a))
                return t is not None and t.is_alive()

            before = serviced()
            holds[0].set()
            first = bytes(on_a.result(30))
            ended = poll(lambda: not serviced(), timeout=10.0)
            still = (conn_a.alive, pipe._inflight)
            holds[1].set()
            rest = [bytes(f.result(30)) for f in on_b]
            dt.join(30)
            pipe.close()
        assert (before, first, ended, still, rest, drained) == (
            True, b"a", True, (False, 3), [b"b"] * 3, [True])
    finally:
        for h in holds:
            h.set()
        _stop(rigs)


def _write_failure_scenario(pkg, draining, pipelined):
    """The request's first write fails on a port server's connection, which
    turns draining (or not) as it fails; the reply, or the error's code and
    refusal mark, and the calls each server ran."""
    rigs = _servers(PORT, 2)
    addrs = ",".join(f"127.0.0.1:{p}" for _, p, _ in rigs)
    try:
        with pkg.channel.Channel(f"ipv4:{addrs}",
                                 lb_policy="pick_first") as ch:
            for sc in ch._subchannels:
                sc.get()
            conn_a = ch._subchannels[0]._conn
            real = conn_a.writer.send_many

            def failing(frames):
                conn_a.writer.send_many = real   # once
                conn_a.draining = draining
                raise OSError("endpoint closed")

            conn_a.writer.send_many = failing
            mc = _mc(pkg, ch)
            try:
                if pipelined:
                    pipe = mc.pipeline(depth=2)
                    try:
                        out = bytes(pipe.call_async(b"w", timeout=30)
                                    .result(30))
                    finally:
                        pipe.close()
                else:
                    out = bytes(mc(b"w", timeout=30))
            except (REF.status.RpcError, PORT.status.RpcError) as exc:
                out = (code_name(exc), getattr(exc, "_tpurpc_refused",
                                               False))
        return out, [r[2].n for r in rigs]
    finally:
        _stop(rigs)


@pytest.mark.parametrize("draining", [True, False])
def test_write_failure_on_a_draining_connection_replays(tcp, draining):
    """The port alone (a divergence: the reference raises UNAVAILABLE from
    ``call_async``): a request whose write fails after its connection's
    GOAWAY arrived was never admitted, so the pipelined call replays on
    another subchannel; a write that fails on a connection that was not
    draining fails the call, as in the reference."""
    got = _write_failure_scenario(PORT, draining, pipelined=True)
    if draining:
        assert got == (b"w", [0, 1])
    else:
        assert got == (("UNAVAILABLE", False), [0, 0])


@pytest.mark.parametrize("draining", [True, False])
def test_write_failure_fails_a_blocking_unary_call(tcp, draining):
    """The blocking unary path replays no such call, in both packages: the
    write's failure is UNAVAILABLE, not a refusal, whether or not the
    connection was draining, and no handler ran."""
    assert both(_write_failure_scenario, draining, False) == (
        ("UNAVAILABLE", False), [0, 0])
