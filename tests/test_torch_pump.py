"""The inline pump (``tpurpc_torch/rpc/channel.py``) against the
reference's (``tpurpc/rpc/channel.py``), on the CPU.

On a ring platform a client connection has no reader thread: the thread
that waits on it reads it (a call's ``_next_event``, ``ping``, a rendezvous
claim wait, a pipeline's servicing thread), one owner at a time, and a
timer-wheel tick (the backup pump) reads it when nobody waits. Each case
runs the same scenario on both packages where both can run it, and holds
the port's observations (replies, status codes, ledger deltas, transfer
counts, whether a bound held) to the reference's:

* mode selection: ``TPURPC_INLINE_PUMP``'s values against the endpoint
  kinds, and which connections start a reader thread;
* calls of the four shapes on ``RDMA_BP``, ``RDMA_EVENT``, ``RDMA_BPEV``
  and ``TPU`` (the device ring on the CPU), with the copy ledger;
* concurrency: eight threads on one connection, a deadline that passes
  while another thread owns the pump, and callers failed by a close or a
  server's death;
* the backup pump: its interval, a server's GOAWAY and keepalive PONGs on
  an idle connection, and ``ping``;
* rendezvous: a sender that pumps for its own CLAIM, and the claim
  timeout's RELEASE;
* the descriptor ring: a reply whose COMPLETE arrives only as a ring
  record wakes its parked waiter;
* the pipeline's servicing threads, and the connection lifecycle (pair
  parking, abandoned streams) under the pump.

Every wait has its own timeout; every case closes its channels and stops
its servers in a ``finally``, and the autouse fixture checks that no port
connection a case opened is still alive afterwards (a live pump-mode
connection keeps its backup tick on the timer wheel).
"""

import asyncio
import statistics
import threading
import time
import weakref
from types import SimpleNamespace

import numpy as np
import pytest

import tpurpc.core.rendezvous as ref_rdv
import tpurpc.rpc as jrpc
import tpurpc_torch.core.rendezvous as port_rdv
import tpurpc_torch.rpc as trpc
from tpurpc.core import _native as ref_native
from tpurpc.obs import metrics as ref_metrics
from tpurpc.obs import tracing as ref_tracing
from tpurpc.rpc import aio as ref_aio
from tpurpc.rpc import channel as ref_channel
from tpurpc.tpu import ledger as ref_ledger
from tpurpc.utils import config as ref_config
from tpurpc.utils import timers as ref_timers
from tpurpc_torch.core import pair as port_pair
from tpurpc_torch.core import poller as port_poller
from tpurpc_torch.rpc import aio as port_aio
from tpurpc_torch.rpc import channel as port_channel
from tpurpc_torch.tpu import ledger as port_ledger
from tpurpc_torch.utils import config as port_config
from tpurpc_torch.utils import timers as port_timers


def _ref_totals(ch=None, srv=None):
    """The reference counts rendezvous transfers process-wide."""
    m = ref_metrics.registry().metrics()
    return {"sent": m["rdv_transfers_sent"].snapshot(),
            "received": m["rdv_transfers_received"].snapshot(),
            "fallbacks": m["rdv_fallbacks"].snapshot()}


def _port_totals(ch=None, srv=None):
    """The port counts per link; a scenario's links are all new."""
    links = []
    if ch is not None and ch._conn is not None:
        links.append(ch._conn.rdv)
    if srv is not None:
        links += [c.rdv for c in list(srv._connections)]
    return {k: sum(link.stats()[k] for link in links if link is not None)
            for k in ("sent", "received", "fallbacks")}


REF = SimpleNamespace(
    name="ref", rpc=jrpc, channel=ref_channel, aio=ref_aio,
    ledger=ref_ledger, timers=ref_timers, config=ref_config, rdv=ref_rdv,
    totals=_ref_totals,
    server=lambda **kw: jrpc.Server(native_dataplane=False, **kw),
    mc=lambda ch, kind, path: getattr(ch, kind)(path, tpurpc_native=False))
PORT = SimpleNamespace(
    name="port", rpc=trpc, channel=port_channel, aio=port_aio,
    ledger=port_ledger, timers=port_timers, config=port_config,
    rdv=port_rdv, totals=_port_totals,
    server=lambda **kw: trpc.Server(**kw),
    mc=lambda ch, kind, path: getattr(ch, kind)(path))
PKGS = (REF, PORT)

ECHO = "/pump.S/Echo"
HOLD = "/pump.S/Hold"
COUNT = "/pump.S/Count"
TOTAL = "/pump.S/Total"
DUPLEX = "/pump.S/Duplex"
DRIP = "/pump.S/Drip"
FOREVER = "/pump.S/Forever"
RING_PLATFORMS = ["RDMA_BP", "RDMA_EVENT", "RDMA_BPEV", "TPU"]


def both(scenario, *args):
    """``scenario(pkg, *args)`` on the reference, then the port; the
    observations must be equal. Returns them."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want, (got, want)
    return got


def wait_for(pred, timeout=5.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def _reset():
    for pkg in PKGS:
        pkg.config.set_config(None)


@pytest.fixture(autouse=True)
def _opened(monkeypatch):
    """Every port connection the case opens, weakly; none may be alive
    (nor keep a backup tick) when the case ends. Both packages' cached
    configs are reset around the case; the reference's unary fast path
    (which bypasses its Python transport) is off."""
    monkeypatch.setenv("TPURPC_NATIVE_FAST_UNARY", "0")
    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    _reset()
    opened = weakref.WeakSet()
    init = port_channel._Connection.__init__

    def tracked(self, *a, **kw):
        opened.add(self)
        init(self, *a, **kw)

    monkeypatch.setattr(port_channel._Connection, "__init__", tracked)
    yield opened
    try:
        live = [c for c in list(opened) if c.alive]
        ticking = [c for c in list(opened)
                   if c._backup_handle is not None
                   and not c._backup_handle.cancelled]
        assert not live, f"{len(live)} port connections left open"
        assert not ticking, f"{len(ticking)} backup ticks left scheduled"
    finally:
        _reset()


@pytest.fixture
def platform(monkeypatch):
    """``platform(name, **env)``: both packages on ``name`` with ``env``;
    the port's singletons reset afterwards."""
    # the reference loads (without native/build first compiles) its native
    # library on a ring's first use, under a lock other processes wait on:
    # take that wait here, outside any call's deadline
    ref_native.load()

    def use(name, **env):
        monkeypatch.setenv("GRPC_PLATFORM_TYPE", name)
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        _reset()
    yield use
    port_poller.Poller.reset()
    port_poller.PairPool.reset()
    _reset()


class _Gate:
    """Handlers that block until released; ``entered`` counts arrivals."""

    def __init__(self):
        self.release = threading.Event()
        self._lock = threading.Lock()
        self.entered = 0

    def enter(self):
        with self._lock:
            self.entered += 1

    def wait(self, timeout=30.0):
        self.release.wait(timeout)


def _server(pkg, gate=None, max_workers=16):
    gate = gate or _Gate()
    srv = pkg.server(max_workers=max_workers)
    rpc = pkg.rpc

    def hold(req, ctx):
        gate.enter()
        gate.wait()
        return b"held:" + bytes(req)

    def count(req, ctx):
        for i in range(int(bytes(req))):
            yield str(i).encode()

    def total(req_iter, ctx):
        return str(sum(len(bytes(m)) for m in req_iter)).encode()

    def duplex(req_iter, ctx):
        for m in req_iter:
            yield bytes(m)[::-1]

    def drip(req, ctx):
        # one big message, then hold: nothing but the message's own
        # transfer reaches the client until the gate opens
        yield bytes(req) * int(DRIP_REPEAT)
        gate.enter()
        gate.wait()
        yield b"end"

    def forever(req, ctx):
        # paced, so that what the client must drain after its cancel stays
        # small; it stops when the client's RST ends the call (or at 20 s)
        i = 0
        while ctx.is_active() and i < 10000:
            yield str(i).encode()
            i += 1
            time.sleep(0.002)

    srv.add_method(ECHO, rpc.unary_unary_rpc_method_handler(
        lambda r, c: bytes(r)))
    srv.add_method(HOLD, rpc.unary_unary_rpc_method_handler(hold))
    srv.add_method(COUNT, rpc.unary_stream_rpc_method_handler(count))
    srv.add_method(TOTAL, rpc.stream_unary_rpc_method_handler(total))
    srv.add_method(DUPLEX, rpc.stream_stream_rpc_method_handler(duplex))
    srv.add_method(DRIP, rpc.unary_stream_rpc_method_handler(drip))
    srv.add_method(FOREVER, rpc.unary_stream_rpc_method_handler(forever))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port, gate


DRIP_REPEAT = 4096   # x 128 bytes: 512 KiB, over the rendezvous bar


def _conn(ch):
    return ch._subchannels[0]._conn


def _mode(conn):
    thread = getattr(conn, "_thread", None)
    return conn._pump_mode, thread is not None and thread.is_alive()


# ---------------------------------------------------------------------------
# Mode selection
# ---------------------------------------------------------------------------

MODES = [None, "auto", "AUTO", "0", "off", "false", "FALSE", "1", "on",
         "true", "True", "", "yes"]


@pytest.mark.parametrize("kind", ["ring", "tcp"])
@pytest.mark.parametrize("mode", MODES)
def test_pump_enabled_matrix(monkeypatch, mode, kind):
    """``_pump_enabled`` for every value of ``TPURPC_INLINE_PUMP`` (and
    unset) against a pair-backed and a plain endpoint, equal across
    packages: ``0``/``off``/``false`` never, ``1``/``on``/``true`` always,
    anything else (``auto``) for endpoints with a ``pair``."""
    if mode is None:
        monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    else:
        monkeypatch.setenv("TPURPC_INLINE_PUMP", mode)
    ep = SimpleNamespace(pair=object()) if kind == "ring" else object()
    got = {p.name: p.channel._Connection._pump_enabled(ep) for p in PKGS}
    assert got["port"] == got["ref"], got
    low = (mode or "auto").lower()
    want = (False if low in ("0", "off", "false")
            else True if low in ("1", "on", "true") else kind == "ring")
    assert got["port"] is want


def _mode_of(pkg, inproc=False):
    srv, port, _ = _server(pkg, max_workers=4)
    try:
        ch = (pkg.rpc.inproc_channel(srv) if inproc
              else pkg.rpc.Channel(f"127.0.0.1:{port}"))
        try:
            reply = bytes(pkg.mc(ch, "unary_unary", ECHO)(b"m", timeout=10))
            return reply, _mode(_conn(ch))
        finally:
            ch.close()
    finally:
        srv.stop(grace=0)


@pytest.mark.parametrize("name,mode,want", [
    ("RDMA_BPEV", None, (True, False)),
    ("RDMA_BPEV", "auto", (True, False)),
    ("RDMA_BPEV", "0", (False, True)),
    ("TPU", None, (True, False)),
    ("TCP", None, (False, True)),
    ("TCP", "1", (True, False)),
])
def test_which_connections_start_a_reader_thread(platform, monkeypatch, name,
                                                 mode, want):
    """Pump mode starts no reader thread; ``0`` brings it back; TCP under
    ``auto`` keeps it; ``1`` forces the pump on TCP too."""
    if mode is None:
        monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    else:
        monkeypatch.setenv("TPURPC_INLINE_PUMP", mode)
    platform(name)
    assert both(_mode_of) == (b"m", want)


def test_inproc_channel_is_not_a_ring_endpoint(platform, monkeypatch):
    """An ``inproc_channel``'s endpoint has no pair: ``auto`` gives it a
    reader thread, on a ring platform too."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV")
    assert both(_mode_of, True) == (b"m", (False, True))


# ---------------------------------------------------------------------------
# Calls in pump mode, with the copy ledger
# ---------------------------------------------------------------------------

LEDGER_KEYS = ("rdma_write", "host_copy", "zero_copy", "dma_h2d", "dma_d2d")
#: the most the relocations of frames split across two ring reads may add
#: to one package's host_copy over the other's in one scenario: a few
#: frames' heads, each under 256 bytes in these scenarios (0, 20, 76, 240
#: bytes read between runs of either package, under -n 6 too)
SPLIT_SLACK = 1024


def _shapes(pkg):
    srv, port, _ = _server(pkg)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            uu = pkg.mc(ch, "unary_unary", ECHO)
            us = pkg.mc(ch, "unary_stream", COUNT)
            su = pkg.mc(ch, "stream_unary", TOTAL)
            ss = pkg.mc(ch, "stream_stream", DUPLEX)
            assert bytes(uu(b"warm", timeout=10)) == b"warm"
            mode = _mode(_conn(ch))
            blob = bytes(range(256)) * 4   # 1 KiB, under the rendezvous bar
            out = []
            with pkg.ledger.track() as w:
                out.append(bytes(uu(blob, timeout=10)))
                out.append([bytes(m) for m in us(b"5", timeout=10)])
                out.append(bytes(su(iter([blob, b"ab", b""]), timeout=10)))
                out.append([bytes(m) for m in ss(iter([b"abc", blob[:9]]),
                                                  timeout=10)])
            return mode, out, {k: w[k] for k in LEDGER_KEYS}
    finally:
        srv.stop(grace=0)


@pytest.mark.parametrize("name", RING_PLATFORMS)
def test_call_shapes_in_pump_mode_match_reference(platform, monkeypatch,
                                                  name):
    """Unary, server-streaming, client-streaming and bidi calls on a
    pump-mode connection: the replies and the copy ledger's deltas equal
    the reference's. Load reports and the reference's tail-capture header
    (observability the port has not taken, ROADMAP A4) are off, so that
    the framed bytes compare whole."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform(name, TPURPC_LOAD_REPORTS="0", TPURPC_HBM_RING_SIZE_KB="256")
    ref_tracing.tail(False)
    try:
        got = {p.name: _shapes(p) for p in PKGS}
    finally:
        ref_tracing.tail(None)
    # A frame that two ring reads split costs the reader one relocation of
    # its head: which frames split depends on when each read runs, in both
    # packages alike (here 0 or 76 bytes, in either package, over 20 runs
    # of each). host_copy is held to that; every other entry whole.
    copies = {k: r[2].pop("host_copy") for k, r in got.items()}
    assert got["port"] == got["ref"], got
    assert abs(copies["port"] - copies["ref"]) <= SPLIT_SLACK, copies
    mode, out, _ = got["port"]
    blob = bytes(range(256)) * 4
    assert mode == (True, False)
    assert out == [blob, [b"0", b"1", b"2", b"3", b"4"],
                   str(len(blob) + 2).encode(), [b"cba", blob[:9][::-1]]]
    assert min(copies.values()) > 0


# ---------------------------------------------------------------------------
# Concurrency
# ---------------------------------------------------------------------------

def _many_threads(pkg, threads=8, calls=16):
    srv, port, _ = _server(pkg)
    bad, errors = [], []
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            mc = pkg.mc(ch, "unary_unary", ECHO)
            assert bytes(mc(b"warm", timeout=10)) == b"warm"
            conn = _conn(ch)

            def worker(t):
                try:
                    for k in range(calls):
                        req = bytes([t, k]) * 64
                        if bytes(mc(req, timeout=30)) != req:
                            bad.append((t, k))
                except Exception as exc:   # surfaced by the assert below
                    errors.append(repr(exc))

            ts = [threading.Thread(target=worker, args=(t,))
                  for t in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            return (any(t.is_alive() for t in ts), errors, bad,
                    _conn(ch) is conn, _mode(conn))
    finally:
        srv.stop(grace=0)


def test_eight_threads_share_one_pump_mode_connection(platform, monkeypatch):
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV")
    assert both(_many_threads) == (False, [], [], True, (True, False))


def _deadline_under_owner(pkg):
    srv, port, gate = _server(pkg)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            hold = pkg.mc(ch, "unary_unary", HOLD)
            assert bytes(pkg.mc(ch, "unary_unary", ECHO)(
                b"w", timeout=10)) == b"w"
            conn = _conn(ch)
            owner = {}
            t = threading.Thread(target=lambda: owner.setdefault(
                "out", bytes(hold(b"a", timeout=30))))
            t.start()
            # the first caller is in the server and owns the pump
            assert wait_for(lambda: gate.entered == 1 and conn._pumping)
            t0 = time.monotonic()
            try:
                hold(b"b", timeout=0.5)
                got = "no error"
            except pkg.rpc.RpcError as exc:
                got = exc.code().name
            late = time.monotonic() - t0 - 0.5
            gate.release.set()
            t.join(30)
            return got, late < 0.5, owner.get("out")
    finally:
        gate.release.set()
        srv.stop(grace=0)


def test_deadline_passes_while_another_thread_owns_the_pump(platform,
                                                            monkeypatch):
    """A caller parked behind the pump's owner fails DEADLINE_EXCEEDED
    within 0.5 s of its deadline; the owner's call still completes."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV")
    assert both(_deadline_under_owner) == ("DEADLINE_EXCEEDED", True,
                                           b"held:a")


def _fail_waiters(pkg, how):
    srv, port, gate = _server(pkg)
    ch = pkg.rpc.Channel(f"127.0.0.1:{port}")
    try:
        hold = pkg.mc(ch, "unary_unary", HOLD)
        assert bytes(pkg.mc(ch, "unary_unary", ECHO)(b"w", timeout=10)) \
            == b"w"
        codes, lags = [], []
        lock = threading.Lock()
        ended = {}

        def caller(i):
            try:
                hold(str(i).encode(), timeout=30)
                code = "OK"
            except pkg.rpc.RpcError as exc:
                code = exc.code().name
            with lock:
                codes.append(code)
                lags.append(time.monotonic() - ended["t"])

        ts = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        assert wait_for(lambda: gate.entered == 8, timeout=10)
        ended["t"] = time.monotonic()
        if how == "close":
            ch.close()
        else:
            srv.stop(grace=0)
        for t in ts:
            t.join(10)
        return (sorted(codes), max(lags) < 5.0,
                any(t.is_alive() for t in ts))
    finally:
        gate.release.set()
        ch.close()
        srv.stop(grace=0)


@pytest.mark.parametrize("how", ["close", "server_death"])
def test_close_or_server_death_fails_every_waiter(platform, monkeypatch, how):
    """Eight callers wait on one pump-mode connection (one owns the pump,
    seven are parked); a ``close()`` or the server's death fails every
    one UNAVAILABLE within 5 s."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV")
    assert both(_fail_waiters, how) == (["UNAVAILABLE"] * 8, True, False)


# ---------------------------------------------------------------------------
# The backup pump
# ---------------------------------------------------------------------------

def _interval(pkg, monkeypatch):
    seen = []
    real = pkg.timers.schedule

    def spy(delay, fn):
        if "_start_backup_pump" in getattr(fn, "__qualname__", ""):
            seen.append(round(delay, 6))
        return real(delay, fn)

    monkeypatch.setattr(pkg.timers, "schedule", spy)
    try:
        srv, port, _ = _server(pkg, max_workers=4)
        try:
            with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
                assert bytes(pkg.mc(ch, "unary_unary", ECHO)(
                    b"i", timeout=10)) == b"i"
                return seen[0]
        finally:
            srv.stop(grace=0)
    finally:
        monkeypatch.setattr(pkg.timers, "schedule", real)


@pytest.mark.parametrize("ka,want", [
    (None, 0.5), (("200", "1000"), 1 / 3), (("100", "90"), 0.05),
    (("1000", "6000"), 0.5)])
def test_backup_interval_follows_keepalive(platform, monkeypatch, ka, want):
    """0.5 s with keepalive off; with it on, a third of the keepalive
    timeout, between 0.05 and 0.5 s, as the reference's."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    env = {}
    if ka is not None:
        env = {"GRPC_ARG_KEEPALIVE_TIME_MS": ka[0],
               "GRPC_ARG_KEEPALIVE_TIMEOUT_MS": ka[1]}
    platform("RDMA_BPEV", **env)
    got = {p.name: _interval(p, monkeypatch) for p in PKGS}
    assert got["port"] == got["ref"] == round(want, 6), got


def _goaway_idle(pkg):
    srv, port, _ = _server(pkg, max_workers=4)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            t0 = time.monotonic()
            assert bytes(pkg.mc(ch, "unary_unary", ECHO)(
                b"g", timeout=10)) == b"g"
            conn = _conn(ch)
            # the server's GOAWAY leaves at its age (0.3 s after the
            # accept, no later than t0 + 0.3); the idle connection must
            # read it within two backup intervals, before the server's
            # 1 s linger closes the connection under it
            died = wait_for(lambda: not conn.alive, timeout=5)
            lag = time.monotonic() - t0 - 0.3
            return died, conn.draining, lag < 1.0
    finally:
        srv.stop(grace=0)


def test_idle_connection_reads_goaway_within_two_intervals(platform,
                                                           monkeypatch):
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV", GRPC_ARG_MAX_CONNECTION_AGE_MS="300")
    assert both(_goaway_idle) == (True, True, True)


def _keepalive_idle(pkg):
    srv, port, _ = _server(pkg, max_workers=4)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            assert bytes(pkg.mc(ch, "unary_unary", ECHO)(
                b"k", timeout=10)) == b"k"
            conn = _conn(ch)
            before = conn.pong_count
            time.sleep(3.0)
            return (conn.alive, _conn(ch) is conn,
                    conn.pong_count - before >= 2, _mode(conn))
    finally:
        srv.stop(grace=0)


def test_keepalive_keeps_a_healthy_idle_pump_connection(platform,
                                                        monkeypatch):
    """Keepalive at 200/1000 ms: the backup pump reads each PONG inside
    its verdict window, so a healthy idle connection lives 3 s with its
    PONGs counted."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV", GRPC_ARG_KEEPALIVE_TIME_MS="200",
             GRPC_ARG_KEEPALIVE_TIMEOUT_MS="1000")
    assert both(_keepalive_idle) == (True, True, True, (True, False))


def _pings(pkg):
    srv, port, _ = _server(pkg, max_workers=4)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            assert bytes(pkg.mc(ch, "unary_unary", ECHO)(
                b"p", timeout=10)) == b"p"
            rtts = [ch.ping(timeout=5) for _ in range(20)]
            # a ping that did not pump would wait for a backup tick
            return _mode(_conn(ch)), statistics.median(rtts) < 0.1
    finally:
        srv.stop(grace=0)


def test_ping_pumps_in_pump_mode(platform, monkeypatch):
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV")
    assert both(_pings) == ((True, False), True)


# ---------------------------------------------------------------------------
# Rendezvous
# ---------------------------------------------------------------------------

def _own_claim(pkg):
    srv, port, _ = _server(pkg, max_workers=4)
    payload = np.arange(1 << 17, dtype=np.float32).tobytes()   # 512 KiB
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            echo = pkg.mc(ch, "unary_unary", ECHO)
            assert bytes(echo(b"tiny", timeout=10)) == b"tiny"
            conn = _conn(ch)
            pumped = []
            link = conn.rdv
            inner = link._pump

            def spy(pred, deadline):
                got = inner(pred, deadline)
                pumped.append((threading.get_ident(), bool(pred())))
                return got

            link._pump = spy
            before = pkg.totals(ch, srv)
            with pkg.ledger.track() as w:
                reply = bytes(echo(payload, timeout=30))
            after = pkg.totals(ch, srv)
            link._pump = inner
            me = threading.get_ident()
            return (reply == payload, _mode(conn),
                    {k: after[k] - before[k] for k in after},
                    # the first claim this sender waited for, it pumped
                    # for itself, on its own thread, and got
                    bool(pumped) and pumped[0] == (me, True),
                    {k: w[k] for k in LEDGER_KEYS})
    finally:
        srv.stop(grace=0)


def test_sender_pumps_for_its_own_claim(platform, monkeypatch):
    """A 512 KiB request on a fresh pump-mode connection: no standing
    grant yet, so the sender OFFERs and pumps the connection itself until
    its CLAIM arrives (nobody else reads it); the request and the reply
    both move by rendezvous. Replies, transfer counts and the ledger equal
    the reference's, host_copy up to the frames two reads split. The
    control ops are framed (descriptor ring off): the ring's kicks come and
    go with timing, in both packages, and with them framed bytes."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV", TPURPC_LOAD_REPORTS="0", TPURPC_CTRL_RING="0")
    ref_tracing.tail(False)
    try:
        got = {p.name: _own_claim(p) for p in PKGS}
    finally:
        ref_tracing.tail(None)
    # host_copy as in test_call_shapes_in_pump_mode_match_reference
    copies = {k: r[4].pop("host_copy") for k, r in got.items()}
    assert got["port"] == got["ref"], got
    assert abs(copies["port"] - copies["ref"]) <= SPLIT_SLACK, copies
    ok, mode, counts, pumped, delta = got["port"]
    assert ok and mode == (True, False) and pumped
    assert counts == {"sent": 2, "received": 2, "fallbacks": 0}
    assert delta["rdma_write"] == 2 * (1 << 19)


def _claim_timeout(pkg):
    ops = []
    pumps = []

    def pump(pred, deadline):
        pumps.append(round(deadline - time.monotonic(), 1))
        while not pred() and time.monotonic() < deadline:
            time.sleep(0.01)
        return pred()

    link = pkg.rdv.RdvLink("t", lambda op, sid, pl: ops.append(op),
                           lambda *d: None, pump=pump)
    link.on_peer_hello()
    got = link.rdv_claim(1, 1 << 20, pkg.rdv.size_class(1 << 20))
    with link._lock:
        pending = len(link._reqs)
    return got, ops, pumps, pending


def test_claim_timeout_pumps_then_releases_the_offer(monkeypatch):
    """A link with a ``pump`` waits for its CLAIM through it, up to the
    claim timeout; a CLAIM that never comes ends in a RELEASE of the
    offer, and no request is left pending."""
    monkeypatch.setenv("TPURPC_RENDEZVOUS_CLAIM_TIMEOUT_S", "0.3")
    monkeypatch.setenv("TPURPC_CTRL_RING", "0")
    got = both(_claim_timeout)
    assert got == (None, [port_rdv.OP_OFFER, port_rdv.OP_RELEASE], [0.3], 0)


# ---------------------------------------------------------------------------
# The descriptor ring
# ---------------------------------------------------------------------------

def _ring_record_wakes(pkg):
    srv, port, gate = _server(pkg)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            hold = pkg.mc(ch, "unary_unary", HOLD)
            drip = pkg.mc(ch, "unary_stream", DRIP)
            chunk = bytes(range(128))
            # settle the hello and the descriptor rings, and leave standing
            # grants: the next big message's COMPLETE is one ring record
            call = drip(chunk, timeout=30)
            it = iter(call)
            assert bytes(next(it)) == chunk * DRIP_REPEAT
            assert wait_for(lambda: gate.entered == 1)
            gate.release.set()
            assert [bytes(m) for m in it] == [b"end"]
            gate.release.clear()
            gate.entered = 0
            conn = _conn(ch)
            armed = conn.ctrl is not None and conn.ctrl.rx is not None
            owner = {}
            t = threading.Thread(target=lambda: owner.setdefault(
                "out", bytes(hold(b"o", timeout=30))))
            t.start()
            assert wait_for(lambda: gate.entered == 1 and conn._pumping)
            # this caller parks behind the owner; its message arrives as
            # a rendezvous transfer whose control ops ride the rings
            t0 = time.monotonic()
            call = drip(chunk, timeout=30)
            it = iter(call)
            first = bytes(next(it))
            woke = time.monotonic() - t0
            gate.release.set()
            rest = [bytes(m) for m in it]
            t.join(30)
            return (armed, first == chunk * DRIP_REPEAT, woke < 5.0, rest,
                    owner.get("out"))
    finally:
        gate.release.set()
        srv.stop(grace=0)


def test_ring_record_wakes_a_parked_waiter(platform, monkeypatch):
    """The pump's owner waits on a held call; a second caller, parked
    behind it, waits for a message whose rendezvous ops ride the
    descriptor rings: the owner's drain of the ring must wake it (the
    drain notifies parked waiters), well before the 30 s deadline and
    while the server still holds the owner's call."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV")
    assert both(_ring_record_wakes) == (True, True, True, [b"end"],
                                        b"held:o")


def _concurrent_rdv(pkg, threads=8, calls=6):
    """Many threads share one pump-mode connection's link: standing
    grants, claims, doorbells and ring records under contention."""
    import sys

    before = pkg.totals()
    srv, port, _ = _server(pkg, max_workers=threads)
    bad, errors = [], []
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            mc = pkg.mc(ch, "unary_unary", ECHO)
            assert bytes(mc(b"tiny", timeout=10)) == b"tiny"
            mode = _mode(_conn(ch))

            def worker(t):
                try:
                    for k in range(calls):
                        req = bytes([t, k]) * (150 * 1024)   # 300 KiB
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
            after = pkg.totals(ch, srv)
            counts = {k: after[k] - before[k] for k in after}
            return (mode, any(t.is_alive() for t in ts), errors, bad,
                    counts)
    finally:
        srv.stop(grace=1)


def test_concurrent_calls_share_one_link_in_pump_mode(platform, monkeypatch):
    """``test_torch_rendezvous.py::test_concurrent_calls_share_one_link``
    on the port with the pump explicitly on: every reader (a caller that
    owns the pump, the backup pump) drains the descriptor ring with
    ``wait=True``, waiting out a sender's drain, so no COMPLETE a sender
    took lands after its stream's TRAILERS. The reference's pump drains
    with a try-lock and loses a response here now and then ("unary call
    received no response"; ROADMAP C), so its half is not compared. (With
    the ring off, framed control ops, both packages lose responses under
    this load in either mode: ROADMAP C.)"""
    monkeypatch.setenv("TPURPC_INLINE_PUMP", "auto")
    platform("RDMA_BPEV", TPURPC_CTRL_RING="1")
    assert _concurrent_rdv(PORT) == ((True, False), False, [], [],
                                     {"sent": 96, "received": 96,
                                      "fallbacks": 0})


# ---------------------------------------------------------------------------
# The pipeline's servicing threads
# ---------------------------------------------------------------------------

def _pump_threads(pipe):
    with pipe._lock:
        return [t for t in pipe._pump_threads.values() if t.is_alive()]


def _pipelined(pkg):
    srv, port, _ = _server(pkg)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            mc = pkg.mc(ch, "unary_unary", ECHO)
            assert bytes(mc(b"w", timeout=10)) == b"w"
            pipe = mc.pipeline(depth=16)
            most = [0]
            futs = []
            for i in range(64):
                futs.append(pipe.call_async(str(i).encode(), timeout=30))
                most[0] = max(most[0], len(_pump_threads(pipe)))
            replies = [bytes(f.result(timeout=30)) for f in futs]
            gone = wait_for(lambda: not _pump_threads(pipe), timeout=1.0)
            # a window that runs again gets a fresh servicing thread
            again = bytes(pipe.call_async(b"x", timeout=30).result(
                timeout=30))
            gone_again = wait_for(lambda: not _pump_threads(pipe),
                                  timeout=1.0)
            pipe.close()
            return (replies == [str(i).encode() for i in range(64)],
                    most[0], again, _mode(_conn(ch)),
                    (gone, gone_again) if pkg is PORT else None)
    finally:
        srv.stop(grace=0)


def test_pipeline_servicing_thread_comes_and_goes(platform, monkeypatch):
    """64 calls at depth 16 on a pump-mode connection: every reply right
    and one servicing thread while calls are in flight, in both packages.
    The port's thread is gone 1 s after the window drains, both times. The
    reference's can stay in a blocking read when the caller completed the
    window's last call itself (a terminal read before its hook was set):
    it pumps with no deadline (ROADMAP C), so that is read on the port
    alone."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV")
    got = {p.name: _pipelined(p) for p in PKGS}
    assert got["ref"][:4] == got["port"][:4] == (True, 1, b"x",
                                                 (True, False))
    assert got["port"][4] == (True, True)


def _pipeline_close(pkg=PORT):
    srv, port, gate = _server(pkg)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            mc = pkg.mc(ch, "unary_unary", HOLD)
            pipe = mc.pipeline(depth=4)
            futs = [pipe.call_async(str(i).encode(), timeout=30)
                    for i in range(2)]
            assert wait_for(lambda: gate.entered == 2)
            running = len(_pump_threads(pipe))
            pipe.close()
            # the servicing thread winds down with calls still in flight;
            # their terminals are read by the backup pump
            gone = wait_for(lambda: not _pump_threads(pipe), timeout=2.0)
            gate.release.set()
            replies = [bytes(f.result(timeout=10)) for f in futs]
            return running, gone, replies
    finally:
        gate.release.set()
        srv.stop(grace=0)


def test_pipeline_close_winds_down_servicing(platform, monkeypatch):
    """``close()`` with calls in flight: the port's servicing thread pumps
    in slices of ``_SERVICE_SLICE_S`` and sees the close within one; the
    reference's pumps with no deadline and sees it only when the next
    frame arrives (a divergence, ROADMAP C), so this runs on the port
    alone. The outstanding calls still complete."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV")
    assert _pipeline_close() == (1, True, [b"held:0", b"held:1"])


def _pipelined_deadline(pkg):
    srv, port, gate = _server(pkg)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            pipe = pkg.mc(ch, "unary_unary", HOLD).pipeline(depth=4)
            t0 = time.monotonic()
            fut = pipe.call_async(b"d", timeout=0.4)
            try:
                fut.result(timeout=10)
                got = "no error"
            except pkg.rpc.RpcError as exc:
                got = exc.code().name
            late = time.monotonic() - t0 - 0.4
            gone = wait_for(lambda: not _pump_threads(pipe), timeout=1.0)
            pipe.close()
            return got, late < 1.0, gone if pkg is PORT else None
    finally:
        gate.release.set()
        srv.stop(grace=0)


def test_pipelined_deadline_in_pump_mode(platform, monkeypatch):
    """A pipelined call on a held handler fails DEADLINE_EXCEEDED in pump
    mode, in both packages alike. Its window is then idle: the port's
    servicing thread goes within a second (the reference's stays until the
    next frame: ROADMAP C, so that is read on the port alone)."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV")
    got = {p.name: _pipelined_deadline(p) for p in PKGS}
    assert got["ref"][:2] == got["port"][:2] == ("DEADLINE_EXCEEDED", True)
    assert got["port"][2] is True


# ---------------------------------------------------------------------------
# The connection lifecycle under the pump
# ---------------------------------------------------------------------------

def _parks(pkg):
    srv, port, _ = _server(pkg, max_workers=4)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            echo = pkg.mc(ch, "unary_unary", ECHO)
            assert bytes(echo(b"1", timeout=10)) == b"1"
            conn = _conn(ch)
            cli = conn.endpoint.pair
            # idle: the backup pump's empty reads must not keep it awake
            parked = wait_for(lambda: cli._parked, timeout=10)
            epochs = cli.parked_epochs
            reply = bytes(echo(b"2", timeout=10))
            return (_mode(conn), parked, epochs >= 1, reply,
                    _conn(ch) is conn, cli._parked)
    finally:
        srv.stop(grace=0)


def test_idle_pump_connection_parks_and_wakes(platform, monkeypatch):
    """An idle pump-mode connection parks at ``pair_park_s`` and its next
    call wakes it, on the same connection."""
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV", TPURPC_PAIR_PARK_S="0.2")
    try:
        assert both(_parks) == ((True, False), True, True, b"2", True,
                                False)
    finally:
        port_pair.RingPool.reset()


def _abandoned_sync(pkg):
    srv, port, _ = _server(pkg, max_workers=4)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            stream = pkg.mc(ch, "unary_stream", FOREVER)(b"go", timeout=30)
            seen = []
            for item in stream:
                seen.append(bytes(item))
                if len(seen) == 3:
                    break
            del stream, item   # the call's GC-time cancel frees the stream
            echo = pkg.mc(ch, "unary_unary", ECHO)
            after = [bytes(echo(f"p{i}".encode(), timeout=10))
                     for i in range(4)]
            return seen, after, _mode(_conn(ch))
    finally:
        srv.stop(grace=0)


def test_abandoned_stream_leaves_pump_channel_usable(platform, monkeypatch):
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV")
    assert both(_abandoned_sync) == (
        [b"0", b"1", b"2"], [b"p0", b"p1", b"p2", b"p3"], (True, False))


def _abandoned_aio(pkg):
    srv, port, _ = _server(pkg, max_workers=4)

    async def main():
        async with pkg.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            stream = ch.unary_stream(FOREVER)(b"go", timeout=30)
            seen = []
            async for item in stream:
                seen.append(bytes(item))
                if len(seen) == 3:
                    break
            await stream.aclose()
            call = ch.unary_unary(ECHO)
            after = [bytes(await call(f"p{i}".encode(), timeout=10))
                     for i in range(4)]
            return seen, after

    try:
        return asyncio.run(main())
    finally:
        srv.stop(grace=0)


def test_abandoned_aio_stream_leaves_pump_channel_usable(platform,
                                                         monkeypatch):
    monkeypatch.delenv("TPURPC_INLINE_PUMP", raising=False)
    platform("RDMA_BPEV")
    assert both(_abandoned_aio) == ([b"0", b"1", b"2"],
                                    [b"p0", b"p1", b"p2", b"p3"])
