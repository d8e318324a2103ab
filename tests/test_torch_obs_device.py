"""The device path's and the call plane's chaos observability in the port
against the reference's: rendezvous (``core/rendezvous.py``), the device
ring (``tpu/hbm_ring.py``), its decode (``tpu/endpoint.py``), the codec
(``torchshim/codec.py``), the fan-in batcher and device merger
(``torchshim/service.py``), and the stall watchdog reading them.

Each scenario runs on both packages with the same seeded inputs (the port
on the CPU, the reference on JAX's CPU backend) and the observations must
be equal: counter, histogram and lens-hop deltas, fleet-gauge readings of
the scenario's own objects, flight sequences under the scenario's own tags,
span names and watchdog stages. The reference's servers run without their
native data plane and its channels without the native call path, which the
port does not have (ROADMAP A7). Twins of
``tests/test_rendezvous.py::test_flight_sequence_offer_claim_write_complete``
and ``::test_watchdog_names_rendezvous_stage``, and of
``tests/test_chaos.py::test_server_death_reconnect_flight_sequence``,
``::test_partition_peer_stops_reading_names_stage`` and
``::test_slow_peer_names_device_infer_stage``.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

import tpurpc.core.rendezvous as ref_rdv
from torch_call_plane import BOTH, PORT, REF, both, platform, poll  # noqa: F401
from torch_obs import (clean_obs, counter, fleet_reading, hist,  # noqa: F401
                       hop, method, mod, server)
from tpurpc_torch.core import rendezvous as port_rdv

ECHO = "/obsdev.S/Echo"
WAIT = 10.0


def _echo(pkg):
    return server(pkg, {ECHO: ("unary_unary", lambda req, ctx: bytes(req))})


@pytest.fixture
def fast_watchdog():
    """Both packages' watchdogs sweeping fast, restored afterwards."""
    saved = []
    for pkg in BOTH:
        wd = pkg.watchdog.get()
        saved.append((wd, (wd.min_stall_s, wd.sweep_s, wd.mult)))
        wd.reset()
        wd.min_stall_s, wd.sweep_s, wd.mult = 0.3, 0.1, 8.0
    yield
    for wd, prev in saved:
        wd.min_stall_s, wd.sweep_s, wd.mult = prev
        wd.reset()


def _diagnose(pkg, path: str, kind=None, timeout: float = WAIT):
    """The first watchdog diagnosis of ``path`` (and ``kind``)."""
    wd = pkg.watchdog.get()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        time.sleep(0.1)
        for d in wd.sweep_once():
            if d["method"] == path and (kind is None or d["kind"] == kind):
                return d
    return None


def _in_order(snap, names, since_ns):
    """True when ``names`` occur in ``snap`` in this order after
    ``since_ns`` (each after the one before)."""
    t = since_ns
    for name in names:
        hits = [e["t_ns"] for e in snap
                if e["event"] == name and e["t_ns"] >= t]
        if not hits:
            return False
        t = min(hits)
    return True


# ---------------------------------------------------------------------------
# rendezvous
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plat", ["TCP", "RDMA_BPEV"])
def test_flight_sequence_offer_claim_write_complete(clean_obs, platform,
                                                    plat):
    """A solicited transfer's edges under its link's tag: for every write,
    the same link's claim of the same lease before it and its complete
    after it; and the process-wide transfer counters move by the request
    and the reply."""
    platform(plat)

    def scenario(pkg):
        names = ("rdv_transfers_sent", "rdv_transfers_received",
                 "rdv_fallbacks")
        srv, port = _echo(pkg)
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                mc = method(pkg, ch, "unary_unary", ECHO)
                assert bytes(mc(b"warm", timeout=30)) == b"warm"
                c0 = [counter(pkg, n) for n in names]
                big = bytes(range(256)) * 4096
                ok = bytes(mc(big, timeout=30)) == big
                c1 = [counter(pkg, n) for n in names]
            evs = [e for e in pkg.flight.snapshot()
                   if e["event"].startswith("rdv-")]
            ordered = True
            for w in [e for e in evs if e["event"] == "rdv-write"]:
                claims = [e["t_ns"] for e in evs if e["event"] == "rdv-claim"
                          and e["tag"] == w["tag"] and e["a2"] == w["a1"]]
                dones = [e["t_ns"] for e in evs
                         if e["event"] == "rdv-complete"
                         and e["tag"] == w["tag"] and e["a1"] == w["a1"]]
                ordered &= bool(claims and min(claims) <= w["t_ns"]
                                and dones and w["t_ns"] <= max(dones))
            return (ok, sorted({e["event"] for e in evs}), ordered,
                    [b - a for a, b in zip(c0, c1)])
        finally:
            srv.stop(grace=0)

    got = both(scenario)
    assert got[0] and got[2]
    assert {"rdv-offer", "rdv-claim", "rdv-write",
            "rdv-complete"} <= set(got[1])
    assert got[3] == [2, 2, 0]


def test_watchdog_names_rendezvous_stage(clean_obs, platform, fast_watchdog,
                                         monkeypatch):
    """A claim-starved sender (its offers dropped at the receiver) is
    diagnosed in the ``rendezvous`` stage, and the call completes on the
    framed path after the claim timeout."""
    platform("TCP", TPURPC_RENDEZVOUS_CLAIM_TIMEOUT_S="3")
    monkeypatch.setitem(ref_rdv.TEST_HOOKS, "drop_offers", True)
    monkeypatch.setattr(port_rdv.RdvLink, "on_offer",
                        lambda self, stream_id, payload: None)

    def scenario(pkg):
        srv, port = _echo(pkg)
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                mc = method(pkg, ch, "unary_unary", ECHO)
                big = b"w" * (1 << 20)
                result = {}
                t = threading.Thread(
                    target=lambda: result.update(out=bytes(mc(big,
                                                              timeout=30))))
                t.start()
                diag = None
                deadline = time.monotonic() + WAIT
                while diag is None and time.monotonic() < deadline:
                    d = _diagnose(pkg, ECHO, timeout=0.5)
                    if d is not None and d["stage"] == "rendezvous":
                        diag = d
                t.join(timeout=30)
                return (diag is not None and "offer" in diag["detail"],
                        result.get("out") == big)
        finally:
            srv.stop(grace=0)

    assert both(scenario) == (True, True)


# ---------------------------------------------------------------------------
# the device ring and its decode
# ---------------------------------------------------------------------------

def _ring(pkg, capacity: int):
    hbm = mod(pkg, "tpu.hbm_ring")
    if pkg is REF:
        return hbm.HbmRing(capacity)
    return hbm.HbmRing(capacity, device="cpu")


def _landing_deltas(pkg, land):
    names = ("hbm_place_msgs", "hbm_place_bytes")
    c0 = [counter(pkg, n) for n in names]
    h0 = hop(pkg, "hbm")
    out = land()
    h1 = hop(pkg, "hbm")
    return (out, [counter(pkg, n) - c for n, c in zip(names, c0)],
            h1[0] - h0[0], h1[2] - h0[2], h1[1] > h0[1])


@pytest.mark.parametrize("wrapped", [False, True])
def test_hbm_place_counts_landings_and_occupancy(wrapped):
    """``place`` lands one message: ``hbm_place_msgs`` +1, its bytes on
    ``hbm_place_bytes`` and the ``hbm`` hop (every placed byte a copy
    byte), across the wrap point too; ``hbm_ring_occupancy_bytes`` reads
    ``tail - head`` and falls back to 0 when the leases go."""
    def scenario(pkg):
        ring = _ring(pkg, 4096)
        rng = np.random.default_rng(11)
        if wrapped:
            first = ring.place(rng.integers(0, 256, 3000, dtype=np.uint8))
            ring.view(*first).release()
        payload = rng.integers(0, 256, 2000, dtype=np.uint8)
        span, deltas, hbm_b, hbm_c, busy = _landing_deltas(
            pkg, lambda: ring.place(payload))
        occ = fleet_reading(pkg, "hbm_ring_occupancy_bytes", ring)
        lease = ring.view(*span)
        got = np.asarray(lease.array.numpy() if pkg is PORT
                         else lease.array).tobytes()
        lease.release()
        return (span, deltas, hbm_b, hbm_c, busy, occ,
                got == payload.tobytes(),
                fleet_reading(pkg, "hbm_ring_occupancy_bytes", ring))

    got = both(scenario)
    assert got[1:] == ([1, 2000], 2000, 2000, True, 2000.0, True, 0.0)
    assert (got[0][0] % 4096 + 2000 > 4096) == wrapped


def test_hbm_place_many_counts_every_span():
    def scenario(pkg):
        ring = _ring(pkg, 8192)
        rng = np.random.default_rng(12)
        payloads = [rng.integers(0, 256, n, dtype=np.uint8)
                    for n in (100, 0, 700, 64)]
        spans, deltas, hbm_b, hbm_c, _ = _landing_deltas(
            pkg, lambda: ring.place_many(payloads))
        return (len(spans), deltas, hbm_b, hbm_c,
                fleet_reading(pkg, "hbm_ring_occupancy_bytes", ring))

    # the zero-size span counts as a message and holds no credit
    assert both(scenario) == (4, [4, 864], 864, 864, 864.0)


def test_hbm_region_fill_is_a_landing():
    def scenario(pkg):
        ring = _ring(pkg, 4096)
        region = ring.lease_region(1024)
        held = fleet_reading(pkg, "hbm_ring_occupancy_bytes", ring)
        payload = np.arange(256, dtype=np.int32)
        _, deltas, hbm_b, hbm_c, _ = _landing_deltas(
            pkg, lambda: region.fill(payload))
        region.view(dtype=np.int32, shape=(256,)).release()
        region.release()
        return (held, deltas, hbm_b, hbm_c,
                fleet_reading(pkg, "hbm_ring_occupancy_bytes", ring))

    assert both(scenario) == (1024.0, [1, 1024], 1024, 1024, 0.0)


def test_decode_tree_to_ring_is_the_decode_hop():
    """The device-plane decode counts the tree's payload on the ``decode``
    hop once, and its one batched landing on the ``hbm`` hop."""
    rng = np.random.default_rng(13)
    tree = {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": rng.integers(0, 9, 33).astype(np.int64)}

    def scenario(pkg):
        codec = mod(pkg, "shim.codec")
        tep = mod(pkg, "tpu.endpoint")
        leaves = (tree if pkg is REF
                  else {k: torch.from_numpy(v) for k, v in tree.items()})
        buf = bytearray(b"".join(bytes(s) for s in codec.encode_tree(leaves)))
        ring = _ring(pkg, 1 << 14)
        d0, h0 = hop(pkg, "decode"), hop(pkg, "hbm")
        m0 = counter(pkg, "hbm_place_msgs")
        out, leases = tep.decode_tree_to_ring(ring, buf)
        d1, h1 = hop(pkg, "decode"), hop(pkg, "hbm")
        for le in leases:
            le.release()
        return (d1[0] - d0[0], d1[1] > d0[1], h1[0] - h0[0],
                counter(pkg, "hbm_place_msgs") - m0, sorted(out))

    assert both(scenario) == (128 + 264, True, 128 + 264, 2, ["a", "b"])


# ---------------------------------------------------------------------------
# the codec boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_encode_is_the_device_hop(layout):
    """Encode counts the tensor's bytes on the ``device`` hop, and as copy
    bytes only when a host input had to be made contiguous."""
    base = np.random.default_rng(14).standard_normal((16, 16)).astype(
        np.float32)
    x = base if layout == "contiguous" else base[:, ::2]

    def scenario(pkg):
        codec = mod(pkg, "shim.codec")
        h0 = hop(pkg, "device")
        segs = codec.encode_tensor(x)
        h1 = hop(pkg, "device")
        return (bytes(segs[1]) == np.ascontiguousarray(x).tobytes(),
                h1[0] - h0[0], h1[2] - h0[2], h1[1] > h0[1])

    n = x.size * 4
    assert both(scenario) == (True, n, 0 if layout == "contiguous" else n,
                              True)


@pytest.mark.parametrize("copy", [False, True])
def test_tree_decode_is_the_decode_hop(copy):
    rng = np.random.default_rng(15)
    tree = {"x": rng.standard_normal((3, 5)).astype(np.float32),
            "y": [rng.integers(0, 5, 7).astype(np.int32)]}

    def scenario(pkg):
        codec = mod(pkg, "shim.codec")
        buf = bytes(b"".join(bytes(s) for s in codec.encode_tree(tree)))
        h0 = hop(pkg, "decode")
        out, end = codec.decode_tree_at(buf, 0, copy=copy)
        h1 = hop(pkg, "decode")
        return end == len(buf), h1[0] - h0[0], h1[2] - h0[2]

    assert both(scenario) == (True, 88, 88 if copy else 0)


def test_materialization_is_the_jax_array_hop():
    """The reference's ``to_jax`` and the port's ``to_torch`` are the
    ``jax_array`` hop (the reference's name): on the CPU an alias, so bytes
    but no copy bytes."""
    x = np.random.default_rng(16).standard_normal(64).astype(np.float32)

    def scenario(pkg):
        codec = mod(pkg, "shim.codec")
        h0 = hop(pkg, "jax_array")
        if pkg is REF:
            codec.to_jax(x.copy())
        else:
            codec.to_torch(torch.from_numpy(x.copy()), "cpu")
        h1 = hop(pkg, "jax_array")
        return h1[0] - h0[0], h1[2] - h0[2]

    assert both(scenario) == (256, 0)


# ---------------------------------------------------------------------------
# the fan-in batcher and the device merger
# ---------------------------------------------------------------------------

class _Gated:
    """A model whose first call parks on a gate, so that requests queue
    behind it."""

    def __init__(self):
        self.gate = threading.Event()
        self.entered = threading.Event()

    def __call__(self, tree):
        if not self.entered.is_set():
            self.entered.set()
            self.gate.wait(WAIT)
        return {"y": tree["x"] * 2}


def _batcher(pkg, fn, **kw):
    svc = mod(pkg, "shim.service")
    if pkg is PORT:
        kw["device"] = "cpu"
    return svc.FanInBatcher(fn, **kw)


def _rows(pkg, i: int):
    x = np.full((1, 3), float(i), np.float32)
    return {"x": x if pkg is REF else torch.from_numpy(x)}


@pytest.mark.parametrize("queued", [2, 4])
def test_batcher_counts_batches_rows_and_flush_reasons(clean_obs, queued):
    """One gated request flushes on the timer; ``queued`` requests that
    wait behind it flush as one batch (on size when they fill it): the
    counters, ``fanin_batch``, one ``batch-flush`` event per batch with
    its reason code and size, and the queue-depth gauge while they wait."""
    def scenario(pkg):
        fl = pkg.flight
        reasons = ("size", "timer", "drained", "close")
        r0 = [counter(pkg, f"batcher_flush_{r}") for r in reasons]
        b0 = counter(pkg, "batcher_batches"), counter(pkg, "batcher_rows")
        f0 = hist(pkg, "fanin_batch")
        model = _Gated()
        b = _batcher(pkg, model, max_batch=queued, max_delay_s=0.01)
        outs = {}

        def call(i):
            outs[i] = b(_rows(pkg, i))

        try:
            ts = [threading.Thread(target=call, args=(0,))]
            ts[0].start()
            assert model.entered.wait(WAIT)
            for i in range(1, queued + 1):
                ts.append(threading.Thread(target=call, args=(i,)))
                ts[-1].start()
            poll(lambda: len(b._queue) == queued, WAIT)
            depth = fleet_reading(pkg, "batcher_queue_depth", b)
            model.gate.set()
            for t in ts:
                t.join(WAIT)
            poll(lambda: counter(pkg, "batcher_batches") - b0[0] >= 2, WAIT)
        finally:
            model.gate.set()
            b.close()
        flush = [(e["a1"], e["a2"]) for e in fl.snapshot()
                 if e["event"] == "batch-flush"]
        f1 = hist(pkg, "fanin_batch")
        return (sorted(outs), depth,
                [counter(pkg, f"batcher_flush_{r}") - c
                 for r, c in zip(reasons, r0)],
                counter(pkg, "batcher_batches") - b0[0],
                counter(pkg, "batcher_rows") - b0[1],
                f1[0] - f0[0], f1[1] - f0[1], flush)

    code = REF.flight.FLUSH_REASON_CODE
    assert both(scenario) == (
        list(range(queued + 1)), float(queued), [1, 1, 0, 0], 2,
        queued + 1, 2, queued + 1, [(code["timer"], 1),
                                    (code["size"], queued)])


def test_batcher_spans_carry_the_callers_trace(clean_obs):
    """A request enqueued under a trace context gets ``batch-wait`` and
    ``infer`` spans in that trace, in that order, ``infer`` carrying the
    batch's rows."""
    def scenario(pkg):
        tr = pkg.tracing
        tr.force(True)
        b = _batcher(pkg, lambda t: {"y": t["x"] + 1}, max_batch=4,
                     max_delay_s=0.01)
        try:
            ctx = tr.maybe_sample()
            with tr.use(ctx):
                b(_rows(pkg, 5))
            spans = []
            deadline = time.monotonic() + WAIT
            while len(spans) < 2 and time.monotonic() < deadline:
                spans = sorted(tr.spans(ctx.trace_id),
                               key=lambda s: s["t0_ns"])
                time.sleep(0.01)
            return ([s["name"] for s in spans],
                    [s.get("attrs", {}).get("rows") for s in spans])
        finally:
            b.close()

    assert both(scenario) == (["batch-wait", "infer"], [None, 1])


def test_device_merger_counts_dispatches_and_subbatches():
    def scenario(pkg):
        svc = mod(pkg, "shim.service")
        kw = {"device": "cpu"} if pkg is PORT else {}
        m = svc.DeviceMerger(lambda t: {"y": t["a"] * 3}, **kw)
        d0, s0 = counter(pkg, "merge_dispatches"), hist(pkg, "merge_subbatches")
        i0 = counter(pkg, "merge_isolated_failures")
        try:
            for n in (2, 3):
                a = np.ones((n, 2), np.float32)
                m.entry()({"a": a if pkg is REF else torch.from_numpy(a)})
        finally:
            m.close()
        s1 = hist(pkg, "merge_subbatches")
        return (counter(pkg, "merge_dispatches") - d0, s1[0] - s0[0],
                s1[1] - s0[1], counter(pkg, "merge_isolated_failures") - i0)

    assert both(scenario) == (2, 2, 2, 0)


# ---------------------------------------------------------------------------
# chaos: what the flight ring and the watchdog tell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plat", ["TCP", "RDMA_BPEV"])
def test_slow_peer_names_device_infer_stage(clean_obs, platform,
                                            fast_watchdog, plat):
    """A slow handler over a quiet transport is ``device-infer``, not a
    transport stage, and the trip lands inside the call."""
    platform(plat)

    def slow(req, ctx):
        time.sleep(1.2)
        return bytes(req)

    def scenario(pkg):
        srv, port = server(pkg, {"/obsdev.S/Slow": ("unary_unary", slow)})
        t_start = time.monotonic_ns()
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                mc = method(pkg, ch, "unary_unary", "/obsdev.S/Slow")
                out = []
                t = threading.Thread(
                    target=lambda: out.append(bytes(mc(b"z", timeout=30))))
                t.start()
                diag = _diagnose(pkg, "/obsdev.S/Slow", kind="server")
                t.join(30)
            t_done = time.monotonic_ns()
            trips = [e["t_ns"] for e in pkg.flight.snapshot()
                     if e["event"] == "watchdog-trip"
                     and t_start <= e["t_ns"] <= t_done]
            return (diag["stage"] if diag else None, out, bool(trips))
        finally:
            srv.stop(grace=0)

    assert both(scenario) == ("device-infer", [b"z"], True)


def _hold(port: int):
    """Bind ``port`` (not listening), so that no other server takes it
    between a server's stop and its successor's bind; None if taken."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind(("127.0.0.1", port))
    except OSError:
        s.close()
        return None
    return s


@pytest.mark.parametrize("plat", ["TCP", "RDMA_BPEV"])
def test_server_death_reconnect_flight_sequence(clean_obs, platform, plat):
    """After a server dies and a new one takes its port, the flight ring
    replays the story in order: ``conn-dead``, ``reconnect``,
    ``call-first-ok``."""
    platform(plat)

    def scenario(pkg):
        srv, port = _echo(pkg)
        srv2 = holder = None
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                mc = method(pkg, ch, "unary_unary", ECHO)
                assert bytes(mc(b"warm", timeout=30)) == b"warm"
                t_kill = time.monotonic_ns()
                srv.stop(grace=0)
                holder = _hold(port)
                failed = False
                for _ in range(20):
                    try:
                        mc(b"probe", timeout=5)
                    except (REF.status.RpcError, PORT.status.RpcError):
                        failed = True
                        break
                    time.sleep(0.05)
                if holder is not None:
                    holder.close()
                deadline = time.monotonic() + 20
                while srv2 is None and time.monotonic() < deadline:
                    try:
                        srv2 = pkg.server.Server(max_workers=4, **(
                            {"native_dataplane": False} if pkg is REF
                            else {}))
                        srv2.add_method(ECHO, pkg.server.
                                        unary_unary_rpc_method_handler(
                                            lambda req, ctx: bytes(req)))
                        srv2.add_insecure_port(f"127.0.0.1:{port}")
                        srv2.start()
                    except OSError:
                        srv2 = None
                        time.sleep(0.2)
                back = False
                deadline = time.monotonic() + 20
                while not back and time.monotonic() < deadline:
                    try:
                        back = bytes(mc(b"back", timeout=5)) == b"back"
                    except (REF.status.RpcError, PORT.status.RpcError):
                        time.sleep(0.1)
            return failed, back, _in_order(
                pkg.flight.snapshot(),
                ["conn-dead", "reconnect", "call-first-ok"], t_kill)
        finally:
            srv.stop(grace=0)
            if srv2 is not None:
                srv2.stop(grace=0)

    assert both(scenario) == (True, True, True)


def _settle_write_stalls(pkg):
    """Wait until no pair of an earlier scenario is write-stalled (a
    wedged pair's gauge would skew the next attribution)."""
    def quiet():
        g = pkg.metrics.registry().metrics().get("pairs_write_stalled")
        return g is None or g.collect()[0] == 0
    poll(quiet, 10)


@pytest.mark.parametrize("plat", ["TCP", "RDMA_BPEV"])
def test_partition_peer_stops_reading_names_stage(clean_obs, platform,
                                                  fast_watchdog, plat):
    """A peer that stays connected but stops reading wedges the server's
    stream: the watchdog names a known stage, on the ring plane a write-side
    one with the credit edge before the trip, and the trip is flight
    evidence on both planes."""
    platform(plat, TPURPC_RENDEZVOUS="0")
    chunk = b"\x5a" * (256 * 1024)

    def firehose(req, ctx):
        for _ in range(100_000):
            if not ctx.is_active():
                return
            yield chunk

    def scenario(pkg):
        _settle_write_stalls(pkg)
        srv, port = server(pkg, {"/obsdev.S/Hose": ("unary_stream",
                                                     firehose)})
        t_start = time.monotonic_ns()
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                call = method(pkg, ch, "unary_stream", "/obsdev.S/Hose")(
                    b"", timeout=60)
                it = iter(call)
                for _ in range(3):
                    next(it)
                diag = _diagnose(pkg, "/obsdev.S/Hose", timeout=15)
                snap = pkg.flight.snapshot()
                call.cancel()
            known = (diag is not None and diag["stage"] in pkg.watchdog.STAGES
                     and diag["stage"] != "unknown")
            if plat == "RDMA_BPEV":
                write_side = diag is not None and diag["stage"] in (
                    "credit-starvation", "peer-not-reading")
                edge = (_in_order(snap, ["credit-starve-begin"], t_start)
                        or _in_order(snap, ["write-stall-begin"], t_start))
            else:
                write_side = edge = None
            return (known, write_side, edge,
                    _in_order(snap, ["watchdog-trip"], t_start))
        finally:
            srv.stop(grace=0)
            _settle_write_stalls(pkg)

    got = both(scenario)
    assert got[0] and got[3]
    assert got[1:3] == ((True, True) if plat == "RDMA_BPEV" else (None, None))
