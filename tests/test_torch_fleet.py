"""The port's load reports and ``least_loaded`` picking against the
reference's (``tests/test_fleet.py``'s load-report cases, and
``tests/test_serving.py::test_load_provider_reports_waiting_plus_swapped``).

* The ``tpurpc-load`` trailing-metadata value is byte-equal between the
  packages for the same in-flight count and queue depth (with both
  watchdogs' p99 held at 0); each carries its watchdog's rolling p99
  otherwise (``test_load_report_p99_is_zero_until_the_watchdog``).
* Every channel strips it from the app's trailing metadata, across the
  packages too, and feeds it to the LB policy.
* ``least_loaded`` over two port servers orders by the reported load,
  ejects a failing member and reinstates it.
* ``serve_torch``, ``serve_generation`` and ``serve_decode`` report their
  providers' depths.

Hedging and the pushback retry wait for retries in the port.
"""

import threading
import time

import numpy as np
import pytest
import torch

import tpurpc.rpc as jrpc
from tpurpc.obs import watchdog as jwatchdog
from tpurpc.rpc.server import AdmissionGate as JAdmissionGate
from tpurpc.rpc.server import LOAD_KEY as J_LOAD_KEY
from tpurpc.rpc.server import PUSHBACK_KEY as J_PUSHBACK_KEY
from tpurpc.rpc.channel import _LOAD_KEY as J_CHANNEL_LOAD_KEY
from tpurpc_torch.obs import watchdog as twatchdog
from tpurpc_torch.rpc import channel as tchannel
from tpurpc_torch.rpc import server as tserver
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.resolver import LeastLoaded
from tpurpc_torch.rpc.server import (AdmissionGate, Server,
                                     unary_unary_rpc_method_handler)
from tpurpc_torch.rpc.status import RpcError
from tpurpc_torch.serving.api import serve_generation
from tpurpc_torch.serving.disagg import serve_decode
from tpurpc_torch.torchshim import codec
from tpurpc_torch.torchshim.generate import ToyDecodeModel
from tpurpc_torch.torchshim.service import TensorClient, serve_torch
from tpurpc_torch.utils import config as torch_config

WHO = "/fleet.S/Who"


def _poll(pred, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(interval)
    return pred()


def _server(name: str, pkg=None, load=None, delay=0.0):
    pkg_server = jrpc.Server if pkg == "ref" else Server
    handler = (jrpc.unary_unary_rpc_method_handler if pkg == "ref"
               else unary_unary_rpc_method_handler)
    srv = pkg_server(max_workers=8)

    def who(req, ctx):
        if delay:
            time.sleep(delay)
        ctx.set_trailing_metadata([("app-key", "app-value")])
        return name.encode()

    srv.add_method(WHO, handler(who))
    if load is not None:
        srv.set_load_provider(load)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    """The port's entry points on the CPU."""
    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    torch_config.set_config(None)
    yield
    torch_config.set_config(None)


@pytest.fixture
def ref_p99_zero(monkeypatch):
    """Each package's report reads its watchdog's rolling p99, whose digits
    follow the process's earlier calls: hold both at 0 so that the two
    reports can be compared byte for byte."""
    monkeypatch.setattr(jwatchdog.get(), "rolling_p99_ns", lambda: 0)
    monkeypatch.setattr(twatchdog.get(), "rolling_p99_ns", lambda: 0)


def test_metadata_keys_agree_across_modules_and_packages():
    assert tchannel._LOAD_KEY == tserver.LOAD_KEY == J_LOAD_KEY \
        == J_CHANNEL_LOAD_KEY
    assert tserver.PUSHBACK_KEY == J_PUSHBACK_KEY


@pytest.mark.parametrize("inflight,qdepth", [(0, 0), (1, 0), (0, 7), (3, 5),
                                             (17, 250), (2, 123456)])
def test_load_report_bytes_equal_reference(inflight, qdepth, ref_p99_zero):
    """The same gate count and provider depth give the same report."""
    got = want = None
    for pkg in ("port", "ref"):
        gate = (JAdmissionGate if pkg == "ref"
                else AdmissionGate)(max(1, inflight), soft_limit=max(
                    1, inflight))
        srv = (jrpc.Server if pkg == "ref" else Server)(
            max_workers=2, admission=gate)
        for _ in range(inflight):
            assert gate.try_admit() is None
        srv.set_load_provider(lambda: qdepth)
        md = srv._load_md()
        srv.stop(grace=0)
        if pkg == "ref":
            want = md
        else:
            got = md
    assert got == want == [("tpurpc-load", f"{inflight},{qdepth},0.0")]
    assert got[0][1].encode() == want[0][1].encode()


def test_load_report_without_gate_counts_open_streams(ref_p99_zero):
    """No admission gate: both count the server's open streams."""
    reports = {}
    for pkg in ("port", "ref"):
        hold = threading.Event()
        srv = (jrpc.Server if pkg == "ref" else Server)(max_workers=8)
        handler = (jrpc.unary_unary_rpc_method_handler if pkg == "ref"
                   else unary_unary_rpc_method_handler)
        srv.add_method("/t.S/Hold", handler(
            lambda req, ctx: (hold.wait(10), b"ok")[1]))
        port = srv.add_insecure_port("127.0.0.1:0")
        srv.start()
        srv.set_load_provider(lambda: 4)
        ch = (jrpc.Channel if pkg == "ref" else Channel)(
            f"127.0.0.1:{port}")
        try:
            mc = ch.unary_unary("/t.S/Hold")
            futs = [mc.future(b"", timeout=20) for _ in range(3)]
            assert _poll(lambda: srv.inflight_requests() == 3)
            time.sleep(0.03)  # past the 20 ms report cache
            reports[pkg] = srv._load_md()
            hold.set()
            for f in futs:
                assert bytes(f.result(timeout=20)) == b"ok"
        finally:
            hold.set()
            ch.close()
            srv.stop(grace=0)
    assert reports["port"] == reports["ref"] == [("tpurpc-load", "3,4,0.0")]


def test_load_report_cache_and_switch(monkeypatch, ref_p99_zero):
    depth = [1]
    srv = Server(max_workers=2)
    srv.set_load_provider(lambda: depth[0])
    try:
        first = srv._load_md()
        depth[0] = 9
        assert srv._load_md() is first        # within 20 ms: the cache
        time.sleep(0.025)
        assert srv._load_md() == [("tpurpc-load", "0,9,0.0")]
        srv.set_load_provider(lambda: 1 // 0)  # a broken provider reads 0
        time.sleep(0.025)
        assert srv._load_md() == [("tpurpc-load", "0,0,0.0")]
    finally:
        srv.stop(grace=0)
    monkeypatch.setenv("TPURPC_LOAD_REPORTS", "0")
    for pkg_server in (Server, jrpc.Server):
        off = pkg_server(max_workers=1)
        assert off._load_md() == []
        off.stop(grace=0)


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_load_report_p99_is_zero_until_the_watchdog(server_pkg):
    """Each package's report carries its stall watchdog's worst rolling
    p99 (0.0 only until a method has history): after 12 calls of at least
    10 ms the server's report gives that p99, to one decimal of a
    millisecond, and a ``least_loaded`` channel reads it (smoothed) above
    0."""
    wd = (jwatchdog if server_pkg == "ref" else twatchdog).get()
    srv, port = _server("a", pkg=server_pkg if server_pkg == "ref" else None,
                        delay=0.01)
    try:
        with Channel(f"127.0.0.1:{port}", lb_policy="least_loaded") as ch:
            for _ in range(12):
                ch.unary_unary(WHO)(b"x", timeout=10)
            time.sleep(0.025)  # past the 20 ms report cache
            ch.unary_unary(WHO)(b"x", timeout=10)
            snap = ch._policy.snapshot()
        time.sleep(0.025)
        p99 = wd.rolling_p99_ns()
        report = srv._load_md()[0][1]
        assert snap["reported"] == [True] and snap["p99_ms"][0] > 0.0
        assert p99 is not None and p99 >= 10_000_000
        assert report.endswith(f",{p99 / 1e6:.1f}")
    finally:
        srv.stop(grace=0)


@pytest.mark.parametrize("server_pkg,channel_pkg", [
    ("port", "port"), ("port", "ref"), ("ref", "port")])
def test_load_report_stripped_from_app_metadata(server_pkg, channel_pkg):
    """The piggyback is transport-internal: the app's trailing metadata
    keeps its own keys and never the load key, whichever package sent or
    received it."""
    srv, port = _server("a", pkg=server_pkg if server_pkg == "ref" else None)
    try:
        chan = jrpc.Channel if channel_pkg == "ref" else Channel
        with chan(f"127.0.0.1:{port}") as ch:
            _resp, call = ch.unary_unary(
                WHO, tpurpc_native=False).with_call(b"x", timeout=10)
            md = list(call.trailing_metadata() or ())
        keys = [k for k, _v in md]
        assert "tpurpc-load" not in keys
        assert ("app-key", "app-value") in [(k, v if isinstance(v, str)
                                             else bytes(v).decode())
                                            for k, v in md]
    finally:
        srv.stop(grace=0)


def test_reports_reach_the_policy_from_either_server_package(ref_p99_zero):
    s1, p1 = _server("port", load=lambda: 6)
    s2, p2 = _server("ref", pkg="ref", load=lambda: 6)
    try:
        with Channel(f"ipv4:127.0.0.1:{p1},127.0.0.1:{p2}",
                     lb_policy="least_loaded") as ch:
            mc = ch.unary_unary(WHO)
            got = {bytes(mc(b"x", timeout=10)) for _ in range(6)}
            snap = ch._policy.snapshot()
        assert got == {b"port", b"ref"}
        assert snap["reported"] == [True, True]
        # both report 6 queued (+ the call's own stream, or 0 after it)
        assert all(6.0 <= v <= 7.0 for v in snap["load"]), snap
    finally:
        s1.stop(grace=0)
        s2.stop(grace=0)


def test_least_loaded_orders_by_reported_load_and_ejects_then_reinstates():
    busy, idle = [9], [0]
    s1, p1 = _server("busy", load=lambda: busy[0])
    s2, p2 = _server("idle", load=lambda: idle[0])
    s3 = None
    try:
        with Channel(f"ipv4:127.0.0.1:{p1},127.0.0.1:{p2}",
                     lb_policy="least_loaded", connect_timeout=2) as ch:
            pol = ch._policy
            pol.ejection_s = 1.0
            mc = ch.unary_unary(WHO)
            for _ in range(2):   # one report from each (rotating tiebreak)
                mc(b"x", timeout=10)
            assert pol.snapshot()["reported"] == [True, True]
            got = [bytes(mc(b"x", timeout=10)) for _ in range(8)]
            assert got == [b"idle"] * 8, got
            # the loads swap: the EWMA follows and the picks move
            busy[0], idle[0] = 0, 40
            time.sleep(0.025)
            got = [bytes(mc(b"x", timeout=10)) for _ in range(12)]
            assert got[-4:] == [b"busy"] * 4, got
            # the now-preferred member fails: its dials fail, it is
            # ejected (sorted last), and calls go to the other
            s1.stop(grace=0)
            # (no retries in the port: wait for the dead connection to be
            # seen, as a call already on it would fail UNAVAILABLE)
            assert _poll(lambda: ch._subchannels[0]._conn is None)
            got, snaps = [], []
            for _ in range(6):
                got.append(bytes(mc(b"x", timeout=10)))
                snaps.append(pol.snapshot()["ejected"])
            assert got == [b"idle"] * 6
            # three failed picks eject it (for ejection_s)
            assert [True, False] in snaps, snaps
            # back on its port: after ejection_s it is reinstated and,
            # reporting the lower load, picked again
            s3 = Server(max_workers=4)
            s3.add_method(WHO, unary_unary_rpc_method_handler(
                lambda req, ctx: b"back"))
            s3.set_load_provider(lambda: 0)
            assert s3.add_insecure_port(f"127.0.0.1:{p1}") == p1
            s3.start()
            assert _poll(lambda: bytes(mc(b"x", timeout=10)) == b"back",
                         timeout=15, interval=0.05)
            assert pol.snapshot()["ejected"] == [False, False]
    finally:
        for s in (s1, s2, s3):
            if s is not None:
                s.stop(grace=0)


def test_least_loaded_parse_tolerates_junk():
    assert LeastLoaded.parse_report(b"3,5,12.5") == (8.0, 12.5)
    assert LeastLoaded.parse_report(b"3") == (3.0, 0.0)
    assert LeastLoaded.parse_report(b"junk") is None
    assert LeastLoaded.parse_report("") is None
    pol = LeastLoaded(2)
    pol.load_report(7, b"1,1,1")  # out-of-range index: ignored
    pol.load_report(0, b"not,numbers")
    assert pol.snapshot()["reported"] == [False, False]


def test_least_loaded_ejects_slow_outlier():
    pol = LeastLoaded(3, slow_mult=3.0)
    for _ in range(4):
        pol.load_report(0, b"1,0,5.0")
        pol.load_report(1, b"1,0,5.0")
        pol.load_report(2, b"1,0,500.0")
    assert pol.snapshot()["ejected"] == [False, False, True]


# -- the serving entry points' providers ---------------------------------------

def test_serve_torch_reports_batcher_queue_depth(ref_p99_zero):
    gate = threading.Event()
    entered = threading.Event()

    def fn(tree):
        entered.set()
        gate.wait(20)
        return {"y": tree["x"] + 1}

    srv, port, batcher = serve_torch(fn, batching=True, max_batch=1,
                                     max_delay_s=0.0)
    try:
        assert srv._load_extra == batcher.queue_depth
        with Channel(f"127.0.0.1:{port}") as ch:
            pipe = TensorClient(ch).pipeline("Call", depth=4)
            futs = [pipe.call_async({"x": torch.full((1, 2), float(i))},
                                    timeout=30) for i in range(3)]
            assert entered.wait(10)
            # one request in the model, two queued behind it
            assert _poll(lambda: batcher.queue_depth() == 2)
            assert _poll(lambda: srv._load_md() == [
                ("tpurpc-load", "3,2,0.0")])
            gate.set()
            for i, f in enumerate(futs):
                assert f.result(timeout=20)["y"].tolist() == [[i + 1.0] * 2]
    finally:
        gate.set()
        srv.stop(grace=0)
        batcher.close()


def test_serve_torch_unbatched_reports_inflight_only(ref_p99_zero):
    srv, port, batcher = serve_torch(lambda t: t)
    try:
        assert batcher is None and srv._load_extra is None
        assert srv._load_md() == [("tpurpc-load", "0,0,0.0")]
    finally:
        srv.stop(grace=0)


def test_serve_generation_reports_waiting_plus_swapped(ref_p99_zero):
    """The reference's test_load_provider_reports_waiting_plus_swapped."""
    srv, port, sched = serve_generation(ToyDecodeModel(device="cpu"),
                                        max_batch=2)
    try:
        assert srv._load_extra == sched.load_depth  # bound-method equality
        sched._swapped.append(object())
        assert sched.load_depth() == sched.queue_depth() + 1
        time.sleep(0.025)
        assert srv._load_md() == [
            ("tpurpc-load", f"0,{sched.load_depth()},0.0")]
        sched._swapped.clear()
    finally:
        srv.stop(grace=0)
        sched.close()


def test_serve_decode_reports_waiting_plus_swapped(ref_p99_zero):
    srv, port, sched, state = serve_decode(
        ToyDecodeModel(device="cpu"), kv_blocks=16, block_bytes=256,
        kv_kind="local", name="fleet-dec")
    try:
        assert srv._load_extra == sched.load_depth
        sched._swapped.extend([object(), object()])
        time.sleep(0.025)
        assert srv._load_md() == [("tpurpc-load", "0,2,0.0")]
        sched._swapped.clear()
    finally:
        srv.stop(grace=0)
        sched.close()
        state.close()
        state.mgr.close()


def test_load_report_rides_every_terminal_response(ref_p99_zero):
    """Errors and streams end with the report too (the policy's feed)."""
    srv = Server(max_workers=4)
    srv.set_load_provider(lambda: 5)

    def boom(req, ctx):
        raise ValueError("nope")

    srv.add_method("/t.S/Boom", unary_unary_rpc_method_handler(boom))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    seen = []
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            conn = ch._connection()
            conn.on_load = seen.append
            with pytest.raises(RpcError):
                ch.unary_unary("/t.S/Boom")(b"", timeout=10)
            with pytest.raises(RpcError):
                ch.unary_unary("/t.S/Missing")(b"", timeout=10)
        assert len(seen) == 2
        assert all(bytes(v if isinstance(v, bytes) else v.encode())
                   .endswith(b",5,0.0") for v in seen)
    finally:
        srv.stop(grace=0)


def test_tensor_replies_strip_the_report_too():
    srv, port, batcher = serve_torch(lambda t: {"y": t["x"] * 3},
                                     batching=True)
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            x = np.arange(6, dtype=np.float32).reshape(1, 6)
            raw, call = ch.unary_unary("/tpurpc.Tensor/Call").with_call(
                codec.encode_tree_bytes({"x": torch.from_numpy(x)}),
                timeout=10)
            out = codec.decode_tree(raw, as_torch=True)
            assert np.array_equal(out["y"].numpy(), x * 3)
            assert "tpurpc-load" not in [k for k, _ in
                                         call.trailing_metadata() or ()]
    finally:
        srv.stop(grace=0)
        batcher.close()
