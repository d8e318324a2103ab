"""Pipelined unary calls of the port (``UnaryUnary.pipeline`` /
``PipelinedUnary``, ``TensorClient.call_async``) against the reference's
Python plane, on the CPU.

Each case runs the same scenario on both packages — each package's client
against its own server — and compares what every future resolves to:

* stream-id demux — many concurrent calls on ONE connection each get their
  own response;
* out-of-order completion — a parked call does not block its siblings;
* window backpressure — the depth+1'th ``call_async`` blocks until a
  completion frees a slot;
* deadlines — a never-answered call fails DEADLINE_EXCEEDED and frees its
  window slot;
* per-call errors demux to their own futures;
* many responses on one connection (each message's credit is returned).
"""

import threading
import time

import numpy as np
import pytest
import torch

import tpurpc.rpc as jrpc
from tpurpc.jaxshim import TensorClient as JaxClient
from tpurpc.jaxshim import add_tensor_method as jax_add_tensor_method
from tpurpc.rpc.status import RpcError as JaxRpcError
from tpurpc.rpc.status import StatusCode as JaxCode
from tpurpc_torch.rpc import server as trpc
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.status import RpcError, StatusCode
from tpurpc_torch.torchshim import TensorClient, add_tensor_method

WAIT = 10.0


class _Side:
    """One package's echo server (with a parkable method) and its channel
    class."""

    def __init__(self, rpc, channel_cls, status):
        self.park = threading.Event()
        self.channel_cls = channel_cls
        self.status = status

        def echo(req, ctx):
            return b"ok:" + bytes(req)

        def parked(req, ctx):
            self.park.wait(WAIT)
            return b"late:" + bytes(req)

        def fail_odd(req, ctx):
            if int(bytes(req)) % 2:
                ctx.abort(status.FAILED_PRECONDITION, "odd rejected")
            return bytes(req)

        self.srv = rpc.Server(max_workers=8)
        for path, fn in (("/p/Echo", echo), ("/p/Park", parked),
                         ("/p/FailOdd", fail_odd)):
            self.srv.add_method(path, rpc.unary_unary_rpc_method_handler(fn))
        self.port = self.srv.add_insecure_port("127.0.0.1:0")
        self.srv.start()

    def channel(self):
        return self.channel_cls(f"127.0.0.1:{self.port}")

    def close(self):
        self.park.set()
        self.srv.stop(grace=0)


@pytest.fixture
def sides():
    both = {"jax": _Side(jrpc, jrpc.Channel, JaxCode),
            "torch": _Side(trpc, Channel, StatusCode)}
    yield both
    for s in both.values():
        s.close()


def _outcome(fut):
    try:
        return ("ok", fut.result(timeout=WAIT))
    except (RpcError, JaxRpcError) as exc:
        code = exc.code() if callable(exc.code) else exc.code
        return ("err", code.name, exc.details() if callable(exc.details)
                else exc.details)


@pytest.mark.parametrize("depth,calls", [(1, 5), (16, 48), (4, 200)])
def test_stream_id_demux_many_in_flight(sides, depth, calls):
    got = {}
    for name, side in sides.items():
        with side.channel() as ch:
            pl = ch.unary_unary("/p/Echo").pipeline(depth=depth)
            futs = [pl.call_async(b"r%d" % i, timeout=30) for i in range(calls)]
            got[name] = [_outcome(f) for f in futs]
    assert got["torch"] == got["jax"]
    assert got["torch"] == [("ok", b"ok:r%d" % i) for i in range(calls)]


def test_out_of_order_completion_does_not_block_siblings(sides):
    got = {}
    for name, side in sides.items():
        with side.channel() as ch:
            slow = ch.unary_unary("/p/Park").pipeline(depth=4).call_async(
                b"s", timeout=30)
            pl = ch.unary_unary("/p/Echo").pipeline(depth=4)
            fasts = [pl.call_async(b"f%d" % i, timeout=30) for i in range(8)]
            outs = [_outcome(f) for f in fasts]
            parked = not slow.done()   # still parked while siblings finished
            side.park.set()
            got[name] = (outs, parked, _outcome(slow))
    assert got["torch"] == got["jax"]
    assert got["torch"][1] is True and got["torch"][2] == ("ok", b"late:s")


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_window_backpressure_blocks_depth_plus_one(sides, depth):
    got = {}
    for name, side in sides.items():
        with side.channel() as ch:
            pl = ch.unary_unary("/p/Park").pipeline(depth=depth)
            first = [pl.call_async(b"a%d" % i, timeout=30)
                     for i in range(depth)]
            extra = []
            t = threading.Thread(
                target=lambda: extra.append(pl.call_async(b"c", timeout=30)),
                daemon=True)
            t.start()
            time.sleep(0.3)
            blocked = not extra        # the window is full: still waiting
            side.park.set()            # completions free slots
            t.join(WAIT)
            assert not t.is_alive()
            got[name] = (blocked, [_outcome(f) for f in first],
                         _outcome(extra[0]))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] is True
    assert got["torch"][2] == ("ok", b"late:c")


def test_pipelined_deadline_fails_future_and_frees_window(sides):
    got = {}
    for name, side in sides.items():
        with side.channel() as ch:
            pl = ch.unary_unary("/p/Park").pipeline(depth=1)
            expired = _outcome(pl.call_async(b"never", timeout=0.3))
            # the expired call released its slot: the next call on the SAME
            # depth-1 pipeline proceeds instead of wedging
            side.park.set()
            after = _outcome(pl.call_async(b"after", timeout=30))
            got[name] = (expired[:2], after)
    assert got["torch"] == got["jax"]
    assert got["torch"] == (("err", "DEADLINE_EXCEEDED"),
                            ("ok", b"late:after"))


def test_pipelined_errors_demux_to_their_own_futures(sides):
    got = {}
    for name, side in sides.items():
        with side.channel() as ch:
            pl = ch.unary_unary("/p/FailOdd").pipeline(depth=8)
            futs = [pl.call_async(b"%d" % i, timeout=30) for i in range(10)]
            got[name] = [_outcome(f) for f in futs]
    assert got["torch"] == got["jax"]
    for i, o in enumerate(got["torch"]):
        assert o == (("err", "FAILED_PRECONDITION", "odd rejected") if i % 2
                     else ("ok", b"%d" % i))


def test_unknown_method_fails_the_future(sides):
    got = {}
    for name, side in sides.items():
        with side.channel() as ch:
            fut = ch.unary_unary("/p/Nope").pipeline(depth=2).call_async(
                b"x", timeout=30)
            got[name] = _outcome(fut)[:2]
    assert got["torch"] == got["jax"] == ("err", "UNIMPLEMENTED")


def test_concurrent_connections_each_get_their_own_replies(sides):
    got = {}
    for name, side in sides.items():
        results = {}

        def one(c, side=side, results=results):
            with side.channel() as ch:
                pl = ch.unary_unary("/p/Echo").pipeline(depth=16)
                futs = [pl.call_async(b"c%d-%d" % (c, i), timeout=30)
                        for i in range(32)]
                results[c] = [_outcome(f) for f in futs]

        ts = [threading.Thread(target=one, args=(c,)) for c in range(4)]
        [t.start() for t in ts]
        [t.join(30) for t in ts]
        assert not any(t.is_alive() for t in ts)
        got[name] = results
    assert got["torch"] == got["jax"]
    assert got["torch"][3][31] == ("ok", b"ok:c3-31")


def test_future_runs_the_call_on_a_thread(sides):
    got = {}
    for name, side in sides.items():
        with side.channel() as ch:
            got[name] = _outcome(ch.unary_unary("/p/Echo").future(b"f",
                                                                   timeout=30))
    assert got["torch"] == got["jax"] == ("ok", b"ok:f")


@pytest.mark.parametrize("depth", [1, 8])
def test_tensor_client_call_async_roundtrip(depth, monkeypatch):
    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(depth)
    xs = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(12)]
    jsrv, tsrv = jrpc.Server(max_workers=4), trpc.Server(max_workers=4)
    jax_add_tensor_method(jsrv, "Dbl", lambda t: {"y": np.asarray(t["x"]) * 2})
    add_tensor_method(tsrv, "Dbl", lambda t: {"y": t["x"] * 2})
    jport, tport = (s.add_insecure_port("127.0.0.1:0") for s in (jsrv, tsrv))
    jsrv.start()
    tsrv.start()
    try:
        with jrpc.Channel(f"127.0.0.1:{jport}") as jch, \
                Channel(f"127.0.0.1:{tport}") as tch:
            jcli, tcli = JaxClient(jch, depth=depth), TensorClient(tch,
                                                                   depth=depth)
            jfuts = [jcli.call_async("Dbl", {"x": x}, timeout=30) for x in xs]
            tfuts = [tcli.call_async("Dbl", {"x": torch.from_numpy(x)},
                                     timeout=30) for x in xs]
            for x, jf, tf in zip(xs, jfuts, tfuts):
                want = np.asarray(jf.result(timeout=WAIT)["y"])
                got = tf.result(timeout=WAIT)["y"].numpy()
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(got, x * 2)
    finally:
        jsrv.stop(grace=0)
        tsrv.stop(grace=0)
