"""Channel connectivity against the reference's: twins of
``tests/test_dropin.py``'s connectivity, ``try_to_connect``,
``channel_ready_future`` and ``wait_for_state_change`` cases, each run on
both packages with the observed states compared by name, and
``aio.Channel.ping``.

Every wait is bounded; an event loop runs through ``asyncio.run`` only.
"""

import asyncio
import time
import types

import pytest

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc

REF = types.SimpleNamespace(name="ref", rpc=jrpc)
PORT = types.SimpleNamespace(name="port", rpc=trpc)
PKGS = (REF, PORT)


def both(scenario, *args):
    got = {pkg.name: scenario(pkg, *args) for pkg in PKGS}
    assert got["port"] == got["ref"], got
    return got["port"]


def _echo_server(pkg):
    srv = pkg.rpc.server(max_workers=2)
    srv.add_method("/d.S/Echo", pkg.rpc.unary_unary_rpc_method_handler(
        lambda r, c: bytes(r)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _poll_state(ch, want, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = ch.get_state()
        if st.name in want:
            return st.name
        time.sleep(0.05)
    return ch.get_state().name


def _states(pkg):
    srv, port = _echo_server(pkg)
    out = []
    try:
        ch = pkg.rpc.Channel(f"127.0.0.1:{port}")
        out.append(ch.get_state().name)  # nothing dialed yet
        out.append(bytes(ch.unary_unary("/d.S/Echo")(b"x", timeout=10)))
        out.append(ch.get_state().name)
        srv.stop(grace=0)
        try:
            ch.unary_unary("/d.S/Echo")(b"x", timeout=5)
            out.append("no error")
        except pkg.rpc.RpcError as exc:
            out.append(exc.code().name)
        # the connection died and a redial failed: backoff, not READY
        got = _poll_state(ch, ("TRANSIENT_FAILURE", "IDLE"))
        out.append(got in ("TRANSIENT_FAILURE", "IDLE"))
        ch.close()
        out.append(ch.get_state().name)
        return out
    finally:
        srv.stop(grace=0)


def test_channel_connectivity_states():
    assert both(_states) == ["IDLE", b"x", "READY", "UNAVAILABLE", True,
                             "SHUTDOWN"]


def _try_to_connect(pkg):
    srv, port = _echo_server(pkg)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            first = ch.get_state(try_to_connect=True).name
            # dialed with no RPC issued
            return first, _poll_state(ch, ("READY",))
    finally:
        srv.stop(grace=0)


def test_try_to_connect_kicks_idle_channel():
    assert both(_try_to_connect) == ("CONNECTING", "READY")


def _ready_future(pkg):
    srv, port = _echo_server(pkg)
    out = []
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            out.append(pkg.rpc.channel_ready_future(ch).result(timeout=15))
            out.append(ch.get_state().name)
        ch2 = pkg.rpc.Channel(f"127.0.0.1:{port}")
        out.append(ch2.wait_for_state_change(
            pkg.rpc.ChannelConnectivity.READY, timeout=0.2))
        ch2.close()
        # a closed channel: the future fails, it does not spin for ever
        try:
            pkg.rpc.channel_ready_future(ch2).result(timeout=15)
            out.append("resolved")
        except pkg.rpc.RpcError as exc:
            out.append(exc.code().name)
        return out
    finally:
        srv.stop(grace=0)


def test_channel_ready_future_and_wait_for_state_change():
    assert both(_ready_future) == [None, "READY", True, "UNAVAILABLE"]


def _wait_times_out(pkg):
    srv, port = _echo_server(pkg)
    try:
        with pkg.rpc.Channel(f"127.0.0.1:{port}") as ch:
            t0 = time.monotonic()
            changed = ch.wait_for_state_change(
                pkg.rpc.ChannelConnectivity.IDLE, timeout=0.3)
            return changed, 0.25 <= time.monotonic() - t0 < 5
    finally:
        srv.stop(grace=0)


def test_wait_for_state_change_times_out_on_an_idle_channel():
    assert both(_wait_times_out) == (False, True)


def _cancelled_future(pkg):
    with pkg.rpc.Channel("127.0.0.1:1") as ch:  # nothing listens there
        fut = pkg.rpc.channel_ready_future(ch)
        time.sleep(0.1)
        return fut.cancel(), fut.cancelled()


def test_channel_ready_future_cancels():
    assert both(_cancelled_future) == (True, True)


def test_connectivity_enum_matches_the_references():
    assert [(c.name, c.value) for c in trpc.ChannelConnectivity] == [
        (c.name, c.value) for c in jrpc.ChannelConnectivity]


def _aio_ping(pkg):
    srv, port = _echo_server(pkg)

    async def run():
        async with pkg.rpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            rtt = await ch.ping(timeout=5.0)
            reply = await ch.unary_unary("/d.S/Echo")(b"p", timeout=10)
            return 0 <= rtt < 5, bytes(reply)

    try:
        return asyncio.run(run())
    finally:
        srv.stop(grace=0)


def test_aio_channel_ping():
    assert both(_aio_ping) == (True, b"p")


@pytest.mark.parametrize("client", ["ref", "port"])
def test_ping_across_packages(client):
    """Each package's ``Channel.ping`` against the other's server."""
    cli = REF if client == "ref" else PORT
    srv_pkg = PORT if client == "ref" else REF
    srv, port = _echo_server(srv_pkg)
    try:
        with cli.rpc.Channel(f"127.0.0.1:{port}") as ch:
            assert 0 <= ch.ping(timeout=5.0) < 5
    finally:
        srv.stop(grace=0)
