"""Twins of ``test_native_server.py``: a Python ``Server`` on a ring
platform hands its accepted ring connections to the C core's
shared-poller loop (``rpc/native_server.py``) with the Python handlers
trampolined back.

Every case runs on a cross pair, the reference's channel against an
adopting port ``Server`` and the port's channel against an adopting
reference ``Server``, and holds replies, statuses and metadata against
the reference pair's. Each package's client takes its own native fast
path where the reference's would.
"""

import threading
import time

import pytest

from torch_native import DIR_IDS, DIRS, code_name, on_platform, twin  # noqa: F401


def _four_shape_server(S):
    rpc = S.rpc
    srv = rpc.Server(max_workers=4)
    srv.add_method("/n.S/Echo", rpc.unary_unary_rpc_method_handler(
        lambda r, c: bytes(r), inline=True))
    srv.add_method("/n.S/Split", rpc.unary_stream_rpc_method_handler(
        lambda r, c: iter([bytes(r)] * 3)))
    srv.add_method("/n.S/Join", rpc.stream_unary_rpc_method_handler(
        lambda it, c: b"".join(bytes(m) for m in it)))

    def dbl(req_iter, ctx):
        for m in req_iter:
            yield bytes(m) * 2

    srv.add_method("/n.S/Dbl", rpc.stream_stream_rpc_method_handler(dbl))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _all_four_shapes(C, S):
    srv, port = _four_shape_server(S)
    try:
        adopted = srv._native_dp is not None
        with C.rpc.Channel(f"127.0.0.1:{port}") as ch:
            big = bytes(range(256)) * 8192  # 2 MiB: frame fragmentation
            return (adopted,
                    bytes(ch.unary_unary("/n.S/Echo")(b"u", timeout=20)),
                    [bytes(m) for m in ch.unary_stream("/n.S/Split")(
                        b"s", timeout=20)],
                    bytes(ch.stream_unary("/n.S/Join")(
                        iter([b"a", b"b"]), timeout=20)),
                    [bytes(m) for m in ch.stream_stream("/n.S/Dbl")(
                        iter([b"x", b"yy"]), timeout=20)],
                    bytes(ch.unary_unary("/n.S/Echo")(big, timeout=60))
                    == big)
    finally:
        srv.stop(grace=0)


def _metadata_abort_and_generic_dispatch(C, S):
    rpc = S.rpc
    srv = rpc.Server(max_workers=4)

    def meta(req, ctx):
        md = dict(ctx.invocation_metadata())
        ctx.send_initial_metadata((("x-init", "i1"),))
        ctx.set_trailing_metadata((("x-tr", "t1"),))
        return md.get("x-key", "?").encode()

    srv.add_method("/n.S/Meta", rpc.unary_unary_rpc_method_handler(meta))

    def fail(req, ctx):
        ctx.abort(S.status.StatusCode.FAILED_PRECONDITION, "nope")

    srv.add_method("/n.S/Fail", rpc.unary_unary_rpc_method_handler(fail))

    class GH:  # grpcio generic handler (the codegen registration shape)
        def service(self, hcd):
            if hcd.method == "/g.S/Up":
                return rpc.unary_unary_rpc_method_handler(
                    lambda r, c: bytes(r).upper())
            return None

    srv.add_generic_rpc_handlers((GH(),))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        adopted = srv._native_dp is not None
        with C.rpc.Channel(f"127.0.0.1:{port}") as ch:
            # metadata calls skip the CLIENT fast path but still land on
            # the natively adopted server; trailing metadata comes back
            resp, call = ch.unary_unary("/n.S/Meta").with_call(
                b"", timeout=20, metadata=(("x-key", "v1"),))
            init = ("x-init", "i1") in [tuple(x) for x in
                                        call.initial_metadata() or []]
            trail = ("x-tr", "t1") in [tuple(x) for x in
                                       call.trailing_metadata() or []]
            with pytest.raises(C.status.RpcError) as ei:
                ch.unary_unary("/n.S/Fail")(b"", timeout=20)
            failed = code_name(ei.value)
            up = bytes(ch.unary_unary("/g.S/Up")(b"abc", timeout=20))
            with pytest.raises(C.status.RpcError) as ei:
                ch.unary_unary("/none/None")(b"", timeout=20)
            missing = ei.value.code().name
        return adopted, bytes(resp), init, trail, failed, up, missing
    finally:
        srv.stop(grace=0)


def _eligibility_gates(C, S, monkeypatch):
    rpc = S.rpc
    seen = []

    class NoopInterceptor:
        def intercept_service(self, continuation, details):
            return continuation(details)

    # interceptors keep the server on the Python plane, and it serves
    srv = rpc.Server(max_workers=2, interceptors=(NoopInterceptor(),))
    srv.add_method("/n.S/Echo",
                   rpc.unary_unary_rpc_method_handler(lambda r, c: bytes(r)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        seen.append(srv._native_dp is None)
        with C.rpc.Channel(f"127.0.0.1:{port}") as ch:
            seen.append(bytes(ch.unary_unary("/n.S/Echo")(b"i", timeout=20)))
    finally:
        srv.stop(grace=0)
    # the explicit opt-outs: the keyword, then the environment
    for kw, env in (({"native_dataplane": False}, None), ({}, "0")):
        if env is not None:
            monkeypatch.setenv("TPURPC_NATIVE_SERVER", env)
        s2 = rpc.Server(max_workers=2, **kw)
        s2.add_method("/n.S/Echo", rpc.unary_unary_rpc_method_handler(
            lambda r, c: bytes(r)))
        s2.add_insecure_port("127.0.0.1:0")
        s2.start()
        try:
            seen.append(s2._native_dp is None)
        finally:
            s2.stop(grace=0)
    monkeypatch.delenv("TPURPC_NATIVE_SERVER")
    return seen


def _concurrent_multiplexed_calls(C, S):
    srv, port = _four_shape_server(S)
    try:
        errs = []

        def worker(i):
            try:
                with C.rpc.Channel(f"127.0.0.1:{port}") as ch:
                    echo = ch.unary_unary("/n.S/Echo")
                    for j in range(20):
                        body = f"w{i}-{j}".encode() + b"p" * (i * 53)
                        assert bytes(echo(body, timeout=30)) == body
            except Exception as exc:
                errs.append(exc)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        # liveness, not just error-freeness: a deadlocked worker fails
        return any(t.is_alive() for t in ts), [repr(e) for e in errs[:3]]
    finally:
        srv.stop(grace=0)


def _bulk_stream_no_token_stealing_stall(C, S):
    """32 MiB through a 256 KiB ring: a reader stealing a credit-blocked
    writer's wakeup would move one ring per poll slice (about 13 s)."""
    def total(req_iter, ctx):
        n = 0
        for m in req_iter:
            n += len(m)
        yield str(n).encode()

    srv = S.rpc.Server(max_workers=4)
    srv.add_method("/n.S/Total", S.rpc.stream_stream_rpc_method_handler(
        total))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    payload = b"\x5a" * (1024 * 1024)
    msgs = 32
    try:
        with C.rpc.Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.stream_stream("/n.S/Total")
            t0 = time.monotonic()
            out = [bytes(m) for m in mc(iter([payload] * msgs), timeout=60)]
            dt = time.monotonic() - t0
        return out, dt < 8.0
    finally:
        srv.stop(grace=0)


@pytest.mark.parametrize("client,server", DIRS, ids=DIR_IDS)
@pytest.mark.parametrize("plat", ["RDMA_BP", "RDMA_EVENT", "RDMA_BPEV"])
def test_adoption_serves_all_four_shapes(on_platform, plat, client, server):  # noqa: F811
    """All three wakeup disciplines: the adopted server's poller epolls the
    notify fd whatever the discipline."""
    on_platform(plat)
    assert twin(_all_four_shapes, client, server) == (
        True, b"u", [b"s"] * 3, b"ab", [b"xx", b"yyyy"], True)


@pytest.mark.parametrize("client,server", DIRS, ids=DIR_IDS)
def test_adoption_metadata_abort_and_generic_dispatch(on_platform, client,  # noqa: F811
                                                      server):
    on_platform("RDMA_BP")
    assert twin(_metadata_abort_and_generic_dispatch, client, server) == (
        True, b"v1", True, True, ("FAILED_PRECONDITION", "nope"), b"ABC",
        "UNIMPLEMENTED")


@pytest.mark.parametrize("client,server", DIRS, ids=DIR_IDS)
def test_adoption_eligibility_gates(on_platform, monkeypatch, client,  # noqa: F811
                                    server):
    on_platform("RDMA_BP")
    assert twin(_eligibility_gates, client, server, monkeypatch) == [
        True, b"i", True, True]


@pytest.mark.parametrize("client,server", DIRS, ids=DIR_IDS)
def test_adoption_concurrent_multiplexed_calls(on_platform, client, server):  # noqa: F811
    on_platform("RDMA_BP")
    assert twin(_concurrent_multiplexed_calls, client, server) == (False, [])


@pytest.mark.parametrize("client,server", DIRS, ids=DIR_IDS)
def test_bulk_stream_no_token_stealing_stall(on_platform, client, server):  # noqa: F811
    on_platform("RDMA_BP", GRPC_RDMA_RING_BUFFER_SIZE_KB="256")
    assert twin(_bulk_stream_no_token_stealing_stall, client, server) == (
        [str(32 << 20).encode()], True)
