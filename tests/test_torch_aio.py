"""The asyncio surface (``tpurpc_torch.rpc.aio``) against the reference's.

Mirrors ``tests/test_aio.py`` (all of it but ``test_aio_native_channel`` and
the ``requires_native_lib`` case, which wait for the port of the C core):
each scenario runs on every client/server package pair, an ``aio`` channel
of one package against an ``aio`` server of the other, and its
observation (reply bytes, status codes by name, details, attempts a
handler saw) must be the one the reference's test asserts. Then the four
call shapes on a ring platform (``RDMA_BP``), both packages' grpcio-shaped
registration through ``aio.Server``, interceptors through
``aio.server(...)`` (the reference's drops them), and an async handler on
the CPU device ring (``TPU``) whose replies, kernel launches and ledger
deltas match the sync ``add_tensor_method(..., device=True)`` path.

Rules these tests keep, so that they leave nothing behind for the next
test in the same worker: the environment changes only through
``monkeypatch``; each package's cached config is reset after a platform
change; a registered resolver scheme is this file's own and is removed in
a ``finally``; every server is stopped and every channel closed in a
``finally``; every wait has its own timeout; ports are ephemeral; nothing
forks; each test runs its loop with ``asyncio.run`` and sets no loop or
policy.
"""

import asyncio
import threading
import time

import grpc
import numpy as np
import pytest
import torch

import tpurpc.rpc.aio as ref_aio
import tpurpc_torch.rpc as trpc
import tpurpc_torch.rpc.aio as port_aio
from chip_smoke import AioRingServer, CallPlaneServer
from torch_call_plane import (counted_plain, platform,  # noqa: F401
                             small_classify)
from tpurpc.rpc import channel as ref_channel
from tpurpc.rpc import resolver as ref_resolver
from tpurpc.rpc import status as ref_status
from tpurpc_torch.rpc import channel as port_channel
from tpurpc_torch.rpc import resolver as port_resolver
from tpurpc_torch.rpc import status as port_status
from tpurpc_torch.rpc.interceptors import ServerInterceptor
from tpurpc_torch.torchshim import codec
from tpurpc_torch.torchshim.service import TENSOR_SERVICE, TensorClient
from tpurpc_torch.tpu import ledger

AIO = {"ref": ref_aio, "port": port_aio}
STATUS = {"ref": ref_status, "port": port_status}
CHANNEL = {"ref": ref_channel, "port": port_channel}
RESOLVER = {"ref": ref_resolver, "port": port_resolver}
PAIRS = [("ref", "ref"), ("port", "port"), ("ref", "port"), ("port", "ref")]
PAIR_IDS = [f"{c}-to-{s}" for c, s in PAIRS]
#: every wait on a call or an event
WAIT_S = 20
#: the device-ring case: a 64 KiB ring and 8 requests of 12,288 bytes,
#: whose 6th landing from offset 0 wraps it
RING_KB, DR_SHAPE, DR_REQUESTS = 64, (2, 32, 16, 3), 8


def _observe(fn):
    """``await fn()``'s value, or ``("error", code name, details)`` when
    it raises an RpcError of either package."""
    async def run():
        try:
            return ("ok", await fn())
        except (ref_status.RpcError, port_status.RpcError) as exc:
            return ("error", exc.code().name, exc.details())
    return run()


async def _serve(pkg, methods, max_workers=8):
    """A started ``aio`` server of ``pkg`` with ``{path: (kind, fn)}``
    async behaviors; returns ``(server, port)``."""
    aio = AIO[pkg]
    srv = aio.Server(max_workers=max_workers)
    for path, (kind, fn) in methods.items():
        srv.add_method(path, getattr(aio, f"{kind}_rpc_method_handler")(fn))
    port = srv.add_insecure_port("127.0.0.1:0")
    await srv.start()
    return srv, port


def _shapes(pkg):
    """The reference test's four call shapes and its failing handler."""
    st = STATUS[pkg]

    async def echo(req, ctx):
        return bytes(req)

    async def tail(req, ctx):
        for i in range(4):
            yield bytes(req) + str(i).encode()

    async def collect(req_aiter, ctx):
        parts = []
        async for item in req_aiter:
            parts.append(bytes(item))
        return b"|".join(parts)

    async def chat(req_aiter, ctx):
        async for item in req_aiter:
            yield b"re:" + bytes(item)

    async def boom(req, ctx):
        raise st.AbortError(st.StatusCode.FAILED_PRECONDITION, "async nope")

    return {"/a.S/Echo": ("unary_unary", echo),
            "/a.S/Tail": ("unary_stream", tail),
            "/a.S/Collect": ("stream_unary", collect),
            "/a.S/Chat": ("stream_stream", chat),
            "/a.S/Boom": ("unary_unary", boom)}


async def _four_shapes(client, server, planes=None):
    """Every call shape once, and the failing handler; the observations.
    ``planes`` gets what served the connection: the endpoint's class of
    each connection the server keeps, and whether the reference's native
    plane adopted it."""
    srv, port = await _serve(server, _shapes(server))
    try:
        async with AIO[client].insecure_channel(f"127.0.0.1:{port}") as ch:
            unary = await _observe(lambda: ch.unary_unary("/a.S/Echo")(
                b"hello-aio", timeout=WAIT_S))

            async def tails():
                return [bytes(m) async for m in
                        ch.unary_stream("/a.S/Tail")(b"x", timeout=WAIT_S)]

            async def reqs(items):
                for item in items:
                    await asyncio.sleep(0)   # produced asynchronously
                    yield item

            async def collected():
                return bytes(await ch.stream_unary("/a.S/Collect")(
                    reqs((b"a", b"b", b"c")), timeout=WAIT_S))

            async def chats():
                return [bytes(m) async for m in ch.stream_stream(
                    "/a.S/Chat")(reqs((b"1", b"2")), timeout=WAIT_S)]

            boom = await _observe(lambda: ch.unary_unary("/a.S/Boom")(
                b"x", timeout=WAIT_S))
            if planes is not None:
                native = getattr(srv._sync, "_native_dp", None) is not None
                # the port's server lists a connection once it is adopted,
                # which may come after the first calls are answered
                deadline = time.monotonic() + WAIT_S
                while (not native and not srv._sync._connections
                       and time.monotonic() < deadline):
                    await asyncio.sleep(0.01)
                planes.append(([type(c.endpoint).__name__
                                for c in srv._sync._connections], native))
            return {"unary": unary, "server_streaming": await _observe(tails),
                    "client_streaming": await _observe(collected),
                    "bidi": await _observe(chats), "error": boom}
    finally:
        await srv.stop()


#: what the reference's test asserts of each shape
FOUR_SHAPES = {
    "unary": ("ok", b"hello-aio"),
    "server_streaming": ("ok", [b"x0", b"x1", b"x2", b"x3"]),
    "client_streaming": ("ok", b"a|b|c"),
    "bidi": ("ok", [b"re:1", b"re:2"]),
    "error": ("error", "FAILED_PRECONDITION", "async nope"),
}


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("shape", sorted(FOUR_SHAPES))
def test_call_shape_on_tcp(client, server, shape):
    """test_aio_unary, _server_streaming, _client_streaming_with_async_
    request_iterator, _bidi_streaming and _error_status, on each pair."""
    got = asyncio.run(_four_shapes(client, server))
    assert got[shape] == FOUR_SHAPES[shape]


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_handlers_overlap_on_one_loop(client, server):
    """Eight handlers in flight at once on the server's loop: each waits
    until all eight have entered, which only overlapping handlers reach
    (a serialized server would time the first one out)."""
    async def main():
        entered = {"n": 0, "most": 0, "now": 0}
        everyone = asyncio.Event()

        async def gate(req, ctx):
            entered["n"] += 1
            entered["now"] += 1
            entered["most"] = max(entered["most"], entered["now"])
            if entered["n"] == 8:
                everyone.set()
            try:
                await asyncio.wait_for(everyone.wait(), WAIT_S)
            finally:
                entered["now"] -= 1
            return bytes(req)

        srv, port = await _serve(server, {"/a.S/Gate": ("unary_unary",
                                                        gate)})
        try:
            async with AIO[client].insecure_channel(
                    f"127.0.0.1:{port}") as ch:
                call = ch.unary_unary("/a.S/Gate")
                outs = await asyncio.gather(*[
                    call(f"c{i}".encode(), timeout=WAIT_S + 10)
                    for i in range(8)])
        finally:
            await srv.stop()
        return [bytes(o) for o in outs], entered["most"]

    outs, most = asyncio.run(main())
    assert outs == [f"c{i}".encode() for i in range(8)]
    assert most == 8


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_abandoned_stream_does_not_wedge_channel(client, server):
    """Breaking out of a response stream cancels the call and leaves the
    channel usable, several calls over."""
    async def forever(req, ctx):
        i = 0
        while True:
            yield str(i).encode()
            i += 1
            await asyncio.sleep(0)

    async def echo(req, ctx):
        return bytes(req)

    async def main():
        srv, port = await _serve(server, {
            "/a.S/Forever": ("unary_stream", forever),
            "/a.S/Echo": ("unary_unary", echo)}, max_workers=4)
        try:
            async with AIO[client].insecure_channel(
                    f"127.0.0.1:{port}") as ch:
                stream = ch.unary_stream("/a.S/Forever")(b"go",
                                                         timeout=WAIT_S)
                seen = []
                async for item in stream:
                    seen.append(bytes(item))
                    if len(seen) == 3:
                        break
                await stream.aclose()
                call = ch.unary_unary("/a.S/Echo")
                after = [bytes(await call(f"p{i}".encode(), timeout=WAIT_S))
                         for i in range(4)]
        finally:
            await srv.stop()
        return seen, after

    seen, after = asyncio.run(main())
    assert seen == [b"0", b"1", b"2"]
    assert after == [b"p0", b"p1", b"p2", b"p3"]


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_deadline_exceeded(client, server):
    """A stalled handler surfaces DEADLINE_EXCEEDED through the asyncio
    surface and does not hang the loop."""
    release = threading.Event()

    async def stall(req, ctx):
        await asyncio.get_running_loop().run_in_executor(
            None, release.wait, WAIT_S)
        return b"late"

    async def main():
        srv, port = await _serve(server, {"/a.S/Stall": ("unary_unary",
                                                         stall)})
        try:
            async with AIO[client].insecure_channel(
                    f"127.0.0.1:{port}") as ch:
                return await _observe(lambda: ch.unary_unary("/a.S/Stall")(
                    b"x", timeout=0.5))
        finally:
            release.set()
            await srv.stop(grace=0)

    got = asyncio.run(main())
    assert got[:2] == ("error", "DEADLINE_EXCEEDED")


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_retry_policy_applies(client, server):
    """The client package's RetryPolicy reaches the aio surface: two
    UNAVAILABLE aborts, then the answer, in three attempts."""
    st = STATUS[server]
    calls = {"n": 0}

    async def flaky(req, ctx):
        calls["n"] += 1
        if calls["n"] < 3:
            ctx.abort(st.StatusCode.UNAVAILABLE, "flake")
        return b"ok"

    async def main():
        srv, port = await _serve(server, {"/a.S/Flaky": ("unary_unary",
                                                         flaky)})
        try:
            pol = CHANNEL[client].RetryPolicy(max_attempts=5,
                                              initial_backoff=0.01)
            async with AIO[client].insecure_channel(
                    f"127.0.0.1:{port}", retry_policy=pol) as ch:
                return await _observe(lambda: ch.unary_unary("/a.S/Flaky")(
                    b"", timeout=WAIT_S))
        finally:
            await srv.stop(grace=0)

    assert asyncio.run(main()) == ("ok", b"ok")
    assert calls["n"] == 3


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_channel_honors_resolver_service_config(client, server):
    """A resolver-delivered retryPolicy retries a flaky method from async
    call sites: 2 failures and 1 success, all by the config."""
    st = STATUS[server]
    calls = {"n": 0}
    lock = threading.Lock()
    scheme = f"torchaio{client}{server}"

    async def flaky(req, ctx):
        with lock:
            calls["n"] += 1
            n = calls["n"]
        if n <= 2:
            raise st.AbortError(st.StatusCode.UNAVAILABLE, "flaky")
        return b"ok-aio"

    cfg = {"methodConfig": [{
        "name": [{"service": "a.S", "method": "Flaky"}],
        "retryPolicy": {"maxAttempts": 4, "initialBackoff": "0.01s",
                        "maxBackoff": "0.05s", "backoffMultiplier": 2,
                        "retryableStatusCodes": ["UNAVAILABLE"]}}]}
    res = RESOLVER[client]

    async def main():
        srv, port = await _serve(server, {"/a.S/Flaky": ("unary_unary",
                                                         flaky)})
        res.register_resolver(scheme, lambda rest: res.Resolution(
            [("127.0.0.1", port)], cfg))
        try:
            async with AIO[client].insecure_channel(f"{scheme}:///x") as ch:
                return await _observe(lambda: ch.unary_unary("/a.S/Flaky")(
                    b"", timeout=WAIT_S))
        finally:
            res._RESOLVERS.pop(scheme, None)
            await srv.stop()

    assert asyncio.run(main()) == ("ok", b"ok-aio")
    assert calls["n"] == 3


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_four_shapes_on_a_ring_platform(platform, client, server):
    """The four call shapes and the error over the shared-memory ring
    (``RDMA_BP``): the same observations as on TCP."""
    platform("RDMA_BP")
    planes = []
    assert asyncio.run(_four_shapes(client, server, planes)) == FOUR_SHAPES
    # the port's server keeps a ring endpoint; the reference's native
    # plane adopts ring connections and keeps none in Python
    assert planes in ([(["RingEndpoint"], False)], [([], True)])


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_aio_server_takes_grpcio_handler_objects(pkg):
    """grpcio-generated registration through ``aio.Server``: a generic
    handler and ``add_registered_method_handlers`` with grpcio's handler
    objects, called by that package's aio channel with the keywords
    grpcio-generated stubs pass."""
    up = grpc.unary_unary_rpc_method_handler(lambda r, c: bytes(r).upper())
    low = grpc.unary_unary_rpc_method_handler(lambda r, c: bytes(r).lower())

    async def main():
        srv = AIO[pkg].server(max_workers=4, handlers=(
            grpc.method_handlers_generic_handler("g.S", {"Up": up}),))
        srv.add_registered_method_handlers("g.S", {"Low": low})
        port = srv.add_insecure_port("127.0.0.1:0")
        await srv.start()
        try:
            async with AIO[pkg].insecure_channel(f"127.0.0.1:{port}") as ch:
                outs = []
                for path, body in (("/g.S/Up", b"ab"), ("/g.S/Low", b"CD")):
                    mc = ch.unary_unary(path, request_serializer=None,
                                        response_deserializer=None,
                                        _registered_method=True)
                    outs.append(bytes(await mc(body, timeout=WAIT_S)))
                return outs
        finally:
            await srv.stop()

    assert asyncio.run(main()) == [b"AB", b"cd"]


def test_aio_server_passes_interceptors_to_the_server():
    """``aio.server(interceptors=[...])`` runs them (grpc.aio's contract);
    the reference's ``aio.server`` accepts the argument and drops it."""
    def run(aio):
        seen = []

        class Seen(ServerInterceptor):
            def intercept_service(self, continuation, details):
                seen.append(details.method)
                return continuation(details)

        async def echo(req, ctx):
            return bytes(req)

        async def main():
            srv = aio.server(max_workers=2, interceptors=[Seen()])
            srv.add_method("/a.S/Echo",
                           aio.unary_unary_rpc_method_handler(echo))
            port = srv.add_insecure_port("127.0.0.1:0")
            await srv.start()
            try:
                async with aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                    return bytes(await ch.unary_unary("/a.S/Echo")(
                        b"i", timeout=WAIT_S))
            finally:
                await srv.stop()

        return asyncio.run(main()), seen

    assert run(port_aio) == (b"i", ["/a.S/Echo"])
    assert run(ref_aio) == (b"i", [])


def test_aio_is_lazy_and_out_of_all():
    assert "aio" not in trpc.__all__
    assert trpc.aio is port_aio
    assert port_aio.__all__ == ref_aio.__all__


def _leaf_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in codec.tree_flatten(tree)[0])


def test_aio_handler_on_the_cpu_device_ring_matches_sync(platform,
                                                         counted_plain):
    """Phase 13 on the CPU: chip_smoke's ``AioRingServer`` on ``TPU``
    (a 64 KiB CPU ring) against the sync ``add_tensor_method(...,
    device=True)`` path on the same requests. One after another, the
    ledger deltas are the sync path's plus what the handler's
    ``tree_from_device`` bills (each reply leaf ``zero_copy`` on the CPU),
    but for the number of pieces the transport copies its bytes in, and
    the kernels' plain versions run as often; then all at once
    (``asyncio.gather``) and in one stream: the same replies, the landings
    wrap as their offsets say, the ring comes back whole, and the
    handlers overlap on the loop."""
    platform("TPU", TPURPC_HBM_RING_SIZE_KB=str(RING_KB))
    classify = small_classify()
    rng = np.random.default_rng(21)
    xs = [rng.standard_normal(DR_SHAPE).astype(np.float32)
          for _ in range(DR_REQUESTS)]
    span = xs[0].nbytes

    sync = CallPlaneServer(classify, max_workers=4)
    try:
        with trpc.insecure_channel(f"127.0.0.1:{sync.port}") as ch:
            client = TensorClient(ch)
            before = dict(counted_plain)
            with ledger.track() as w_sync:
                sync_out = [client.call("Classify",
                                        {"images": torch.from_numpy(x)},
                                        timeout=WAIT_S) for x in xs]
            sync_calls = {k: counted_plain[k] - before[k] for k in before}
            sync_stats = sync.ring().stats()
    finally:
        sync.server.stop()

    rig = AioRingServer(classify, max_workers=8)

    async def main():
        await rig.server.start()
        got = {}
        try:
            async with port_aio.insecure_channel(
                    f"127.0.0.1:{rig.port}") as ch:
                call = ch.unary_unary(f"/{TENSOR_SERVICE}/Classify",
                                      codec.tree_serializer,
                                      codec.tree_deserializer)
                trees = [{"images": torch.from_numpy(x)} for x in xs]
                before = dict(counted_plain)
                with ledger.track() as w_aio:
                    got["seq"] = [await call(t, timeout=WAIT_S)
                                  for t in trees]
                got["seq_calls"] = {k: counted_plain[k] - before[k]
                                    for k in before}
                got["w"] = w_aio.delta
                got["seq_stats"] = rig.ring().stats()
                rig.most = 0
                before = dict(counted_plain)
                got["gather"] = await asyncio.gather(
                    *[call(t, timeout=WAIT_S) for t in trees])
                got["gather_calls"] = {k: counted_plain[k] - before[k]
                                       for k in before}
                got["gather_most"] = rig.most

                async def agen():
                    for t in trees:
                        yield t

                before = dict(counted_plain)
                got["stream"] = [r async for r in ch.stream_stream(
                    f"/{TENSOR_SERVICE}/ClassifyStream",
                    codec.tree_serializer, codec.tree_deserializer)(
                        agen(), timeout=WAIT_S)]
                got["stream_calls"] = {k: counted_plain[k] - before[k]
                                       for k in before}
                got["stats"] = rig.ring().stats()
        finally:
            await rig.stop()
        return got

    got = asyncio.run(main())
    for name in ("seq", "gather", "stream"):
        assert len(got[name]) == DR_REQUESTS
        for s, r in zip(sync_out, got[name]):
            assert torch.equal(s["logits"], r["logits"])
            assert torch.equal(s["top1"], r["top1"])
    wraps = [sum(1 for k in range(DR_REQUESTS)
                 if (first + k * span) % (RING_KB << 10) + span
                 > RING_KB << 10)
             for first in (0, DR_REQUESTS * span, 2 * DR_REQUESTS * span)]
    assert wraps[0] > 0 and wraps[1] > 0
    assert sync_calls == got["seq_calls"] == {"ring_scatter": wraps[0],
                                              "ring_window": wraps[0]}
    assert got["gather_calls"] == {"ring_scatter": wraps[1],
                                   "ring_window": wraps[1]}
    assert got["stream_calls"] == {"ring_scatter": wraps[2],
                                   "ring_window": wraps[2]}
    total = {k: sum(got[f"{n}_calls"][k] for n in ("seq", "gather",
                                                    "stream"))
             for k in rig.launched}
    assert rig.launched == total
    # the sync path serializes its replies unbilled on the CPU;
    # tree_from_device bills each host reply leaf as zero_copy. The
    # transport copies a message's bytes in as many pieces as its reads
    # split it into, which varies from run to run on either path: its
    # bytes must match, its count of pieces need not
    reply = _leaf_bytes(sync_out[0])
    leaves = len(codec.tree_flatten(sync_out[0])[0])
    want = dict(w_sync.delta)
    want["zero_copy"] += DR_REQUESTS * reply
    want["zero_copy_ops"] += DR_REQUESTS * leaves
    aio_w = dict(got["w"])
    del want["host_copy_ops"], aio_w["host_copy_ops"]
    assert aio_w == want
    assert got["gather_most"] >= 2
    for st, tail in ((sync_stats, DR_REQUESTS * span),
                     (got["seq_stats"], DR_REQUESTS * span),
                     (got["stats"], 3 * DR_REQUESTS * span)):
        assert st["tail"] == tail
        assert st["writable"] == st["capacity"] and not st["live_spans"]
