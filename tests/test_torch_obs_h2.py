"""The gRPC wire plane's observability hooks (``wire/grpc_h2.py``,
``wire/h2_client.py``), the ``channel``, ``server``, ``shard`` and
``jaxshim`` trace flags, and the vocabulary of the whole slice, in the port
against the reference's.

Each scenario runs on both packages with the same inputs and the
observations must be equal: ``srv_calls{method,code}`` deltas, the h2
connection gauges' readings of the scenario's own connections, the adopted
``tpurpc-trace`` context's ``dispatch`` span, the watchdog's stage for an
h2 handler, and trace-flag log lines. The vocabulary case drives the same
traffic through both packages (a device-ring call, a rendezvous stream, a
fan-in batch and an h2 call) and compares the metric names, kinds and label
names, the profiler stages by module, and the flight event names by tag
prefix. The reference's servers run without their native data plane.
"""

import gc
import socket
import threading
import time

import numpy as np
import pytest
import torch

from torch_call_plane import BOTH, PORT, REF, both, platform, poll  # noqa: F401
from torch_obs import clean_obs, mod, server  # noqa: F401

ECHO = "/h2obs.S/Echo"
FAIL = "/h2obs.S/Fail"
WAIT = 10.0


def h2channel(pkg, port: int):
    return mod(pkg, "wire.h2_client").H2Channel(f"127.0.0.1:{port}")


def _fail(pkg):
    def fn(req, ctx):
        ctx.abort(pkg.status.StatusCode.NOT_FOUND, "no such thing")
    return fn


def _methods(pkg, **extra):
    out = {ECHO: ("unary_unary", lambda req, ctx: bytes(req)),
           FAIL: ("unary_unary", _fail(pkg))}
    out.update(extra)
    return out


def _rpc_errors():
    return (REF.status.RpcError, PORT.status.RpcError)


# ---------------------------------------------------------------------------
# the server's h2 plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 16])
def test_h2_srv_calls_by_method_and_code(n):
    """``srv_calls{method,code}`` counts every h2 call under its method and
    the status its trailers carried."""
    def scenario(pkg):
        fam = pkg.metrics.labeled_counter("srv_calls", ("method", "code"))
        keys = [(ECHO, "0"), (FAIL, "5")]
        c0 = [fam.snapshot().get(k, 0) for k in keys]
        srv, port = server(pkg, _methods(pkg))
        try:
            with h2channel(pkg, port) as ch:
                echo = ch.unary_unary(ECHO)
                outs = [bytes(echo(b"%d" % i, timeout=WAIT)) for i in range(n)]
                try:
                    ch.unary_unary(FAIL)(b"x", timeout=WAIT)
                    failed = None
                except _rpc_errors() as exc:
                    failed = exc.code().name
            poll(lambda: fam.snapshot().get(keys[1], 0) > c0[1], WAIT)
            return (outs == [b"%d" % i for i in range(n)], failed,
                    [fam.snapshot().get(k, 0) - c for k, c in zip(keys, c0)])
        finally:
            srv.stop(grace=0)

    assert both(scenario) == (True, "NOT_FOUND", [n, 1])


def _conns_of(pkg, name: str, pred):
    return [o for o in list(pkg.metrics.fleet(name)._refs) if pred(o)]


def test_h2_connection_gauges_follow_the_channel():
    """The server's connection is tracked by ``h2_server_connections`` while
    the channel is open and gone once it closes; the channel is tracked by
    ``h2_client_connections``; both window gauges read the connection
    window."""
    def scenario(pkg):
        srv, port = server(pkg, _methods(pkg))
        try:
            ch = h2channel(pkg, port)
            try:
                assert bytes(ch.unary_unary(ECHO)(b"a", timeout=WAIT)) == b"a"
                mine = _conns_of(pkg, "h2_server_connections",
                                 lambda c: c.server is srv)
                cli = _conns_of(pkg, "h2_client_connections",
                                lambda c: c is ch)
                win = pkg.metrics.fleet("h2_client_send_window_bytes")
                windows = (float(win._fn(ch)) == float(ch._conn_window._value),
                           len(_conns_of(pkg, "h2_server_send_window_bytes",
                                         lambda c: c.server is srv)))
                del mine
            finally:
                ch.close()

            def gone():
                gc.collect()
                return not _conns_of(pkg, "h2_server_connections",
                                     lambda c: c.server is srv)
            closed = poll(gone, WAIT)
            return len(cli), windows, bool(closed)
        finally:
            srv.stop(grace=0)

    assert both(scenario) == (1, (True, 1), True)


def test_h2_trace_header_is_adopted_with_a_dispatch_span(clean_obs):
    """A call carrying ``tpurpc-trace`` is served under that trace: the
    server records its ``dispatch`` span there, and the handler never sees
    the header."""
    def scenario(pkg):
        tr = pkg.tracing
        tr.force(True)
        seen = []

        def echo(req, ctx):
            seen.append(sorted(k for k, _ in ctx.invocation_metadata()))
            return bytes(req)

        srv, port = server(pkg, {ECHO: ("unary_unary", echo)})
        try:
            ctx = tr.TraceContext(0x1234ABCD5678EF00 + (pkg is PORT), 7)
            with h2channel(pkg, port) as ch:
                ch.unary_unary(ECHO)(b"t", timeout=WAIT,
                                     metadata=[(tr.HEADER, ctx.encode()),
                                               ("x-app", "1")])
            names = poll(lambda: [s["name"] for s in tr.spans(ctx.trace_id)],
                         WAIT)
            return names, seen
        finally:
            srv.stop(grace=0)

    assert both(scenario) == (["dispatch"], [["x-app"]])


def test_h2_handlers_register_with_the_watchdog(clean_obs):
    """A slow handler reached over h2 is watched like a native one: the
    watchdog names it ``device-infer`` under its method."""
    def slow(req, ctx):
        time.sleep(1.2)
        return bytes(req)

    def scenario(pkg):
        wd = pkg.watchdog.get()
        wd.reset()
        wd.min_stall_s, wd.sweep_s, wd.mult = 0.3, 0.1, 8.0
        srv, port = server(pkg, {"/h2obs.S/Slow": ("unary_unary", slow)})
        try:
            with h2channel(pkg, port) as ch:
                out = []
                t = threading.Thread(target=lambda: out.append(bytes(
                    ch.unary_unary("/h2obs.S/Slow")(b"s", timeout=30))))
                t.start()
                diag = None
                deadline = time.monotonic() + WAIT
                while diag is None and time.monotonic() < deadline:
                    time.sleep(0.1)
                    diag = next((d for d in wd.sweep_once()
                                 if d["method"] == "/h2obs.S/Slow"), None)
                t.join(30)
            return (diag["stage"], diag["kind"]) if diag else None, out
        finally:
            srv.stop(grace=0)
            wd.reset()

    assert both(scenario) == (("device-infer", "server"), [b"s"])


# ---------------------------------------------------------------------------
# trace flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag,module", [
    ("channel", "rpc.channel"), ("server", "rpc.server"),
    ("shard", "rpc.shard"), ("jaxshim", "shim.service")])
def test_module_trace_flags_carry_the_reference_names(flag, module):
    def scenario(pkg):
        mod(pkg, module)
        return flag in pkg.trace.list_tracers()

    assert both(scenario) is True


@pytest.fixture
def trace_env(monkeypatch):
    """``use(spec)``: both packages' trace flags set from ``GRPC_TRACE``,
    restored afterwards."""
    def use(spec):
        monkeypatch.setenv("GRPC_TRACE", spec)
        monkeypatch.delenv("TPURPC_TRACE", raising=False)
        for pkg in BOTH:
            pkg.trace.reapply_env()
    yield use
    monkeypatch.undo()
    for pkg in BOTH:
        pkg.trace.reapply_env()


def test_server_flag_logs_an_unknown_preface(trace_env, capfd):
    trace_env("server")

    def scenario(pkg):
        capfd.readouterr()
        srv, port = server(pkg, _methods(pkg))
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            try:
                s.sendall(b"ZZZZZZZZ")
                s.settimeout(5)
                closed = s.recv(64) == b""
            finally:
                s.close()
            err = poll(lambda: capfd.readouterr().err, 2) or ""
            return closed, "unknown protocol preface" in err
        finally:
            srv.stop(grace=0)

    assert both(scenario) == (True, True)


def test_channel_flag_logs_a_dead_connection(trace_env, capfd):
    trace_env("channel")

    def scenario(pkg):
        srv, port = server(pkg, _methods(pkg))
        kw = {"tpurpc_native": False} if pkg is REF else {}
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                mc = ch.unary_unary(ECHO, **kw)
                assert bytes(mc(b"w", timeout=WAIT)) == b"w"
                capfd.readouterr()
                srv.stop(grace=0)
                err = []
                try:    # a call surfaces the death in pump mode at once
                    mc(b"x", timeout=2)
                except _rpc_errors():
                    pass
                logged = poll(lambda: err.append(capfd.readouterr().err)
                              or "connection dead" in "".join(err), WAIT)
            return bool(logged)
        finally:
            srv.stop(grace=0)

    assert both(scenario) is True


# ---------------------------------------------------------------------------
# the slice's vocabulary
# ---------------------------------------------------------------------------

#: the slice's metrics (reference names), each registered at import or by
#: the traffic below in both packages
SLICE_METRICS = (
    "ring_msgs_read", "ring_bytes_read", "ring_msgs_written",
    "ring_bytes_written", "ring_credit_unpublished_bytes",
    "ring_in_flight_bytes", "pairs_connected", "pairs_write_stalled",
    "pairs_msg_waiting", "pairs_parked", "pair_resident_bytes_est",
    "ring_pool_leased_bytes", "ring_pool_free_bytes",
    "ring_write", "ring_drain", "poller_registered_pairs", "accept_shed",
    "ctrl_ring_posts", "ctrl_ring_records", "ctrl_ring_kicks",
    "ctrl_ring_full_fallbacks", "ctrl_ring_backlog", "rdv_transfers_sent",
    "rdv_transfers_received", "rdv_fallbacks", "rdv_claims_refused",
    "rdv_ctrl_frames", "rdv_window_share_hits", "hbm_place_msgs",
    "hbm_place_bytes", "hbm_ring_occupancy_bytes", "fanin_batch",
    "batcher_batches", "batcher_rows", "batcher_flush_size",
    "batcher_flush_timer", "batcher_flush_drained", "batcher_flush_close",
    "batcher_queue_depth", "merge_subbatches", "merge_dispatches",
    "merge_isolated_failures", "h2_server_connections",
    "h2_server_send_window_bytes", "srv_calls", "h2_client_connections",
    "h2_client_send_window_bytes",
) + tuple(f"lens_{h}_{k}" for h in ("device", "send_ring", "wire",
                                    "rendezvous", "ctrl", "peer_ring",
                                    "decode", "hbm", "jax_array")
          for k in ("bytes", "busy_ns", "copy_bytes"))

#: the basenames of the slice's modules, whose markers are compared
SLICE_FILES = ("ring.py", "pair.py", "poller.py", "endpoint.py",
               "ctrlring.py", "rendezvous.py", "frame.py", "hbm_ring.py",
               "codec.py", "service.py", "grpc_h2.py", "h2_client.py")

#: tag prefixes whose flight events the traffic must produce alike, and
#: the events compared (a hybrid waiter's mode flips, and whether a pair
#: sees its peer's exit before its own close, follow the host's timing)
PREFIXES = {"pair:": ("pair-connect", "pair-disconnect"),
            "rdv:": ("rdv-offer", "rdv-claim", "rdv-write", "rdv-complete",
                     "rdv-release"),
            "h2srv:": ("h2-window-exhausted",),
            "h2cli:": ("h2-window-exhausted",)}


def _kind(m):
    out = [type(m).__name__, getattr(m, "kind", None)]
    if hasattr(m, "labelnames"):
        out.append(tuple(m.labelnames))
    return tuple(out)


def _traffic(pkg):
    """A device-ring tensor call, a rendezvous stream, a fan-in batch and
    an h2 call, through ``pkg``'s own server and channels."""
    svc = mod(pkg, "shim.service")
    codec = mod(pkg, "shim.codec")
    kw = {"tpurpc_native": False} if pkg is REF else {}
    tensor = (lambda a: a) if pkg is REF else torch.from_numpy

    def dev(tree):
        return {"y": tree["x"] * 2}

    def stream(req_iter, ctx):
        for m in req_iter:
            yield bytes(m)

    srv, port = server(pkg, _methods(pkg, **{
        "/h2obs.S/Stream": ("stream_stream", stream)}))
    svc.add_tensor_method(srv, "Dev", dev, device=True)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    big = bytes(range(256)) * 2048
    try:
        with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
            call = ch.unary_unary("/tpurpc.Tensor/Dev", codec.tree_serializer,
                                  codec.tree_deserializer, **kw)
            y = call({"x": tensor(x)}, timeout=WAIT)["y"]
            ok_dev = np.array_equal(np.asarray(y), x * 2)
            st = ch.stream_stream("/h2obs.S/Stream", **kw)
            ok_stream = [bytes(r) for r in st(iter([big, big]),
                                              timeout=WAIT)] == [big, big]
        with h2channel(pkg, port) as h2:
            ok_h2 = bytes(h2.unary_unary(ECHO)(b"h", timeout=WAIT)) == b"h"
    finally:
        srv.stop(grace=0)
    if pkg is REF:
        bsrv, bport, batcher = svc.serve_jax(dev, batching=True, max_batch=4)
    else:
        bsrv, bport, batcher = svc.serve_torch(dev, batching=True,
                                               max_batch=4)
    try:
        with pkg.channel.Channel(f"127.0.0.1:{bport}") as ch:
            call = ch.unary_unary("/tpurpc.Tensor/Call", codec.tree_serializer,
                                  codec.tree_deserializer, **kw)
            ok_batch = all(
                np.array_equal(np.asarray(call({"x": tensor(x[i:i + 1])},
                                               timeout=WAIT)["y"]),
                               x[i:i + 1] * 2) for i in range(3))
    finally:
        bsrv.stop(grace=0)
        batcher.close()
    return ok_dev, ok_stream, ok_h2, ok_batch


def test_slice_vocabulary_matches_the_reference(clean_obs, platform):
    platform("TPU")

    def scenario(pkg):
        t0 = time.monotonic_ns()
        oks = _traffic(pkg)
        reg = pkg.metrics.registry().metrics()
        metrics = {n: _kind(reg[n]) if n in reg else None
                   for n in SLICE_METRICS}
        stages = {}
        for (base, _fn), stage in pkg.profiler.markers().items():
            if base in SLICE_FILES:
                stages.setdefault(base, set()).add(stage)
        by_prefix = {p: set() for p in PREFIXES}
        for e in pkg.flight.snapshot(since_ns=t0):
            for p, names in PREFIXES.items():
                if e["entity"].startswith(p) and e["event"] in names:
                    by_prefix[p].add(e["event"])
        return oks, metrics, stages, by_prefix

    oks, metrics, stages, by_prefix = both(scenario)
    assert oks == (True, True, True, True)
    assert None not in metrics.values(), metrics
    assert set(stages) == set(SLICE_FILES)
    assert {"pair-connect"} <= by_prefix["pair:"]
    assert {"rdv-offer", "rdv-claim", "rdv-write",
            "rdv-complete"} <= by_prefix["rdv:"]
