"""The port's observability core (``tpurpc_torch/obs``, ``utils/stats``)
against the reference's: the metrics registry, the stats façade and the
registry-backed copy ledgers, the trace context and its gates, and a
traced depth-4 pipeline through each package's channel and server.

The cases are ``tests/test_obs.py``'s that need no scrape server and no
native plane (the trace-flag cases are twinned in
``tests/test_torch_trace.py``). Each scenario runs on both packages with
the same inputs and the observations must be equal.
"""

import gc
import threading
import time

import numpy as np
import pytest

import torch

from torch_call_plane import BOTH, PORT, REF, Flaky, both, poll, serve
from torch_obs import clean_obs  # noqa: F401


# ---------------------------------------------------------------------------
# the metrics registry
# ---------------------------------------------------------------------------

def test_counter_gauge_basics():
    def scenario(pkg):
        reg = pkg.metrics.Registry()
        c = reg.counter("c")
        c.inc()
        c.inc(4)
        g = reg.gauge("g")
        g.set(3.5)
        g.inc()
        g.dec(0.5)
        try:
            reg.gauge("c")
            conflict = None
        except TypeError as exc:
            conflict = str(exc)
        return c.snapshot(), g.snapshot(), reg.counter("c") is c, conflict

    assert both(scenario) == (5, 4.0, True,
                              "metric 'c' already registered as Counter")


def test_size_histogram_exact_percentiles():
    def scenario(pkg):
        h = pkg.metrics.Registry().histogram("h")
        for v in (1, 1, 1, 2, 8, 0, -3):
            h.record(v)
        h.record_many([5000, 4, 0])
        return h.snapshot(), h.sum()

    snap, total = both(scenario)
    assert snap["count"] == 7 and snap["p50"] == 2 and snap["max"] == 5000
    assert total == 5017


@pytest.mark.parametrize("lo,hi", [(1000, 2000), (1, 100), (70000, 90000)])
def test_latency_histogram_interpolates_within_bucket(lo, hi):
    def scenario(pkg):
        h = pkg.metrics.Registry().histogram("lat", kind="latency")
        for v in range(lo, hi):
            h.record(v)
        return (h.percentile(0.5), h.percentile(0.99), h.snapshot())

    p50, p99, _ = both(scenario)
    assert p99 <= hi
    if (lo, hi) == (1000, 2000):
        assert 1300 <= p50 <= 1700  # a bucket bound would say 2048


def test_fleet_gauge_drops_dead_objects():
    class Obj:
        def __init__(self, depth):
            self.depth = depth

    def scenario(pkg):
        f = pkg.metrics.Registry().fleet("live_depth", lambda o: o.depth)
        a, b, c = Obj(7), Obj(5), Obj("torn")
        for o in (a, b, c):
            f.track(o)
        first = f.collect()
        del b
        gc.collect()
        return first, f.collect()

    assert both(scenario) == ((12.0, 2), (7.0, 1))


def test_registry_reset_keeps_fleet_membership():
    class Obj:
        pass

    def scenario(pkg):
        reg = pkg.metrics.Registry()
        reg.counter("x").inc(9)
        reg.labeled_counter("l", ("a",)).labels("k").inc()
        f = reg.fleet("objs")
        o = Obj()
        f.track(o)
        reg.reset()
        snap = reg.snapshot()
        return (reg.counter("x").snapshot(), snap["labeled"], f.collect(),
                sorted(snap))

    assert both(scenario) == (0, {"l": {}}, (1.0, 1),
                              ["counters", "fleet", "gauges", "histograms",
                               "labeled"])


def test_labeled_counter_overflow_is_bounded():
    def scenario(pkg):
        fam = pkg.metrics.Registry().labeled_counter("m", ("method",))
        for i in range(fam._MAX_CHILDREN + 8):
            fam.labels(f"/m{i}").inc()
        return (len(fam.snapshot()), fam.labels("/m0").name,
                fam.labels(f"/m{fam._MAX_CHILDREN + 7}").name)

    assert both(scenario) == (512, "m", "m:overflow")


# ---------------------------------------------------------------------------
# the stats façade and the copy ledgers fold into the registry
# ---------------------------------------------------------------------------

def test_stats_facade_is_registry_backed():
    def scenario(pkg):
        before = pkg.metrics.counter("obs_twin_counter").snapshot()
        pkg.stats.counter_inc("obs_twin_counter", 3)
        h = pkg.stats.batch_hist("obs_twin_hist")
        n0 = pkg.stats.batch_snapshot().get("obs_twin_hist",
                                             {"count": 0})["count"]
        h.record(4)
        return (pkg.metrics.counter("obs_twin_counter").snapshot() - before,
                h is pkg.metrics.histogram("obs_twin_hist"),
                pkg.stats.batch_snapshot()["obs_twin_hist"]["count"] - n0,
                isinstance(h, pkg.stats.BatchHist),
                pkg.stats.counters_snapshot()["obs_twin_counter"]
                == pkg.metrics.counter("obs_twin_counter").snapshot())

    assert both(scenario) == (3, True, 1, True, True)


def test_copy_ledger_backed_by_registry():
    def scenario(pkg):
        c = pkg.metrics.counter("copyledger_host_copy")
        before = c.snapshot()
        pkg.stats.ledger.add("host_copy", 64)
        try:
            pkg.stats.ledger.add("bogus", 1)
            bad = None
        except ValueError as exc:
            bad = str(exc)
        return (c.snapshot() - before, pkg.stats.ledger.host_copy - before,
                bad, sorted(pkg.stats.ledger.as_dict()))

    got = both(scenario)
    assert got[:2] == (64, 64) and "bogus" in got[2]


def test_port_tpu_ledger_is_registry_backed():
    """The port's device-path copy ledger keeps its counters in the port's
    registry (``ledger_<kind>``), and ``track()`` windows still measure
    deltas, as they do in the reference's own ledger."""
    reg = PORT.metrics.registry()

    def scenario(pkg):
        with pkg.ledger.track() as w:
            pkg.ledger.host_copy(100)
            pkg.ledger.dma_d2d(8)
            pkg.ledger.dma_d2d(0)  # nothing moved: not an op
        return w.delta

    delta = both(scenario)
    assert delta["host_copy"] == 100 and delta["dma_d2d_ops"] == 1
    before = reg.counter("ledger_rdma_write").snapshot()
    PORT.ledger.rdma_write(7)
    assert reg.counter("ledger_rdma_write").snapshot() == before + 7
    assert PORT.ledger.snapshot()["rdma_write"] == before + 7


def test_stats_hist_percentile_interpolated():
    def scenario(pkg):
        h = pkg.stats._Hist()
        for v in range(1000, 2000):
            h.record(v)
        return h.percentile(0.5), h.percentile(0.99), h.count

    p50, p99, n = both(scenario)
    assert 1300 <= p50 <= 1700 and p99 <= 2000 and n == 1000


def test_profile_spans_and_table(monkeypatch):
    """``profile`` spans record only while profiling is on, and the table
    lists each op once."""
    def scenario(pkg):
        pkg.stats.enable(False)
        with pkg.stats.profile("obs_twin_off"):
            pass
        pkg.stats.enable(True)
        try:
            for _ in range(3):
                with pkg.stats.profile("obs_twin_on"):
                    time.sleep(0.001)
        finally:
            pkg.stats.enable(None)
        snap = pkg.stats.snapshot()
        return ("obs_twin_off" in snap, snap["obs_twin_on"][0] >= 3,
                snap["obs_twin_on"][2] > 0)

    monkeypatch.delenv("TPURPC_PROFILING", raising=False)
    monkeypatch.delenv("GRPC_PROFILING", raising=False)
    assert both(scenario) == (False, True, True)


@pytest.mark.parametrize("val,on", [("1", True), ("micro", True),
                                    ("0", False), ("", False)])
def test_profiling_env_switch(monkeypatch, val, on):
    monkeypatch.delenv("GRPC_PROFILING", raising=False)
    monkeypatch.setenv("TPURPC_PROFILING", val)
    assert both(lambda pkg: pkg.stats.profiling_on()) is on


# ---------------------------------------------------------------------------
# the tracing core
# ---------------------------------------------------------------------------

def test_context_encode_decode_roundtrip():
    def scenario(pkg):
        T = pkg.tracing.TraceContext
        ctx = T(0xDEADBEEF12345678, 42, True)
        got = T.decode(ctx.encode())
        off = T(1, 2, False)
        prov = T(3, 4, provisional=True)
        return (ctx.encode(), (got.trace_id, got.span_id, got.sampled),
                T.decode(off.encode()).sampled, prov.encode(),
                T.decode(prov.encode().encode()).provisional,
                T.decode("garbage"), T.decode(b""),
                len(pkg.tracing.HEADER) + len(ctx.encode()))

    got = both(scenario)
    assert got[0] == "deadbeef12345678-0000002a-1" and got[-1] == 39


def test_disabled_tracing_is_inert(clean_obs):
    def scenario(pkg):
        t = pkg.tracing
        t.force(None)
        t.configure(0.0)
        t.tail(False)
        try:
            with t.span("nope") as sp:
                inside = sp
            return (t.ACTIVE, t.LIVE, t.maybe_sample(), t.current(), inside)
        finally:
            t.tail(None)

    assert both(scenario) == (False, False, None, None, None)


def test_sample_zero_yields_provisional_context(clean_obs):
    def scenario(pkg):
        t = pkg.tracing
        gates = (t.ACTIVE, t.LIVE)
        ctx = t.maybe_sample()
        with t.use(ctx):
            with t.span("hidden"):
                pass
        buffered = (t.spans(ctx.trace_id), t.tail_pending(ctx.trace_id))
        t.tail_commit(ctx.trace_id)
        return (gates, ctx.provisional, ctx.sampled, buffered,
                [s["name"] for s in t.spans(ctx.trace_id)])

    assert both(scenario) == ((False, True), True, True, ([], 1),
                              ["hidden"])


def test_span_record_and_tree(clean_obs):
    def scenario(pkg):
        t = pkg.tracing
        t.force(True)
        ctx = t.maybe_sample()
        with t.use(ctx):
            with t.span("outer"):
                t.record("manual", ctx, 123, 456, note="x")
        flat = t.spans(ctx.trace_id)
        tree = t.span_tree(f"{ctx.trace_id:016x}")
        chrome = t.chrome_trace(ctx.trace_id)
        xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
        metas = {e["name"] for e in chrome["traceEvents"] if e["ph"] == "M"}
        ev = {e["name"]: e for e in xs}
        return (sorted(s["name"] for s in flat),
                tree["trace_id"] == f"{ctx.trace_id:016x}",
                sorted(n["name"] for n in tree["spans"]), len(xs),
                sorted(metas), ev["manual"]["args"]["note"],
                ev["manual"]["dur"], sorted(chrome["clock_anchor"]))

    got = both(scenario)
    assert got[0] == ["manual", "outer"] and got[3] == 2


def test_span_nesting_and_cross_thread_spans(clean_obs):
    """``begin``/``finish`` spans end on another thread (the wire span);
    a child context keeps the trace and takes a fresh span id."""
    def scenario(pkg):
        t = pkg.tracing
        t.force(True)
        ctx = t.maybe_sample()
        child = ctx.child()
        sp = t.begin("wire", child)
        th = threading.Thread(target=lambda: t.finish(sp, ok=1))
        th.start()
        th.join(10)
        got = t.spans(ctx.trace_id)
        return (child.trace_id == ctx.trace_id,
                child.span_id != ctx.span_id,
                [(s["name"], s["parent_id"] == child.span_id,
                  s.get("attrs")) for s in got],
                t.begin("x", None), t.begin("x", t.TraceContext(1, 2, False)))

    assert both(scenario) == (True, True, [("wire", True, {"ok": 1})],
                              None, None)


@pytest.mark.parametrize("rate", ["0", "1", "junk", "7"])
def test_sample_rate_env(monkeypatch, clean_obs, rate):
    def scenario(pkg):
        monkeypatch.setenv("TPURPC_TRACE_SAMPLE", rate)
        pkg.tracing.configure()
        ctx = pkg.tracing.maybe_sample()
        return (pkg.tracing.ACTIVE, ctx is not None and not ctx.provisional)

    want = (rate in ("1", "7"),) * 2
    assert both(scenario) == want


# ---------------------------------------------------------------------------
# the acceptance path: a depth-4 pipeline, traced end to end
# ---------------------------------------------------------------------------

def _traced_pipeline(srv_root, cli_root):
    """Depth-4 pipelined calls from a ``cli_root`` channel to a ``srv_root``
    server with sampling forced on in both packages; the span names each
    package recorded per trace, and the replies."""
    import importlib

    server = importlib.import_module(f"{srv_root}.rpc.server")
    channel = importlib.import_module(f"{cli_root}.rpc.channel")
    srv = server.Server(max_workers=4)
    srv.add_method("/obs.S/Double", server.unary_unary_rpc_method_handler(
        lambda req, ctx: bytes(req) * 2))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        kw = {"tpurpc_native": False}
        with channel.Channel(f"127.0.0.1:{port}") as ch:
            pl = ch.unary_unary("/obs.S/Double", **kw).pipeline(depth=4)
            futs = [pl.call_async(b"%d" % i, timeout=60) for i in range(8)]
            replies = [bytes(f.result(60)) for f in futs]
            pl.close()
        names = {"client-send", "wire", "dispatch", "respond"}
        deadline = time.monotonic() + 10
        while True:
            by_trace = {}
            for pkg in BOTH:
                for s in pkg.tracing.spans():
                    by_trace.setdefault(s["trace_id"], []).append(s)
            done = {tid: ss for tid, ss in by_trace.items()
                    if names <= {s["name"] for s in ss}}
            if len(done) >= 8 or time.monotonic() >= deadline:
                break
            time.sleep(0.02)
        ordered = all(
            min(s["t0_ns"] for s in ss if s["name"] == "client-send")
            <= min(s["t0_ns"] for s in ss if s["name"] == "wire")
            for ss in done.values())
        return replies, len(done), ordered
    finally:
        srv.stop(grace=0)


def _traced_fanin(pkg):
    """Depth-4 pipelined tensor calls into ``pkg``'s own fan-in batching
    server: the replies' first values, the traces that carry all five
    spans, whether each orders them ``client-send <= wire <= batch-wait <=
    infer <= respond``, and whether ``fanin_batch`` counted every batch."""
    import importlib

    svc = importlib.import_module(
        "tpurpc.jaxshim.service" if pkg is REF
        else "tpurpc_torch.torchshim.service")
    fanin = pkg.metrics.histogram("fanin_batch")
    f0 = fanin.snapshot()["count"]

    def fn(t):
        return {"y": t["x"] * 2}

    if pkg is REF:
        import jax

        srv, port, batcher = svc.serve_jax(jax.jit(fn), batching=True,
                                           max_batch=4, max_delay_s=0.01)
        wrap = np.asarray
    else:
        srv, port, batcher = svc.serve_torch(fn, batching=True, max_batch=4,
                                             max_delay_s=0.01)
        wrap = torch.from_numpy
    try:
        with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
            cli = svc.TensorClient(ch, depth=4)
            futs = [cli.call_async("Call",
                                   {"x": wrap(np.full((1, 3), i, np.float32))},
                                   timeout=60)
                    for i in range(8)]
            firsts = [float(np.asarray(f.result(60)["y"]).ravel()[0])
                      for f in futs]
            for pl in cli._pipelines.values():
                pl.close()
        names = ("client-send", "wire", "batch-wait", "infer", "respond")
        deadline = time.monotonic() + 10
        while True:
            by_trace = {}
            for s in pkg.tracing.spans():
                by_trace.setdefault(s["trace_id"], []).append(s)
            done = {tid: ss for tid, ss in by_trace.items()
                    if set(names) <= {s["name"] for s in ss}}
            if len(done) >= 8 or time.monotonic() >= deadline:
                break
            time.sleep(0.02)
        ordered = True
        for ss in done.values():
            t0 = [min(s["t0_ns"] for s in ss if s["name"] == n)
                  for n in names]
            ordered &= t0 == sorted(t0)
        counted = poll(lambda: fanin.snapshot()["count"] - f0
                       == batcher.batches_run, 5)
        return firsts, len(done), ordered, bool(counted)
    finally:
        srv.stop(grace=0)
        batcher.close()


@pytest.mark.parametrize("srv,cli", [("tpurpc", "tpurpc_torch"),
                                     ("tpurpc_torch", "tpurpc"),
                                     ("tpurpc_torch", "tpurpc_torch"),
                                     ("fanin", "both")])
def test_depth4_pipeline_trace_python_plane(clean_obs, monkeypatch, srv,
                                            cli):
    """Every pipelined request leaves one trace whose spans
    (``client-send``, ``wire``, ``dispatch``, ``respond``) were recorded
    across the two ends, the port's context adopted by the reference's
    server and the reverse; the spans of a process's two packages meet by
    trace id. Through each package's fan-in batcher every trace also
    carries ``batch-wait`` and ``infer``, in order, and ``fanin_batch``
    counts every batch."""
    for pkg in BOTH:
        pkg.tracing.force(True)
    if srv == "fanin":
        from tpurpc_torch.utils import config as torch_config

        monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
        torch_config.set_config(None)
        try:
            firsts, traces, ordered, counted = both(_traced_fanin)
        finally:
            monkeypatch.undo()
            torch_config.set_config(None)
        assert firsts == [2.0 * i for i in range(8)]
        assert traces == 8 and ordered and counted
        return
    replies, traces, ordered = _traced_pipeline(srv, cli)
    assert replies == [b"%d" % i * 2 for i in range(8)]
    assert traces == 8 and ordered


def test_pipeline_metrics_count_every_call(clean_obs):
    """``pipeline_call_us`` and ``pipeline_demux_us`` record once per
    pipelined call, and ``srv_calls{method,code}`` once per handled call,
    in each package's registry."""
    def scenario(pkg):
        server = pkg.server
        channel = pkg.channel
        call_us = pkg.metrics.histogram("pipeline_call_us", kind="latency")
        demux = pkg.metrics.histogram("pipeline_demux_us", kind="latency")
        fam = pkg.metrics.labeled_counter("srv_calls", ("method", "code"))
        n0, d0 = call_us.snapshot()["count"], demux.snapshot()["count"]
        ok0 = fam.snapshot().get(("/obs.S/Echo", "0"), 0)
        srv = server.Server(max_workers=4)
        srv.add_method("/obs.S/Echo", server.unary_unary_rpc_method_handler(
            lambda req, ctx: bytes(req)))
        port = srv.add_insecure_port("127.0.0.1:0")
        srv.start()
        try:
            kw = {"tpurpc_native": False}
            with channel.Channel(f"127.0.0.1:{port}") as ch:
                pl = ch.unary_unary("/obs.S/Echo", **kw).pipeline(depth=4)
                out = [bytes(f.result(30)) for f in
                       [pl.call_async(b"e", timeout=30) for _ in range(12)]]
                pl.close()
            deadline = time.monotonic() + 5
            while (fam.snapshot().get(("/obs.S/Echo", "0"), 0) - ok0 < 12
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            srv.stop(grace=0)
        return (out == [b"e"] * 12, call_us.snapshot()["count"] - n0,
                demux.snapshot()["count"] - d0,
                fam.snapshot().get(("/obs.S/Echo", "0"), 0) - ok0)

    assert both(scenario) == (True, 12, 12, 12)


def test_trace_header_rides_headers_and_is_stripped(clean_obs):
    """With tail capture on (the default) both channels put the 39-byte
    ``tpurpc-trace`` entry on every call's HEADERS, and both servers strip
    it before the handler's metadata."""
    def scenario(pkg):
        server = pkg.server
        channel = pkg.channel
        seen = []

        def echo(req, ctx):
            seen.append([k for k, _ in ctx.invocation_metadata()])
            return bytes(req)

        srv = server.Server(max_workers=2)
        srv.add_method("/obs.S/Md", server.unary_unary_rpc_method_handler(
            echo))
        port = srv.add_insecure_port("127.0.0.1:0")
        srv.start()
        sent = []
        real = channel.fr.headers_payload

        def spy(method, md, timeout_us):
            sent.append([k for k, _ in md])
            return real(method, md, timeout_us)

        channel.fr.headers_payload = spy
        try:
            kw = {"tpurpc_native": False}
            with channel.Channel(f"127.0.0.1:{port}") as ch:
                body = np.arange(4, dtype=np.uint8).tobytes()
                got = bytes(ch.unary_unary("/obs.S/Md", **kw)(
                    body, timeout=30, metadata=[("x-a", "1")]))
        finally:
            channel.fr.headers_payload = real
            srv.stop(grace=0)
        return got, sent, seen

    got, sent, seen = both(scenario)
    assert sent == [["x-a", "tpurpc-trace"]] and seen == [["x-a"]]


@pytest.mark.parametrize("plan", ["hedge", "retry"])
def test_attempts_of_one_call_share_its_trace(clean_obs, plan):
    """A unary call draws its sampling decision once, and every attempt
    carries it: a hedged call's two attempts (the first replica held) and
    a retried call's two (the first fails UNAVAILABLE) send HEADERS with
    one trace id and a span id each."""
    def scenario(pkg):
        pkg.tracing.force(True)
        hold = threading.Event()
        if plan == "hedge":
            def who(i):
                def handler(req, ctx):
                    if i == 0:
                        hold.wait(20)
                    return b"%d" % i
                return handler

            rigs = [serve(pkg, {"/obs.S/Who": ("unary_unary", who(i))})
                    for i in range(2)]
            kw = dict(lb_policy="pick_first",
                      hedging_policy=pkg.channel.HedgingPolicy(
                          max_attempts=2, hedging_delay=0.02))
        else:
            rigs = [serve(pkg, {"/obs.S/Who": ("unary_unary",
                                               Flaky(pkg, 1))})]
            kw = dict(retry_policy=pkg.channel.RetryPolicy(
                max_attempts=2, initial_backoff=0.01))
        sent = []
        real = pkg.channel.fr.headers_payload

        def spy(method, md, timeout_us):
            sent.extend(v for k, v in md if k == pkg.tracing.HEADER)
            return real(method, md, timeout_us)

        pkg.channel.fr.headers_payload = spy
        try:
            target = "ipv4:" + ",".join(f"127.0.0.1:{p}" for _, p in rigs)
            with pkg.channel.Channel(target, **kw) as ch:
                for sc in ch._subchannels:
                    sc.get()
                mkw = {"tpurpc_native": False}
                out = bytes(ch.unary_unary("/obs.S/Who", **mkw)(
                    b"x", timeout=30))
        finally:
            pkg.channel.fr.headers_payload = real
            hold.set()
            for srv, _ in rigs:
                srv.stop(grace=0)
        ctxs = [pkg.tracing.TraceContext.decode(v) for v in sent]
        return (out, len(ctxs), len({c.trace_id for c in ctxs}),
                len({c.span_id for c in ctxs}), all(c.sampled for c in ctxs))

    out = {"hedge": b"1", "retry": b"ok:2"}[plan]
    assert both(scenario) == (out, 2, 1, 2, True)
