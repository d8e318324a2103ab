"""The port's flight recorder, stall watchdog and tail capture
(``tpurpc_torch/obs/{flight,watchdog,tracing}.py``) against the
reference's, and the call plane's hooks that feed them: the RED counters,
the pipelined deadline's counter and flight event, and a slow call's
span tree at a sample rate of 0.

The cases are ``tests/test_flight.py``'s but for the pair's stall edges
(the transport's hooks, ROADMAP A4 (b)), the scrape routes (their twins
are in ``tests/test_torch_scrape.py``) and the lint rule (A12). Each scenario runs on both packages with the same
inputs and the observations must be equal; scenarios read only their own
flight tags or a recorder of their own.
"""

import struct
import threading
import time

import pytest

from torch_call_plane import PORT, REF, both
from torch_obs import clean_obs  # noqa: F401

pytestmark = pytest.mark.usefixtures("clean_obs")


def _events(pkg, tag_name=None):
    evs = pkg.flight.snapshot()
    if tag_name is not None:
        evs = [e for e in evs if e["entity"] == tag_name]
    return [e["event"] for e in evs]


# ---------------------------------------------------------------------------
# the recorder: ring bounds, wrap, encoder reuse, tags
# ---------------------------------------------------------------------------

def test_ring_wrap_keeps_newest_and_stays_bounded():
    def scenario(pkg):
        rec = pkg.flight.FlightRecorder(capacity=8)
        for i in range(20):
            rec.emit(pkg.flight.PAIR_CONNECT, 0, i)
        events = rec.snapshot()
        return (len(events), [e["a1"] for e in events],
                len(rec._buf) == 8 * pkg.flight.RECORD_BYTES)

    assert both(scenario) == (8, list(range(12, 20)), True)


def test_encoder_reuse_no_reallocation():
    def scenario(pkg):
        rec = pkg.flight.FlightRecorder(capacity=16)
        buf_id = id(rec._buf)
        for i in range(100):
            rec.emit(pkg.flight.BATCH_FLUSH, 0, i % 4, i)
        same = id(rec._buf) == buf_id
        rec.enabled = False
        before = rec.snapshot()
        rec.emit(pkg.flight.PAIR_CONNECT, 0, 1)
        return same, len(rec._buf), rec.snapshot() == before, len(before)

    assert both(scenario) == (True, 16 * 32, True, 16)


def test_record_fields_roundtrip_and_time_order():
    def scenario(pkg):
        rec = pkg.flight.FlightRecorder(capacity=64)
        rec.emit(pkg.flight.LEASE_RESERVE, 3, 12345, -7)
        rec.emit(pkg.flight.LEASE_COMMIT, 3, 12345)
        events = rec.snapshot()
        e = events[0]
        rec.emit(pkg.flight.PAIR_CONNECT, 0, 1 << 80, -(1 << 80))
        got = rec.snapshot()[-1]
        return ([x["event"] for x in events], (e["tag"], e["a1"], e["a2"]),
                e["tid"] == threading.get_ident() & 0xFFFFFFFF,
                events[0]["t_ns"] <= events[1]["t_ns"],
                (got["a1"], got["a2"]))

    assert both(scenario) == (["lease-reserve", "lease-commit"],
                              (3, 12345, -7), True, True,
                              ((1 << 63) - 1, -(1 << 63)))


def test_torn_records_are_skipped():
    def scenario(pkg):
        rec = pkg.flight.FlightRecorder(capacity=8)
        rec.emit(pkg.flight.PAIR_CONNECT, 1)
        struct.pack_into("<QHHIqq", rec._buf, pkg.flight.RECORD_BYTES,
                         time.monotonic_ns(), 9999, 0, 0, 0, 0)
        return [e["event"] for e in rec.snapshot()]

    assert both(scenario) == ["pair-connect"]


def test_tag_interning_is_stable_and_bounded():
    def scenario(pkg):
        t1 = pkg.flight.tag_for("pair:twin-abc")
        t2 = pkg.flight.tag_for("pair:twin-abc")
        t3 = pkg.flight.tag_for("pair:twin-def")
        return (t1 == t2 != t3, pkg.flight.tag_name(t1),
                pkg.flight.tag_name(10 ** 6), pkg.flight.tag_name(0))

    assert both(scenario) == (True, "pair:twin-abc", "#1000000", "-")


def test_event_vocabulary_matches_reference():
    """The codes, names and flush reasons are the reference's: both
    packages' rings decode each other's records."""
    def scenario(pkg):
        return (dict(pkg.flight.EVENT_NAMES), pkg.flight.FLUSH_REASONS,
                pkg.flight.RECORD_BYTES, pkg.flight._default_capacity())

    assert both(scenario)[2] == 32


def test_dump_text_renders_every_event():
    def scenario(pkg):
        rec = pkg.flight.FlightRecorder(capacity=8)
        rec.emit(pkg.flight.WRITE_STALL_BEGIN,
                 pkg.flight.tag_for("pair:dump"), 42)
        text = rec.dump_text()
        empty = pkg.flight.FlightRecorder(capacity=8).dump_text()
        return ("write-stall-begin" in text and "pair:dump" in text
                and "a1=42" in text, empty)

    assert both(scenario) == (True, "flight recorder: no events\n")


def test_verify_hook_sees_every_event():
    def scenario(pkg):
        seen = []
        pkg.flight.set_verify_hook(lambda *ev: seen.append(ev))
        try:
            tag = pkg.flight.tag_for("twin:verify")
            pkg.flight.emit(pkg.flight.DRAIN_BEGIN, tag, 2)
            pkg.flight.emit(pkg.flight.DRAIN_END, tag, 0)
        finally:
            pkg.flight.set_verify_hook(None)
        return [(code, a1, a2) for code, t, a1, a2 in seen if t == tag]

    assert both(scenario) == [(24, 2, 0), (25, 0, 0)]


# ---------------------------------------------------------------------------
# the stall watchdog: attribution, trip side effects, clearing
# ---------------------------------------------------------------------------

def _fast_wd(pkg):
    wd = pkg.watchdog.get()
    wd.enabled = True
    wd.min_stall_s = 0.01
    wd.sweep_s = 0.05
    return wd


def test_watchdog_attributes_held_lease_as_credit_starvation():
    def scenario(pkg):
        wd = _fast_wd(pkg)
        tag = pkg.flight.tag_for("nclease")
        pkg.flight.emit(pkg.flight.LEASE_RESERVE, tag, 4096)
        tok = wd.call_started("/t/Lease")
        time.sleep(0.02)
        diags = wd.sweep_once()
        out = ([d["stage"] for d in diags],
               "send-lease held" in diags[0]["detail"],
               diags[0]["cause"]["evidence"][0][:2])
        wd.call_finished(tok)
        return out + (wd.sweep_once(),)

    assert both(scenario) == (["credit-starvation"], True,
                              ["flight", "lease-reserve-open"], [])


def test_watchdog_attributes_h2_flow_control():
    def scenario(pkg):
        wd = _fast_wd(pkg)
        pkg.flight.emit(pkg.flight.H2_WINDOW_EXHAUSTED,
                        pkg.flight.tag_for("h2srv:t"), 7)
        tok = wd.call_started("/t/H2")
        time.sleep(0.02)
        diags = wd.sweep_once()
        wd.call_finished(tok)
        return [(d["stage"], d["kind"], d["method"]) for d in diags]

    assert both(scenario) == [("h2-flow-control", "server", "/t/H2")]


@pytest.mark.parametrize("kind", ["server", "client"])
def test_watchdog_quiet_transport_names_device_infer(kind):
    def scenario(pkg):
        wd = _fast_wd(pkg)
        tok = wd.call_started("/t/Infer", kind=kind)
        time.sleep(0.02)
        diags = wd.sweep_once()
        snap = wd.snapshot()
        wd.call_finished(tok)
        return ([(d["stage"], d["detail"]) for d in diags],
                snap["inflight"], len(snap["history"]), wd.sweep_once())

    got = both(scenario)
    assert got[0][0][0] == "device-infer" and got[1:] == (1, 1, [])


def test_watchdog_trip_side_effects():
    def scenario(pkg):
        wd = _fast_wd(pkg)
        trips = pkg.metrics.counter("watchdog_trips")
        trips0 = trips.snapshot()
        tctx = pkg.tracing.maybe_sample()  # provisional: rate 0, tail on
        with pkg.tracing.use(tctx):
            with pkg.tracing.span("stuck-phase"):
                pass
        buffered = pkg.tracing.spans(tctx.trace_id)
        tok = wd.call_started("/t/Trip", tctx.trace_id)
        time.sleep(0.02)
        diags = wd.sweep_once()
        after_trip = trips.snapshot() - trips0
        promoted = [s["name"] for s in pkg.tracing.spans(tctx.trace_id)]
        wd.sweep_once()
        labeled = pkg.metrics.labeled_counter("watchdog_stalls", ("stage",))
        out = (tctx.provisional, buffered, len(diags), after_trip,
               "watchdog-trip" in _events(pkg, "/t/Trip"), promoted,
               trips.snapshot() - trips0,
               labeled.snapshot().get(("device-infer",), 0) >= 1,
               diags[0]["trace_id"] == f"{tctx.trace_id:016x}")
        wd.call_finished(tok)
        return out

    assert both(scenario) == (True, [], 1, 1, True, ["stuck-phase"], 1,
                              True, True)


def test_watchdog_respects_rolling_p99_bar():
    def scenario(pkg):
        wd = _fast_wd(pkg)
        wd.min_stall_s = 0.05
        wd.mult = 100.0
        for _ in range(16):
            t = wd.call_started("/t/Fast")
            time.sleep(0.001)
            wd.call_finished(t)
        bar = wd.slow_threshold_ns("/t/Fast")
        p99 = wd.rolling_p99_ns()
        tok = wd.call_started("/t/Fast")
        time.sleep(0.06)  # over min_stall, under the p99 multiple
        quiet = wd.sweep_once()
        wd.call_finished(tok)
        return (bar is not None and bar >= 100 * 1_000_000,
                p99 is not None and p99 >= 1_000_000, quiet,
                sorted(wd.method_p99s()))

    assert both(scenario) == (True, True, [], ["/t/Fast"])


def test_watchdog_needs_history_and_skips_failures():
    """A method's p99 exists after 8 successful calls; failed calls never
    tighten the bar; ``TPURPC_WATCHDOG=0`` registers nothing."""
    def scenario(pkg):
        wd = _fast_wd(pkg)
        for _ in range(7):
            wd.call_finished(wd.call_started("/t/Hist"))
        early = wd.slow_threshold_ns("/t/Hist")
        for _ in range(20):
            wd.call_finished(wd.call_started("/t/Hist"), error=True)
        still = wd.slow_threshold_ns("/t/Hist")
        wd.call_finished(wd.call_started("/t/Hist"))
        late = wd.slow_threshold_ns("/t/Hist") is not None
        wd.enabled = False
        off = wd.call_started("/t/Hist")
        return early, still, late, off

    assert both(scenario) == (None, None, True, None)


def test_watchdog_trip_hooks_and_external_trip():
    def scenario(pkg):
        wd = _fast_wd(pkg)
        seen = []

        def hook(diag):
            seen.append((diag["kind"], diag["stage"], diag["method"]))

        pkg.watchdog.add_trip_hook(hook)
        try:
            wd.external_trip("unknown", "/t/Ext", "a verifier said so")
            tok = wd.call_started("/t/Hooked")
            time.sleep(0.02)
            wd.sweep_once()
            wd.call_finished(tok)
        finally:
            pkg.watchdog.remove_trip_hook(hook)
        return seen, [h["kind"] for h in wd.snapshot()["history"]]

    assert both(scenario) == (
        [("external", "unknown", "/t/Ext"),
         ("server", "device-infer", "/t/Hooked")],
        ["external", "server"])


def test_watchdog_attributes_rendezvous_and_ctrl_ring():
    """Aged open rendezvous edges name ``rendezvous``; an aged ring-full
    bracket names ``ctrl-ring``."""
    def scenario(pkg):
        wd = _fast_wd(pkg)
        f = pkg.flight
        out = []
        tag = f.tag_for("twin:rdv")
        f.emit(f.RDV_OFFER, tag, 11, 4096)
        tok = wd.call_started("/t/Rdv")
        time.sleep(0.02)
        out.append([d["stage"] for d in wd.sweep_once()])
        wd.call_finished(tok)
        f.emit(f.RDV_RELEASE, tag, 0, 11)
        ctag = f.tag_for("twin:ctrl")
        f.emit(f.CTRL_STALL_BEGIN, ctag, 64)
        tok = wd.call_started("/t/Ctrl")
        time.sleep(0.02)
        out.append([d["stage"] for d in wd.sweep_once()])
        wd.call_finished(tok)
        f.emit(f.CTRL_STALL_END, ctag)
        return out

    assert both(scenario) == [["rendezvous"], ["ctrl-ring"]]


def test_watchdog_sweeper_thread_trips_on_its_own():
    """The sweeper thread (started by the first ``call_started``) trips a
    wedged call without a manual sweep."""
    def scenario(pkg):
        wd = _fast_wd(pkg)
        tag_name = "/t/Sweeper"
        tok = wd.call_started(tag_name)
        deadline = time.monotonic() + 10
        while (not wd.active() and time.monotonic() < deadline):
            time.sleep(0.01)
        stages = [d["stage"] for d in wd.active()]
        wd.call_finished(tok)
        return stages, "watchdog-trip" in _events(pkg, tag_name)

    assert both(scenario) == (["device-infer"], True)


def test_port_watchdog_stop_ends_the_sweeper():
    """The port's sweeper can be stopped (the reference's runs until exit);
    the next ``call_started`` starts a new one."""
    wd = PORT.watchdog.StallWatchdog(sweep_s=0.01)
    wd.enabled = True
    tok = wd.call_started("/t/Stop")
    t = wd._thread
    assert t is not None and t.is_alive()
    wd.stop()
    assert not t.is_alive() and wd._thread is None
    wd.call_finished(tok)
    wd.call_finished(wd.call_started("/t/Stop"))
    assert wd._thread is not None and wd._thread.is_alive()
    wd.stop()


# ---------------------------------------------------------------------------
# tail capture: promotion rules
# ---------------------------------------------------------------------------

def test_tail_slow_call_promotes_fast_call_drops():
    def scenario(pkg):
        t = pkg.tracing
        fast, slow = t.maybe_sample(), t.maybe_sample()
        for ctx in (fast, slow):
            with t.use(ctx):
                with t.span("work"):
                    pass
        kept = (t.tail_decide(fast, 1_000_000, method="/t/M"),
                t.tail_decide(slow, 10 ** 12, method="/t/M"))
        names = ([s["name"] for s in t.spans(fast.trace_id)],
                 [s["name"] for s in t.spans(slow.trace_id)])
        t.record("late", slow, 1, 2)
        return kept, names, len(t.spans(slow.trace_id))

    assert both(scenario) == ((False, True), ([], ["work"]), 2)


def test_tail_error_promotes():
    def scenario(pkg):
        t = pkg.tracing
        ctx = t.maybe_sample()
        with t.use(ctx):
            with t.span("failing"):
                pass
        return (t.tail_decide(ctx, 1_000, error=True),
                [s["name"] for s in t.spans(ctx.trace_id)],
                t.tail_decide(ctx, 1_000),  # committed already
                t.tail_decide(None, 10 ** 12))

    assert both(scenario) == (True, ["failing"], True, False)


def test_tail_p99_multiple_tightens_static_bar():
    def scenario(pkg):
        wd = _fast_wd(pkg)
        wd.mult = 2.0
        for _ in range(16):
            wd.call_finished(wd.call_started("/t/Tight"))
        ctx = pkg.tracing.maybe_sample()
        with pkg.tracing.use(ctx):
            with pkg.tracing.span("outlier"):
                pass
        return pkg.tracing.tail_decide(ctx, 5_000_000, method="/t/Tight")

    assert both(scenario) is True


def test_tail_static_bar_env(monkeypatch):
    """``TPURPC_TRACE_TAIL_MS`` sets the static slow bar (re-read by
    ``configure``)."""
    def scenario(pkg):
        monkeypatch.setenv("TPURPC_TRACE_TAIL_MS", "5")
        pkg.tracing.configure(0.0)
        try:
            ctx = pkg.tracing.maybe_sample()
            return (pkg.tracing.tail_decide(ctx, 6_000_000),
                    pkg.tracing._TAIL_STATIC_NS)
        finally:
            monkeypatch.delenv("TPURPC_TRACE_TAIL_MS")
            pkg.tracing.configure(0.0)

    assert both(scenario) == (True, 5_000_000)


def test_tail_pending_is_bounded():
    def scenario(pkg):
        t = pkg.tracing
        first = t.maybe_sample()
        for _ in range(t._PENDING_TRACES + 10):
            ctx = t.maybe_sample()
            with t.use(ctx):
                t.record("s", ctx, 1, 1)
        bounded = t.tail_pending() <= t._PENDING_TRACES
        t.tail_commit(first.trace_id)
        return bounded, t.spans(first.trace_id)

    assert both(scenario) == (True, [])


def test_wire_context_adopt_registers_provisional():
    def scenario(pkg):
        t = pkg.tracing
        ctx = t.TraceContext(0xABC, 1, provisional=True)
        got = t.adopt(ctx.encode())
        with t.use(got):
            with t.span("server-side"):
                pass
        buffered = t.spans(0xABC)
        t.tail_commit(0xABC)
        return (ctx.encode()[-2:], got.provisional, got.sampled, buffered,
                [s["name"] for s in t.spans(0xABC)],
                t.adopt(t.TraceContext(1, 2, True).encode()).provisional)

    assert both(scenario) == ("-2", True, True, [], ["server-side"], False)


# ---------------------------------------------------------------------------
# end to end: RED counters, the pipelined deadline, tail capture
# ---------------------------------------------------------------------------

def _echo_server(pkg, hold=None):
    server = pkg.server
    status = pkg.status
    srv = server.Server(max_workers=4)

    def echo(req, ctx):
        if hold is not None:
            hold.wait(5)
        return bytes(req)

    def boom(req, ctx):
        ctx.abort(status.StatusCode.INVALID_ARGUMENT, "nope")

    srv.add_method("/f.S/Echo", server.unary_unary_rpc_method_handler(echo))
    srv.add_method("/f.S/Boom", server.unary_unary_rpc_method_handler(boom))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _channel(pkg, port):
    channel = pkg.channel
    return channel.Channel(f"127.0.0.1:{port}")


def _unary(pkg, ch, path):
    return ch.unary_unary(path, tpurpc_native=False)


def test_red_counters_per_method_per_code():
    def scenario(pkg):
        status = pkg.status
        srv, port = _echo_server(pkg)
        fam = pkg.metrics.labeled_counter("srv_calls", ("method", "code"))
        lat = pkg.metrics.histogram("srv_call_us", kind="latency")
        before = fam.snapshot()
        n0 = lat.snapshot()["count"]
        try:
            with _channel(pkg, port) as ch:
                mc = _unary(pkg, ch, "/f.S/Echo")
                ok = [mc(b"ok", timeout=20) for _ in range(3)]
                try:
                    _unary(pkg, ch, "/f.S/Boom")(b"x", timeout=20)
                    bad = None
                except status.RpcError as exc:
                    bad = exc.code().name
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                snap = fam.snapshot()
                if (snap.get(("/f.S/Echo", "0"), 0)
                        - before.get(("/f.S/Echo", "0"), 0) >= 3
                        and snap.get(("/f.S/Boom", "3"), 0)
                        - before.get(("/f.S/Boom", "3"), 0) >= 1):
                    break
                time.sleep(0.02)
        finally:
            srv.stop(grace=0)
        snap = fam.snapshot()
        return (ok, bad,
                snap.get(("/f.S/Echo", "0"), 0)
                - before.get(("/f.S/Echo", "0"), 0),
                snap.get(("/f.S/Boom", "3"), 0)
                - before.get(("/f.S/Boom", "3"), 0),
                lat.snapshot()["count"] - n0)

    assert both(scenario) == ([b"ok"] * 3, "INVALID_ARGUMENT", 3, 1, 4)


def test_pipelined_deadline_expiry_counter_and_flight_event():
    def scenario(pkg):
        status = pkg.status
        hold = threading.Event()
        srv, port = _echo_server(pkg, hold=hold)
        fam = pkg.metrics.labeled_counter("deadline_exceeded", ("method",))
        before = fam.snapshot().get(("/f.S/Echo",), 0)
        t_ns = time.monotonic_ns()
        try:
            with _channel(pkg, port) as ch:
                pl = ch.unary_unary("/f.S/Echo").pipeline(depth=2)
                fut = pl.call_async(b"wedge", timeout=0.2)
                try:
                    fut.result(20)
                    code = "OK"
                except status.RpcError as exc:
                    code = exc.code().name
                pl.close()
            hold.set()
        finally:
            hold.set()
            srv.stop(grace=0)
        expired = [e for e in pkg.flight.snapshot(since_ns=t_ns)
                   if e["event"] == "deadline-expired"
                   and e["entity"].startswith("conn:")]
        return code, fam.snapshot().get(("/f.S/Echo",), 0) - before, \
            len(expired)

    assert both(scenario) == ("DEADLINE_EXCEEDED", 1, 1)


def test_connection_lifecycle_flight_events():
    """A channel's connection leaves conn-connect, call-first-ok (once) and
    conn-dead under its ``conn:<peer>`` tag."""
    def scenario(pkg):
        srv, port = _echo_server(pkg)
        t_ns = time.monotonic_ns()
        try:
            with _channel(pkg, port) as ch:
                mc = _unary(pkg, ch, "/f.S/Echo")
                for _ in range(3):
                    mc(b"x", timeout=20)
        finally:
            srv.stop(grace=0)
        return [e["event"] for e in pkg.flight.snapshot(since_ns=t_ns)
                if e["entity"].startswith("conn:")
                and e["event"] in ("conn-connect", "call-first-ok",
                                   "conn-dead")]

    assert both(scenario) == ["conn-connect", "call-first-ok", "conn-dead"]


def test_admission_reject_flight_event_and_counter():
    def scenario(pkg):
        server = pkg.server
        status = pkg.status
        hold = threading.Event()
        entered = threading.Event()

        def slow(req, ctx):
            entered.set()
            hold.wait(10)
            return b"ok"

        gate = server.AdmissionGate(1, soft_limit=1)
        srv = server.Server(max_workers=4, admission=gate)
        srv.add_method("/f.S/Slow", server.unary_unary_rpc_method_handler(
            slow))
        port = srv.add_insecure_port("127.0.0.1:0")
        srv.start()
        shed = pkg.metrics.counter("srv_admission_rejected")
        s0 = shed.snapshot()
        t_ns = time.monotonic_ns()
        try:
            with _channel(pkg, port) as ch:
                mc = _unary(pkg, ch, "/f.S/Slow")
                fut = mc.future(b"", timeout=20)
                assert entered.wait(10)
                try:
                    mc(b"", timeout=20)
                    code = "OK"
                except status.RpcError as exc:
                    code = exc.code().name
                hold.set()
                first = bytes(fut.result(timeout=20))
        finally:
            hold.set()
            srv.stop(grace=0)
        rejects = [(e["a1"], e["a2"]) for e in
                   pkg.flight.snapshot(since_ns=t_ns)
                   if e["event"] == "admit-reject"]
        return code, first, shed.snapshot() - s0, rejects

    assert both(scenario) == ("UNAVAILABLE", b"ok", 1, [(1, 25)])


def test_tail_capture_end_to_end_sample_zero():
    """A sample rate of 0: a slow call yields a committed span tree
    (client-send, wire, dispatch, respond); a fast call leaves the main
    ring untouched."""
    def scenario(pkg):
        hold = threading.Event()
        srv, port = _echo_server(pkg, hold=hold)
        try:
            gates = (pkg.tracing.ACTIVE, pkg.tracing.LIVE)
            hold.set()
            with _channel(pkg, port) as ch:
                mc = _unary(pkg, ch, "/f.S/Echo")
                fast = mc(b"fast", timeout=20)
                fast_spans = len(pkg.tracing.spans())
                hold.clear()
                threading.Timer(0.45, hold.set).start()  # > the 250 ms bar
                slow = mc(b"slow", timeout=30)
            names = set()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                names = {s["name"] for s in pkg.tracing.spans()}
                if {"client-send", "wire", "dispatch", "respond"} <= names:
                    break
                time.sleep(0.05)
        finally:
            hold.set()
            srv.stop(grace=0)
        return gates, bytes(fast), fast_spans, bytes(slow), sorted(names)

    assert both(scenario) == ((False, True), b"fast", 0, b"slow",
                              ["client-send", "dispatch", "respond", "wire"])
