"""History, alerting, the fleet collector and evidence capture on both
packages: the twins of ``tests/test_argus.py``.

Every case runs on the reference and on the port (``pkg``), on the same
inputs, with the reference test's own windows, synthetic clocks and
bounds: the two-tier ring tsdb (bounds, decimation, rate and quantile
queries, reset-aware deltas), the SLO evaluator (burn math,
pending→firing→resolved, shed against error budgets, the watchdog bridge),
the structured ``/healthz?json=1`` reasons, the bundle writer (content,
rate limit, caps, the watchdog hook, the renderer), the fleet collector
(member labels, staleness, the reset clamp, the merged SLO view, its HTTP
face), the shard merge's reset clamp, and detect→capture end to end.
Flight streams and bundles of both packages are checked with the
reference's protocol checker (``tpurpc.analysis.protocol``; the port's
copy is ROADMAP A12): the event names and codes are the same.

Every plane here is process-wide: each case resets both packages' flight
rings and watchdogs (``clean_obs``), and afterwards stops and forgets both
SLO evaluators and disarms both bundle writers. Environment variables
change only through ``monkeypatch``.
"""

import json
import os
import threading
import time
import types

import pytest

from torch_call_plane import BOTH, REF
from torch_obs import clean_obs, method, mod, server  # noqa: F401

from tpurpc.analysis import protocol

S = int(1e9)  # one second of synthetic monotonic nanoseconds


def planes(pkg):
    """``pkg``'s observability modules under one namespace."""
    return types.SimpleNamespace(
        pkg=pkg, flight=pkg.flight, metrics=pkg.metrics,
        watchdog=pkg.watchdog, tsdb=mod(pkg, "obs.tsdb"),
        slo=mod(pkg, "obs.slo"), scrape=mod(pkg, "obs.scrape"),
        bundle=mod(pkg, "obs.bundle"), collector=mod(pkg, "obs.collector"),
        shard=mod(pkg, "obs.shard"), tools_bundle=mod(pkg, "tools.bundle"),
        channel=pkg.channel, server=pkg.server)


@pytest.fixture(params=BOTH, ids=lambda p: p.name)
def o(request):
    return planes(request.param)


@pytest.fixture(autouse=True)
def _argus_state(clean_obs):  # noqa: F811
    yield
    for pkg in BOTH:
        p = planes(pkg)
        p.slo.reset()
        p.bundle.disable()


def _private_db(o, **kw):
    reg = o.metrics.Registry()
    kw.setdefault("fine_s", 1.0)
    kw.setdefault("fine_window_s", 16.0)
    kw.setdefault("coarse_s", 4.0)
    kw.setdefault("coarse_window_s", 64.0)
    return o.tsdb.Tsdb(registry=reg, **kw)


def _fresh_tsdb(o) -> None:
    """Stop the process-wide sampler, if any, and forget its store."""
    inst = o.tsdb._instance
    if inst is not None:
        inst.stop()
    o.tsdb.postfork_reset()


# ---------------------------------------------------------------------------
# ResetClamp
# ---------------------------------------------------------------------------

def test_reset_clamp_monotone_across_restarts(o):
    c = o.tsdb.ResetClamp()
    assert c.clamp("k", 10) == 10
    assert c.clamp("k", 25) == 25
    # restart: raw drops to 3 -> continue from last-known (25) + 3
    assert c.clamp("k", 3) == 28
    assert c.resets == 1
    assert c.clamp("k", 7) == 32
    assert c.clamp("k", 1) == 33
    assert c.resets == 2


def test_reset_clamp_forget_by_prefix(o):
    c = o.tsdb.ResetClamp()
    c.clamp(("m1", "x"), 10)
    c.clamp(("m1", "x"), 2)
    c.clamp(("m2", "y"), 5)
    assert c.clamp(("m1", "x"), 4) == 14
    c.forget("m1")
    assert c.clamp(("m1", "x"), 4) == 4
    assert c.clamp(("m2", "y"), 6) == 6


# ---------------------------------------------------------------------------
# tsdb: rings, tiers, queries
# ---------------------------------------------------------------------------

def test_tsdb_window_and_ring_bound(o):
    db = _private_db(o)
    ctr = db._registry.counter("reqs")
    for i in range(40):  # 40 samples > 16 fine slots: the ring wraps
        ctr.inc(5)
        db.sample_once(now_ns=(i + 1) * S)
    pts = db.window("reqs", 100.0, now_ns=40 * S)
    fine_pts = db.window("reqs", 10.0, now_ns=40 * S)
    assert len(fine_pts) <= db._fine.slots
    assert fine_pts[-1][1] == 200.0
    assert pts[0][0] < fine_pts[0][0]  # coarse reaches further back
    assert db._fine.n == 40


def test_tsdb_rate_and_counter_reset(o):
    db = _private_db(o)
    ctr = db._registry.counter("reqs")
    for i in range(10):
        ctr.inc(10)
        db.sample_once(now_ns=(i + 1) * S)
    assert db.rate("reqs", 9.0, now_ns=10 * S) == pytest.approx(10.0)
    ctr.reset()
    ctr.inc(3)
    db.sample_once(now_ns=11 * S)
    assert db.rate("reqs", 10.0, now_ns=11 * S) > 0
    assert db.delta("reqs", 2.0, now_ns=11 * S) == pytest.approx(13.0)


def test_tsdb_two_tier_decimation(o):
    db = _private_db(o)  # fine 1 s, coarse 4 s: decimation 4
    g = db._registry.gauge("load")
    for i in range(12):
        g.set(i)
        db.sample_once(now_ns=(i + 1) * S)
    assert db._coarse.n == 3
    assert [v for _t, v in db._coarse.points("load", 0)] == [0.0, 4.0, 8.0]


def test_tsdb_quantile_and_threshold_fraction(o):
    db = _private_db(o)
    g = db._registry.gauge("p99_us")
    for i, v in enumerate([10, 10, 10, 10, 10, 10, 10, 10, 90, 90]):
        g.set(v)
        db.sample_once(now_ns=(i + 1) * S)
    assert db.quantile_over_time("p99_us", 0.5, 12.0,
                                 now_ns=10 * S) == 10.0
    assert db.over_threshold_fraction(
        "p99_us", 50.0, 12.0, now_ns=10 * S) == pytest.approx(0.2)
    assert db.over_threshold_fraction("nope", 1.0, 12.0,
                                      now_ns=10 * S) is None


def test_tsdb_histogram_and_labeled_series(o):
    db = _private_db(o)
    h = db._registry.histogram("lat_us", kind="latency")
    fam = db._registry.labeled_counter("calls", ("method", "code"))
    h.record(1000)
    h.record(2000)
    fam.labels("/m/A", "0").inc(5)
    fam.labels("/m/A", "14").inc(1)
    db.sample_once(now_ns=S)
    kinds = db.series()
    assert kinds["lat_us:p99"] == "quantile"
    assert kinds["lat_us:count"] == "counter"
    assert kinds["calls{/m/A,0}"] == "counter"
    assert db.window("calls{/m/A,14}", 5.0, now_ns=S)[-1][1] == 1.0


def test_tsdb_series_cap_bounds_memory(o, monkeypatch):
    monkeypatch.setattr(o.tsdb, "MAX_SERIES", 4)
    db = _private_db(o)
    for i in range(10):
        db._registry.counter(f"c{i}")
    db.sample_once(now_ns=S)
    assert len(db.series()) == 4
    before = db.resident_bytes()
    for i in range(10, 20):
        db._registry.counter(f"c{i}")
    db.sample_once(now_ns=2 * S)
    assert db.resident_bytes() == before


def test_tsdb_doc_and_resident_bytes(o):
    db = _private_db(o)
    db._registry.counter("reqs").inc(7)
    db.sample_once()  # the real clock: doc() windows against now
    doc = db.doc()
    assert "reqs" in doc["series"]
    assert doc["resident_bytes"] > 0
    one = db.doc(series="reqs", window_s=10.0)
    assert one["points"][-1][1] == 7.0
    assert one["kind"] == "counter"


def test_tsdb_postfork_reset_gives_fresh_instance(o):
    a = o.tsdb.get()
    o.tsdb.postfork_reset()
    b = o.tsdb.get()
    assert a is not b
    a.stop()   # the forgotten store's sampler, if a server started it


def test_debug_history_route(o):
    status, _ctype, body = o.scrape._route("/debug/history?local=1")
    assert status == 200
    doc = json.loads(body)
    assert doc["enabled"] is True
    assert "fine" in doc and "coarse" in doc


# ---------------------------------------------------------------------------
# slo: burn math and the alert state machine (private tsdb, synthetic clock)
# ---------------------------------------------------------------------------

def _latency_rig(o, threshold_ms=5.0, windows=((4.0, 8.0, 2.0),)):
    db = _private_db(o, fine_s=1.0, fine_window_s=32.0,
                     coarse_s=8.0, coarse_window_s=64.0)
    g = db._registry.gauge("p99g")
    ev = o.slo.SloEvaluator(eval_s=1.0, tsdb=db)
    obj = ev.declare(o.slo.SloObjective(
        "lat", latency_ms=threshold_ms, latency_target_pct=50.0,
        series="p99g", windows=[tuple(w) for w in windows]))
    return db, g, ev, obj


def _drive(db, ev, g, t, value):
    g.set(value)
    db.sample_once(now_ns=t * S)
    ev.evaluate_once(now_ns=t * S)


def test_slo_pending_firing_resolved_with_flight_events(o):
    db, g, ev, obj = _latency_rig(o)
    st = obj.tracks["latency"]
    for i in range(10):
        _drive(db, ev, g, i + 1, 1000.0)
    assert st.state == "ok"
    t = 10
    while st.state == "ok" and t < 30:
        t += 1
        _drive(db, ev, g, t, 50_000.0)
    assert st.state == "pending"
    while st.state == "pending" and t < 40:
        t += 1
        _drive(db, ev, g, t, 50_000.0)
    assert st.state == "firing"
    fired_at = t
    while st.state == "firing" and t < fired_at + 30:
        t += 1
        _drive(db, ev, g, t, 1000.0)
    assert st.state == "ok"
    transitions = [(h["from"], h["to"]) for h in ev.doc()["history"]
                   if h["objective"] == "lat"]
    assert ("ok", "pending") in transitions
    assert ("pending", "firing") in transitions
    assert ("firing", "ok") in transitions
    names = [e["event"] for e in o.flight.snapshot()
             if e["entity"] == "slo:lat"]
    assert names.index("slo-firing") < names.index("slo-resolved")
    assert protocol.check_events(o.flight.snapshot(), strict=False) == []


def test_slo_blip_does_not_fire(o):
    db, g, ev, obj = _latency_rig(o)
    st = obj.tracks["latency"]
    for i in range(20):
        _drive(db, ev, g, i + 1, 50_000.0 if i % 10 == 0 else 1000.0)
        assert st.state != "firing"
    assert st.fired == 0


def test_slo_availability_errors_and_sheds_burn_separate_budgets(o):
    db = _private_db(o, fine_s=1.0, fine_window_s=32.0)
    fam = db._registry.labeled_counter("srv_calls", ("method", "code"))
    shed = db._registry.counter("srv_admission_rejected")
    ev = o.slo.SloEvaluator(eval_s=1.0, tsdb=db)
    obj = ev.declare(o.slo.SloObjective(
        "avail", method="/m/A", target_pct=99.0, shed_target_pct=80.0,
        windows=[(4.0, 8.0, 2.0)]))
    ok = fam.labels("/m/A", "0")
    bad = fam.labels("/m/A", "14")
    for i in range(12):
        ok.inc(10)
        shed.inc(10)
        db.sample_once(now_ns=(i + 1) * S)
        ev.evaluate_once(now_ns=(i + 1) * S)
    assert obj.tracks["errors"].state == "ok"
    assert obj.tracks["sheds"].state == "firing"
    obj2 = ev.declare(o.slo.SloObjective(
        "avail2", method="/m/A", target_pct=99.0,
        windows=[(4.0, 8.0, 2.0)]))
    for i in range(12, 26):
        ok.inc(9)
        bad.inc(1)
        db.sample_once(now_ns=(i + 1) * S)
        ev.evaluate_once(now_ns=(i + 1) * S)
    assert obj2.tracks["errors"].state == "firing"


def test_slo_method_scoping(o):
    db = _private_db(o, fine_s=1.0, fine_window_s=32.0)
    fam = db._registry.labeled_counter("srv_calls", ("method", "code"))
    ev = o.slo.SloEvaluator(eval_s=1.0, tsdb=db)
    obj = ev.declare(o.slo.SloObjective(
        "a-only", method="/m/A", target_pct=99.0,
        windows=[(4.0, 8.0, 2.0)]))
    for i in range(12):
        fam.labels("/m/A", "0").inc(10)
        fam.labels("/m/B", "14").inc(10)
        db.sample_once(now_ns=(i + 1) * S)
        ev.evaluate_once(now_ns=(i + 1) * S)
    assert obj.tracks["errors"].state == "ok"


def test_slo_firing_bridges_watchdog_and_healthz(o, monkeypatch):
    wd = o.watchdog.get()
    db = _private_db(o, fine_s=1.0, fine_window_s=32.0)
    g = db._registry.gauge("p99g")
    ev = o.slo.SloEvaluator(eval_s=1.0, tsdb=db)
    monkeypatch.setattr(o.slo, "_instance", ev)
    obj = ev.declare(o.slo.SloObjective(
        "page-me", latency_ms=5.0, latency_target_pct=50.0,
        series="p99g", windows=[(2.0, 4.0, 2.0)]))
    for i in range(10):
        _drive(db, ev, g, i + 1, 50_000.0)
    assert obj.tracks["latency"].state == "firing"
    assert any(h.get("stage") == "slo" and h.get("method") == "page-me"
               for h in wd.snapshot()["history"])
    status, _ctype, body = o.scrape._route("/healthz")
    assert status == 503 and b"slo" in body.lower()
    status, _ctype, body = o.scrape._route("/healthz?json=1")
    doc = json.loads(body)
    assert doc["status"] == "degraded"
    assert "slo-firing" in [r["reason"] for r in doc["degraded_reasons"]]
    status, _ctype, body = o.scrape._route("/debug/slo?local=1")
    sdoc = json.loads(body)
    assert sdoc["firing"] and sdoc["firing"][0]["objective"] == "page-me"
    for i in range(10, 25):
        _drive(db, ev, g, i + 1, 100.0)
    assert obj.tracks["latency"].state == "ok"
    status, _ctype, body = o.scrape._route("/healthz?json=1")
    doc = json.loads(body)
    assert doc["status"] == "ok" and doc["degraded_reasons"] == []


# ---------------------------------------------------------------------------
# /healthz?json=1: every subsystem's reason appears and clears
# ---------------------------------------------------------------------------

def _health_reasons(o):
    status, _ctype, body = o.scrape._route("/healthz?json=1")
    doc = json.loads(body)
    return status, [r["reason"] for r in doc["degraded_reasons"]], doc


def test_healthz_json_watchdog_reason_appears_and_clears(o):
    wd = o.watchdog.get()
    wd.enabled = True
    wd.min_stall_s = 0.01
    tok = wd.call_started("/argus/Wedge")
    time.sleep(0.05)
    wd.sweep_once()
    status, reasons, _doc = _health_reasons(o)
    assert status == 503 and "watchdog-stall" in reasons
    status, _ctype, body = o.scrape._route("/healthz")
    worst = wd.active()[0]
    expect = (f"degraded: {len(wd.active())} stalled call(s); "
              f"{worst['method']} blocked on {worst['stage']} "
              f"for {worst['age_s']}s\n").encode()
    assert status == 503 and body == expect
    wd.call_finished(tok)
    wd.sweep_once()
    status, reasons, _doc = _health_reasons(o)
    assert status == 200 and "watchdog-stall" not in reasons


def test_healthz_json_draining_reason_appears_and_clears(o):
    srv, _port = server(o.pkg, {}, max_workers=2)
    try:
        _status, reasons, _doc = _health_reasons(o)
        assert "draining" not in reasons
        t = threading.Thread(target=srv.drain, args=(0.5,), daemon=True)
        t.start()
        deadline = time.monotonic() + 2.0
        seen = False
        while time.monotonic() < deadline:
            status, reasons, doc = _health_reasons(o)
            if "draining" in reasons:
                seen = True
                assert status == 200 and doc["status"] == "draining"
                break
        assert seen, "draining reason never appeared"
        t.join(timeout=5)
    finally:
        srv.stop(grace=0)
    _status, reasons, _doc = _health_reasons(o)
    assert "draining" not in reasons


class _FakeSched:
    name = "gen0"
    _closed = False
    steps = 1
    shed_total = 2
    preempted_total = 0

    def state_str(self):
        return "shedding"

    def running_depth(self):
        return 1

    def queue_depth(self):
        return 9

    def swapped_depth(self):
        return 0


class _FakeKv:
    name = "arena0"

    def stats(self):
        return {"used": 1, "blocks": 4, "free": 3, "swapped_blocks": 2,
                "quarantined": 1, "prefix_hits": 0}


def test_healthz_json_shedding_and_kv_reasons(o):
    """Each package's live decode scheduler and KV arena (the modules' own
    ``health_lines``, behind the scrape plane's ``sys.modules`` gates) add
    the ``shedding`` and ``kv-pressure`` reasons and their body lines, and
    both clear."""
    import sys

    fake_s = _FakeSched()
    sched_mod = mod(o.pkg, "serving.scheduler")
    kv_mod = mod(o.pkg, "serving.kv")
    fake_k = _FakeKv()
    sched_mod._LIVE.add(fake_s)
    kv_mod._LIVE.add(fake_k)
    try:
        status, reasons, doc = _health_reasons(o)
        assert "shedding" in reasons and "kv-pressure" in reasons
        assert status == 200
        assert any(ln.startswith("gen gen0:") for ln in doc["lines"])
        assert any(ln.startswith("kv arena0:") for ln in doc["lines"])
    finally:
        sched_mod._LIVE.discard(fake_s)
        kv_mod._LIVE.discard(fake_k)
    _status, reasons, _doc = _health_reasons(o)
    assert "shedding" not in reasons and "kv-pressure" not in reasons
    assert sys.modules.get(kv_mod.__name__) is kv_mod


# ---------------------------------------------------------------------------
# bundle: content, protocol conformance, rate limit, caps
# ---------------------------------------------------------------------------

def test_bundle_contents_and_protocol_conformance(o, tmp_path):
    tag = o.flight.tag_for("pair:test")
    o.flight.emit(o.flight.RDV_OFFER, tag, 7, 4096)
    o.flight.emit(o.flight.RDV_CLAIM, tag, 7, 99)
    o.flight.emit(o.flight.RDV_COMPLETE, tag, 99, 4096)
    w = o.bundle.BundleWriter(str(tmp_path), min_interval_s=0.0)
    path = w.capture("manual", detail="unit test")
    assert path is not None and os.path.isdir(path)
    names = sorted(os.listdir(path))
    pid = os.getpid()
    assert f"flight-{pid}.json" in names
    assert {"meta.json", "traces.json", "history.json",
            "slo.json", "stalls.json"} <= set(names)
    with open(os.path.join(path, f"flight-{pid}.json")) as f:
        events = json.load(f)
    assert isinstance(events, list) and len(events) >= 3
    total, violations = protocol.check_dump(path)
    assert violations == [] and total >= 3
    assert any(e["event"] == "bundle-written" for e in o.flight.snapshot())


def test_bundle_rate_limit_one_per_interval(o, tmp_path):
    w = o.bundle.BundleWriter(str(tmp_path), min_interval_s=60.0)
    assert w.capture("slo", key="slo:lat") is not None
    assert w.capture("slo", key="slo:lat") is None
    assert w.capture("watchdog", key="wd:other") is None
    assert len(o.bundle.list_bundles(str(tmp_path))) == 1


def test_bundle_caps_delete_oldest(o, tmp_path):
    w = o.bundle.BundleWriter(str(tmp_path), max_bundles=2,
                              min_interval_s=0.0)
    paths = [w.capture("manual", key=f"k{i}") for i in range(4)]
    assert all(p is not None for p in paths)
    left = o.bundle.list_bundles(str(tmp_path))
    assert len(left) == 2
    assert os.path.basename(paths[-1]) in left


def test_bundle_armed_by_watchdog_trip(o, tmp_path):
    o.bundle.enable(str(tmp_path), min_interval_s=0.0)
    wd = o.watchdog.get()
    wd.enabled = True
    wd.external_trip("slo", "lat-objective", "unit-test page")
    bundles = o.bundle.list_bundles(str(tmp_path))
    assert len(bundles) == 1 and "-slo-" in bundles[0]
    wd.external_trip("rendezvous", "other", "different stage")
    assert len(o.bundle.list_bundles(str(tmp_path))) == 2


def test_bundle_renderer_cli(o, tmp_path, capsys):
    w = o.bundle.BundleWriter(str(tmp_path), min_interval_s=0.0)
    o.flight.emit(o.flight.PAIR_CONNECT, 0, 1)
    w.capture("manual", detail="render me")
    assert o.tools_bundle.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "render me" in out and "flight" in out


# ---------------------------------------------------------------------------
# collector: labels, staleness, reset clamp, merged slo, HTTP face
# ---------------------------------------------------------------------------

def _fake_member(col, target, text, slo=None):
    m = col._members[target]
    m.metrics_text = text
    m.slo = slo
    m.misses = 0
    m.polls += 1
    m.last_ok_mono = time.monotonic()
    return m


def test_collector_member_labels_and_census(o):
    col = o.collector.FleetCollector(["h1:1", "h2:2"], poll_s=0.1)
    _fake_member(col, "h1:1", "# TYPE tpurpc_x counter\ntpurpc_x 5\n")
    _fake_member(col, "h2:2",
                 "# TYPE tpurpc_x counter\ntpurpc_x{a=\"b\"} 7\n")
    text = col.merged_metrics()
    assert 'tpurpc_x{member="h1:1"} 5' in text
    assert 'tpurpc_x{member="h2:2",a="b"} 7' in text
    assert 'tpurpc_member_up{member="h1:1"} 1' in text


def test_collector_stale_member_series_vanish(o):
    col = o.collector.FleetCollector(["up:1", "dead:2"], poll_s=0.1,
                                     stale_after=2)
    _fake_member(col, "up:1", "# TYPE tpurpc_x counter\ntpurpc_x 5\n")
    m = _fake_member(col, "dead:2", "# TYPE tpurpc_x counter\ntpurpc_x 9\n")
    assert 'tpurpc_x{member="dead:2"} 9' in col.merged_metrics()
    m.misses = 3
    text = col.merged_metrics()
    assert 'member="dead:2"} 9' not in text
    assert 'tpurpc_member_up{member="dead:2"} 0' in text
    assert 'tpurpc_member_stale{member="dead:2"} 1' in text
    census = {c["member"]: c["state"] for c in col.census()}
    assert census == {"up:1": "up", "dead:2": "stale"}


def test_collector_counter_reset_clamped(o):
    col = o.collector.FleetCollector(["m:1"], poll_s=0.1)
    _fake_member(col, "m:1", "# TYPE tpurpc_c counter\ntpurpc_c 100\n")
    assert 'tpurpc_c{member="m:1"} 100' in col.merged_metrics()
    _fake_member(col, "m:1", "# TYPE tpurpc_c counter\ntpurpc_c 4\n")
    t2 = col.merged_metrics()
    assert 'tpurpc_c{member="m:1"} 104' in t2
    assert "tpurpc_collector_counter_resets 1" in t2
    _fake_member(col, "m:1", "# TYPE tpurpc_g gauge\ntpurpc_g 2\n")
    assert 'tpurpc_g{member="m:1"} 2' in col.merged_metrics()


def test_collector_merged_slo_alerts_carry_member(o):
    col = o.collector.FleetCollector(["a:1", "b:2"], poll_s=0.1)
    _fake_member(col, "a:1", "", slo={
        "firing": [{"objective": "lat", "track": "latency",
                    "burn_fast": 3.0}],
        "objectives": []})
    _fake_member(col, "b:2", "", slo={"firing": [], "objectives": []})
    doc = col.merged_slo()
    assert doc["firing"] == 1
    assert doc["alerts"][0]["member"] == "a:1"
    assert doc["members"]["b:2"]["state"] == "up"


def test_collector_live_http_end_to_end(o):
    import urllib.request

    srv, port = server(o.pkg, {}, max_workers=2)
    col = o.collector.FleetCollector([f"127.0.0.1:{port}"], poll_s=0.2)
    try:
        col.poll_once()
        assert col.census()[0]["state"] == "up"
        assert f'member="127.0.0.1:{port}"' in col.merged_metrics()
        cport = col.serve(port=0)
        raw = urllib.request.urlopen(
            f"http://127.0.0.1:{cport}/fleet/metrics", timeout=5).read()
        assert b"tpurpc_member_up" in raw
        raw = urllib.request.urlopen(
            f"http://127.0.0.1:{cport}/fleet/slo", timeout=5).read()
        assert b"members" in raw
        srv.stop(grace=0)
        for _ in range(col.stale_after + 1):
            col.poll_once()
        text = col.merged_metrics()
        assert f'tpurpc_member_up{{member="127.0.0.1:{port}"}} 0' in text
        assert f'tpurpc_ring_msgs_read{{member="127.0.0.1:{port}"' \
            not in text
    finally:
        col.stop()
        srv.stop(grace=0)


# ---------------------------------------------------------------------------
# shard merge: counter-reset hardening
# ---------------------------------------------------------------------------

def test_shard_merge_clamps_restarted_worker(o, monkeypatch):
    monkeypatch.setattr(o.shard, "_CLAMP", None)  # a fresh clamp
    bodies = {"scrape": 0}

    def fake_each(path):
        # shard 0 healthy both scrapes; shard 1 restarted in between
        if path.startswith("/metrics"):
            v1 = "120" if bodies["scrape"] == 0 else "3"
            yield 0, 200, b"# TYPE tpurpc_c counter\ntpurpc_c 50\n"
            yield 1, 200, (f"# TYPE tpurpc_c counter\ntpurpc_c {v1}\n"
                           ).encode()
        else:
            wf1 = {"hops": [{"hop": "wire",
                             "bytes": 1000 if bodies["scrape"] == 0 else 40,
                             "busy_ms": 1.0, "copy_bytes": 0,
                             "what": "w"}]}
            yield 0, 200, json.dumps(
                {"hops": [{"hop": "wire", "bytes": 500, "busy_ms": 1.0,
                           "copy_bytes": 0, "what": "w"}]}).encode()
            yield 1, 200, json.dumps(wf1).encode()

    monkeypatch.setattr(o.shard, "_each_shard", fake_each)
    assert 'tpurpc_c{shard="1"} 120' in o.shard.aggregate_metrics()
    wf_before = o.shard.aggregate_waterfall()
    assert wf_before["hops"][0]["bytes"] == 1500
    bodies["scrape"] = 1
    assert 'tpurpc_c{shard="1"} 123' in o.shard.aggregate_metrics()
    wf_after = o.shard.aggregate_waterfall()
    assert wf_after["hops"][0]["bytes"] >= wf_before["hops"][0]["bytes"]


# ---------------------------------------------------------------------------
# end to end: detect -> localize -> capture
# ---------------------------------------------------------------------------

def test_argus_detect_to_capture_end_to_end(o, tmp_path, monkeypatch):
    """With the windows scaled down: an induced p99 degradation fires a
    burn-rate alert (pending→firing observed, flight ordered), turns
    /healthz degraded, and writes exactly ONE rate-limited bundle whose
    flight dump passes the protocol check."""
    monkeypatch.setenv("TPURPC_TSDB_FINE_S", "0.05")
    _fresh_tsdb(o)
    o.slo.reset()
    db = o.tsdb.get()
    slow = threading.Event()

    def handler(req, ctx):
        if slow.is_set():
            time.sleep(0.05)
        return b"ok"

    # start() starts the sampler on the fast grain and arms nothing else
    srv, port = server(o.pkg, {"/argus/Probe": ("unary_unary", handler)})
    o.bundle.enable(str(tmp_path), min_interval_s=30.0)
    ev = o.slo.get()
    ev.eval_s = 0.1
    obj = o.slo.declare(
        "probe-p99", method="/argus/Probe", latency_ms=10.0,
        latency_target_pct=50.0, windows=[(0.8, 1.6, 1.2)])
    st = obj.tracks["latency"]
    try:
        with o.channel.Channel(f"127.0.0.1:{port}") as ch:
            call = method(o.pkg, ch, "unary_unary", "/argus/Probe")
            for _ in range(16):  # the healthy rolling-p99 history
                call(b"x", timeout=5)
            slow.set()
            states = set()
            deadline = time.monotonic() + 2 * 0.8 + 8.0
            while time.monotonic() < deadline:
                call(b"x", timeout=5)
                states.add(st.state)
                if st.state == "firing":
                    break
            assert st.state == "firing", (st.state, states)
            assert "pending" in states
            status, _ctype, body = o.scrape._route("/healthz?json=1")
            doc = json.loads(body)
            assert status == 503
            assert "slo-firing" in [r["reason"]
                                    for r in doc["degraded_reasons"]]
            assert any(h.get("stage") == "slo"
                       for h in o.watchdog.get().snapshot()["history"])
            time.sleep(0.5)
            bundles = o.bundle.list_bundles(str(tmp_path))
            assert len(bundles) == 1, bundles
            bpath = os.path.join(str(tmp_path), bundles[-1])
            total, violations = protocol.check_dump(bpath)
            assert violations == [] and total > 0
            with open(os.path.join(
                    bpath, f"flight-{os.getpid()}.json")) as f:
                events = json.load(f)
            assert any(e["event"] == "slo-firing" for e in events)
            with open(os.path.join(bpath, "history.json")) as f:
                hist = json.load(f)
            assert "watchdog_p99_us{/argus/Probe}" in hist["series"]
    finally:
        ev.stop()
        srv.stop(grace=0)
        db.stop()
        o.tsdb.postfork_reset()  # the next get() builds on the default grain
    names = [e["event"] for e in o.flight.snapshot()]
    assert names.index("slo-firing") < names.index("bundle-written")
