"""The scrape plane on both packages, the shard fleet's aggregated
telemetry on the port, and ``least_loaded``'s flight events.

Twins, each on the reference and on the port (``pkg``) on the same
inputs: ``tests/test_obs.py``'s three scrape cases (the routes on the
serving port, the standalone listener, the Prometheus text), the RED
counters' rendered labels and the debug routes of ``tests/test_flight.py``,
and the ``/healthz`` drain body of ``tests/test_health.py``; then what the
port's slice adds on the same footing: ``TPURPC_SCRAPE=0``,
``Server.start()`` starting the tsdb sampler, the SLO evaluator and the
bundle writer, and ``least_loaded``'s ``SUBCH_EJECT``/``SUBCH_REINSTATE``.

``tests/test_shard.py``'s three aggregated-telemetry cases run on the
port alone: the reference's workers fork, which no port test does (its
own file holds its half). The port's workers spawn; each case's fleet
holds ``torch_ranks``' launch lock, every build lowers its priority
(``tests/torch_shard_builds.py``), every wait is bounded, and every fleet
is stopped in ``finally``. Calls are repeated until both workers have
served (bounded), so no case rests on the kernel's accept spread.
"""

import contextlib
import gc
import json
import socket
import time
import urllib.error
import urllib.request

import pytest

import torch_ranks
import torch_shard_builds as builds
from torch_call_plane import BOTH, both
from torch_obs import clean_obs, method, mod, server  # noqa: F401

from tpurpc.tools.top import parse_prometheus
from tpurpc_torch.obs import flight as port_flight
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.shard import ShardedServer

#: a fleet's start (spawned workers import torch) and each call, seconds
READY = 120.0
CALL = 30.0


@pytest.fixture(params=BOTH, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def _scrape_state(clean_obs):  # noqa: F811
    yield
    for p in BOTH:
        mod(p, "obs.slo").reset()
        mod(p, "obs.bundle").disable()


def _echo(pkg):
    return server(pkg, {"/obs/Echo": ("unary_unary",
                                      lambda r, c: bytes(r))},
                  max_workers=2)


def _http_get(port, path, timeout=10.0, verb="GET"):
    """One HTTP/1.0 request on loopback: ``(status, body)``; ``(None, b"")``
    when the server closed without answering."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(f"{verb} {path} HTTP/1.0\r\n\r\n".encode())
        buf = bytearray()
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    if not buf:
        return None, b""
    head, _, body = bytes(buf).partition(b"\r\n\r\n")
    return int(head.split(None, 2)[1]), body


# ---------------------------------------------------------------------------
# the scrape routes (tests/test_obs.py, tests/test_flight.py,
# tests/test_health.py)
# ---------------------------------------------------------------------------

def test_scrape_routes_on_serving_port(pkg):
    """The serving port answers the scrape routes (history, alerting and
    diagnosis among them), HEAD included, and still serves RPCs after."""
    srv, port = _echo(pkg)
    try:
        base = f"http://127.0.0.1:{port}"
        assert urllib.request.urlopen(
            f"{base}/healthz", timeout=10).read() == b"ok\n"
        hz = json.loads(urllib.request.urlopen(
            f"{base}/channelz", timeout=10).read())
        assert "servers" in hz and "channels" in hz
        tr = json.loads(urllib.request.urlopen(
            f"{base}/traces", timeout=10).read())
        assert "traceEvents" in tr
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{base}/nope", timeout=10)
        assert exc.value.code == 404
        text = urllib.request.urlopen(f"{base}/metrics",
                                      timeout=10).read().decode()
        assert ("tpurpc_srv_call_us", 'quantile="0.5"') in \
            parse_prometheus(text)
        hist = json.loads(urllib.request.urlopen(
            f"{base}/debug/history", timeout=10).read())
        assert hist["enabled"] is True and hist["running"] is True
        slo = json.loads(urllib.request.urlopen(
            f"{base}/debug/slo", timeout=10).read())
        assert {"objectives", "firing", "history"} <= set(slo)
        diag = json.loads(urllib.request.urlopen(
            f"{base}/debug/diagnose", timeout=10).read())
        assert diag["enabled"] is True and "hypotheses" in diag
        status, body = _http_get(port, "/healthz", verb="HEAD")
        assert status == 200 and body == b""
        with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
            assert method(pkg, ch, "unary_unary", "/obs/Echo")(
                b"x", timeout=10) == b"x"
    finally:
        srv.stop(grace=0)


def test_scrape_off_closes_http_connections(pkg, monkeypatch):
    """``TPURPC_SCRAPE=0``: the sniff closes an HTTP connection unanswered;
    RPCs are served as before."""
    monkeypatch.setenv("TPURPC_SCRAPE", "0")
    srv, port = _echo(pkg)
    try:
        assert _http_get(port, "/metrics") == (None, b"")
        with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
            assert method(pkg, ch, "unary_unary", "/obs/Echo")(
                b"y", timeout=10) == b"y"
    finally:
        srv.stop(grace=0)


def test_standalone_http_server(pkg):
    srv, port = mod(pkg, "obs.scrape").start_http_server()
    try:
        txt = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "tpurpc_" in txt
    finally:
        srv.shutdown()
        srv.server_close()


def test_prometheus_render_parses(pkg):
    """The reference's parser (``tools/top.py``, ROADMAP A12 for the port)
    reads both packages' text alike. The metrics' names are this file's
    own: the registries are process-wide, and ``tests/test_obs.py`` reads
    its own names' absolute values."""
    ctr = pkg.metrics.counter("torch_scrape_render_probe")
    before = ctr.snapshot()
    ctr.inc(3)
    pkg.metrics.histogram("torch_scrape_render_hist").record(5)
    parsed = parse_prometheus(mod(pkg, "obs.scrape").render_prometheus())
    assert parsed[("tpurpc_torch_scrape_render_probe", "")] == before + 3
    assert parsed[("tpurpc_torch_scrape_render_hist", 'quantile="0.5"')] == 5
    assert parsed[("tpurpc_torch_scrape_render_hist_count", "")] >= 1


def test_red_counters_render_with_labels():
    def scenario(pkg):
        srv, port = server(pkg, {
            "/f.S/Echo": ("unary_unary", lambda r, c: bytes(r))})
        fam = pkg.metrics.labeled_counter("srv_calls", ("method", "code"))
        before = fam.snapshot().get(("/f.S/Echo", "0"), 0)
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                mc = method(pkg, ch, "unary_unary", "/f.S/Echo")
                got = [bytes(mc(b"ok", timeout=20)) for _ in range(3)]
            deadline = time.monotonic() + 5
            while (fam.snapshot().get(("/f.S/Echo", "0"), 0) < before + 3
                   and time.monotonic() < deadline):
                time.sleep(0.02)
        finally:
            srv.stop(grace=0)
        text = mod(pkg, "obs.scrape").render_prometheus()
        line = next(ln for ln in text.splitlines() if ln.startswith(
            'tpurpc_srv_calls{method="/f.S/Echo",code="0"} '))
        return got, int(line.rpartition(" ")[2]) - before

    assert both(scenario) == ([b"ok"] * 3, 3)


def test_debug_routes_and_healthz_degradation(pkg):
    scrape = mod(pkg, "obs.scrape")
    flight = pkg.flight
    flight.emit(flight.PAIR_CONNECT, flight.tag_for("pair:route"), 1)
    status, ctype, body = scrape._route("/debug/flight")
    assert status == 200 and ctype == "application/json"
    assert any(e["event"] == "pair-connect" and e["entity"] == "pair:route"
               for e in json.loads(body)["events"])
    status, _, body = scrape._route("/debug/flight?text=1")
    assert status == 200 and b"pair-connect" in body
    status, _, body = scrape._route("/debug/flight?since_ns=x")
    assert status == 400
    status, _, body = scrape._route("/debug/stalls")
    assert status == 200
    assert {"active", "history", "inflight"} <= set(json.loads(body))
    wd = pkg.watchdog.get()
    wd.enabled = True
    wd.min_stall_s = 0.01
    wd.sweep_s = 0.05
    assert scrape._route("/healthz")[0] == 200
    tok = wd.call_started("/t/Health")
    time.sleep(0.02)
    wd.sweep_once()
    status, _, body = scrape._route("/healthz")
    assert status == 503 and b"degraded" in body and b"/t/Health" in body
    wd.call_finished(tok)
    wd.sweep_once()
    assert scrape._route("/healthz")[0] == 200


def test_drain_reports_draining_on_healthz(pkg):
    """During ``Server.drain()`` /healthz answers 200 ``draining`` (healthy
    but leaving rotation), and ``ok`` again once the drained server is
    gone."""
    scrape = mod(pkg, "obs.scrape")
    pkg.watchdog.get().reset()
    srv, _port = _echo(pkg)
    mod(pkg, "rpc.health").add_health_servicer(srv)
    try:
        assert scrape._route("/healthz")[::2] == (200, b"ok\n")
        assert srv.drain(linger=1.0) is True
        assert scrape._route("/healthz")[::2] == (200, b"draining\n")
    finally:
        srv.stop(grace=0)
    del srv
    deadline = time.monotonic() + 10
    body = b""
    while time.monotonic() < deadline:
        gc.collect()
        body = scrape._route("/healthz")[2]
        if body == b"ok\n":
            break
        time.sleep(0.1)
    assert body == b"ok\n"


def test_server_start_starts_history_alerting_and_capture(pkg, tmp_path,
                                                         monkeypatch):
    """``Server.start()`` starts the tsdb sampler and, with an objective
    declared, the SLO evaluator, and ``TPURPC_BUNDLE_DIR`` arms evidence
    capture."""
    tsdb, slo, bundle = (mod(pkg, f"obs.{m}")
                         for m in ("tsdb", "slo", "bundle"))
    monkeypatch.setenv("TPURPC_BUNDLE_DIR", str(tmp_path))
    slo.reset()
    slo.get().declare(slo.SloObjective("start-probe", target_pct=99.0))
    assert not slo.get().doc()["running"]
    assert not bundle.enabled()
    srv, _port = _echo(pkg)
    try:
        assert tsdb.get().doc()["running"] is True
        assert slo.get().doc()["running"] is True
        assert bundle.enabled() and bundle.get().root == str(tmp_path)
    finally:
        srv.stop(grace=0)


def test_least_loaded_flight_events():
    """Ejection by failures (a2=0) and by a slow load report (a2=1), then
    reinstatement at expiry, under ``lb:least_loaded``."""
    def scenario(pkg):
        t0 = time.monotonic_ns()
        lb = pkg.resolver.LeastLoaded(3, ejection_failures=2,
                                      ejection_s=0.05)
        lb.failed(1)
        lb.failed(1)
        for idx in (0, 1, 2):
            lb.load_report(idx, b"1,0,1.0")
        lb.load_report(2, b"1,0,80.0")
        time.sleep(0.1)
        order = list(lb.order())
        evs = [(e["event"], e["a1"], e["a2"])
               for e in pkg.flight.snapshot(since_ns=t0)
               if e["entity"] == "lb:least_loaded"]
        return order, evs

    _order, evs = both(scenario)
    assert evs == [("subch-ejected", 1, 0), ("subch-ejected", 2, 1),
                   ("subch-reinstated", 1, 0), ("subch-reinstated", 2, 0)]


# ---------------------------------------------------------------------------
# the shard fleet's aggregated telemetry (tests/test_shard.py), port only
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fleet(**kw):
    fd = torch_ranks._lock()
    try:
        sup = ShardedServer(builds.who, workers=2, **kw)
        try:
            yield sup.start(ready_timeout=READY)
        finally:
            sup.stop()
    finally:
        torch_ranks._unlock(fd)


def _who(port, timeout=CALL):
    with Channel(f"127.0.0.1:{port}") as ch:
        return bytes(ch.unary_unary("/t.S/Who")(b"x",
                                               timeout=timeout)).decode()


def _serve_both(port, at_least=8, most=64):
    """Calls on fresh connections until both workers served and at least
    ``at_least`` calls went out; returns the set of workers seen."""
    seen = set()
    for n in range(most):
        seen.add(_who(port))
        if n + 1 >= at_least and seen == {"0", "1"}:
            break
    return seen


def test_dead_shard_drops_out_of_aggregated_metrics():
    """A dead worker's series vanish from /metrics (no frozen values), and
    ``tpurpc_shard_up`` lists only the living; the supervisor records the
    death under its own tag."""
    with _fleet(listener="reuseport") as sup:
        assert _serve_both(sup.port) == {"0", "1"}
        status, body = _http_get(sup.port, "/metrics")
        text = body.decode()
        assert status == 200
        assert 'tpurpc_shard_up{shard="0"} 1' in text
        assert 'tpurpc_shard_up{shard="1"} 1' in text
        assert "tpurpc_shards_configured 2" in text
        t0 = time.monotonic_ns()
        sup.kill_worker(0)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                status, body = _http_get(sup.port, "/metrics")
                text = body.decode()
                if 'tpurpc_shard_up{shard="0"}' not in text:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert 'tpurpc_shard_up{shard="0"}' not in text, text[:2000]
        assert 'tpurpc_shard_up{shard="1"} 1' in text
        assert 'shard="0"' not in text
        deaths = [(e["a1"], e["entity"])
                  for e in port_flight.snapshot(since_ns=t0)
                  if e["event"] == "shard-death"]
        assert deaths == [(0, "shard-supervisor")]


def test_aggregated_flight_and_stalls_carry_shard_tags():
    with _fleet(listener="reuseport") as sup:
        assert _serve_both(sup.port, at_least=16) == {"0", "1"}
        status, body = _http_get(sup.port, "/debug/flight")
        assert status == 200
        doc = json.loads(body)
        assert sorted(doc["shards"]) == [0, 1]
        starts = {(e["a1"], e.get("shard")) for e in doc["events"]
                  if e["event"] == "shard-start"}
        assert starts == {(0, 0), (1, 1)}, starts
        assert all("shard" in e for e in doc["events"])
        status, body = _http_get(sup.port, "/debug/stalls")
        assert status == 200
        stalls = json.loads(body)
        assert sorted(stalls["shards"]) == ["0", "1"]
        assert all(s.get("shard") in (0, 1)
                   for s in stalls["shards"].values())
        status, body = _http_get(sup.port, "/healthz")
        assert status == 200 and body.strip() == b"ok"
        ports = sup.scrape_ports()
        status, body = _http_get(ports[0], "/metrics?local=1")
        assert status == 200 and b"tpurpc_shard_up" not in body


def test_worker_fleet_gauges_visible_in_aggregate():
    """Metrics registered inside a worker surface in the aggregated scrape,
    shard-tagged; the supervisor hands each accepted connection over with
    a ``conn-handoff`` event naming the worker."""
    with _fleet(listener="handoff") as sup:
        t0 = time.monotonic_ns()
        assert _serve_both(sup.port) == {"0", "1"}
        handoffs = [e for e in port_flight.snapshot(since_ns=t0)
                    if e["event"] == "conn-handoff"]
        _status, body = _http_get(sup.port, "/metrics")
        text = body.decode()
        assert "tpurpc_srv_call_us" in text
        for k in ("0", "1"):
            assert f'tpurpc_srv_calls{{shard="{k}"' in text, text[:2000]
        assert {e["entity"] for e in handoffs} == {"shard-supervisor"}
        assert {e["a1"] for e in handoffs} == {0, 1}
