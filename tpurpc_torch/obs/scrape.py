"""The introspection plane: Prometheus text and trace export over HTTP.

A copy of ``tpurpc/obs/scrape.py`` (the same routes, bodies and
variables). Two ways in, one rendering core:

* **On every serving port**: :class:`tpurpc_torch.rpc.server.Server`'s
  protocol sniff recognizes an HTTP request line (``GET `` / ``HEAD``) and
  hands the endpoint to :func:`handle_http`, so the port that serves RPCs
  answers ``curl http://host:port/metrics``; the sniff thread serves the
  one response and closes. ``TPURPC_SCRAPE=0`` turns it off.
* **Standalone**: :func:`start_http_server` (127.0.0.1, an ephemeral port)
  for processes with no server, and for each shard worker's loopback
  listener.

Routes::

    /metrics       Prometheus text: the registry's counters, gauges,
                   histograms and fleet gauges, the copy ledger, channelz
    /traces        Chrome trace_event JSON of the span buffer (?trace_id=)
    /channelz      the channelz snapshot
    /healthz       "ok"; 503 "degraded: ..." while the stall watchdog has
                   an active diagnosis or an SLO alert fires; 200
                   "draining" while Server.drain() bleeds connections;
                   ?json=1 answers the structured body (healthz_doc)
    /debug/flight  the flight replay (?text=1, ?since_ns=N)
    /debug/stalls  the watchdog's diagnoses: active and recent
    /debug/profile the stage profiler (?collapsed=1, ?samples=1)
    /debug/waterfall  the byte-flow waterfall (?text=1)
    /debug/history the tsdb (?series=NAME&window_s=S, bare = inventory)
    /debug/slo     the SLO objectives, burn rates and alert states
    /debug/seq     per-sequence cost ledgers and the account rollup
                   (?account=, ?n=)
    /debug/diagnose  ranked causal hypotheses (?symptom=, ?text=1)

In a shard worker the aggregate-aware routes merge every live worker's
view (:mod:`tpurpc_torch.obs.shard`); ``?local=1`` serves the worker alone.
Every dispatch records its cost in the ``scrape_us`` histogram.

``/healthz`` carries one ``gen`` line per live decode scheduler and one
``kv`` line per live KV arena (``health_lines`` of
:mod:`tpurpc_torch.serving.scheduler` and :mod:`tpurpc_torch.serving.kv`,
read through ``sys.modules`` gates, so a process without a generation
plane keeps its old bodies).

Left out, with its item: the fold of the C core's counters into the
registry before a render (``obs/native_obs.py``, ROADMAP A7 (b)).
"""

from __future__ import annotations

import json
import time as _time
from typing import List, Optional, Tuple

from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _obs_profiler
from tpurpc_torch.obs import tracing as _tracing

PREFIX = "tpurpc_"

#: HTTP request-line openers the server sniff routes here (8-byte prefixes
#: compared against the sniffed first bytes)
HTTP_METHOD_PREFIXES = (b"GET ", b"HEAD")

#: what one scrape costs, measured where it runs (the sniff /
#: http threads) — so scrape load is attributable without touching serving
#: latency histograms
_SCRAPE_US = _metrics.histogram("scrape_us", kind="latency")

#: sampling-profiler frame markers: scrape rendering is its own stage
_LENS_STAGES = {
    "handle_http": "scrape",
    "render_prometheus": "scrape",
    "_route": "scrape",
    "route_local": "scrape",
}
_obs_profiler.register_stages(__file__, _LENS_STAGES)


def scrape_enabled() -> bool:
    from tpurpc_torch.utils.config import _env

    return (_env("TPURPC_SCRAPE") or "1").lower() not in ("0", "off", "false")


def _san(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def render_prometheus() -> str:
    """The full Prometheus text exposition: one pass over the registry,
    the copy ledger, and channelz — scrape-time reads only."""
    lines: List[str] = []

    snap = _metrics.registry().metrics()
    for name in sorted(snap):
        m = snap[name]
        full = PREFIX + _san(name)
        if isinstance(m, _metrics.Counter):
            lines.append(f"# TYPE {full} counter")
            lines.append(f"{full} {m.snapshot()}")
        elif isinstance(m, _metrics.LabeledCounter):
            lines.append(f"# TYPE {full} counter")
            names = m.labelnames
            for key, value in sorted(m.snapshot().items()):
                labels = ",".join(f'{n}="{v}"' for n, v in zip(names, key))
                lines.append(f"{full}{{{labels}}} {value}")
        elif isinstance(m, _metrics.Gauge):
            lines.append(f"# TYPE {full} gauge")
            lines.append(f"{full} {m.snapshot()}")
        elif isinstance(m, _metrics.Histogram):
            s = m.snapshot()
            lines.append(f"# TYPE {full} summary")
            lines.append(f'{full}{{quantile="0.5"}} {s["p50"]}')
            lines.append(f'{full}{{quantile="0.99"}} {s["p99"]}')
            lines.append(f"{full}_sum {m.sum()}")
            lines.append(f"{full}_count {s['count']}")
            lines.append(f"{full}_max {s['max']}")
        elif isinstance(m, _metrics.FleetGauge):
            total, n = m.collect()
            lines.append(f"# TYPE {full} gauge")
            lines.append(f"{full} {total}")
            lines.append(f"{full}_objects {n}")

    # copy ledger (tpurpc/tpu/ledger.py): byte + op totals per mechanism
    try:
        from tpurpc_torch.tpu import ledger

        led = ledger.snapshot()
        lines.append(f"# TYPE {PREFIX}ledger_bytes counter")
        lines.append(f"# TYPE {PREFIX}ledger_ops counter")
        for k in sorted(led):
            if k.endswith("_ops"):
                lines.append(
                    f'{PREFIX}ledger_ops{{kind="{k[:-4]}"}} {led[k]}')
            else:
                lines.append(f'{PREFIX}ledger_bytes{{kind="{k}"}} {led[k]}')
    except Exception:
        pass

    # channelz: per-entity call counters + stream/connection gauges — the
    # data test_channelz asserts programmatically, live on the scrape
    try:
        from tpurpc_torch.rpc import channelz

        lines.append(f"# TYPE {PREFIX}channelz_calls counter")
        lines.append(f"# TYPE {PREFIX}channelz_streams gauge")
        lines.append(f"# TYPE {PREFIX}channelz_connections gauge")
        for sid, srv in channelz.live_servers():
            info = channelz.server_info(srv)
            ent = f'entity="server",id="{sid}"'
            for key in ("calls_started", "calls_succeeded", "calls_failed"):
                if key in info:
                    lines.append(
                        f'{PREFIX}channelz_calls{{{ent},'
                        f'kind="{key[6:]}"}} {info[key]}')
            lines.append(f'{PREFIX}channelz_streams{{{ent}}} '
                         f'{info["active_streams"]}')
            lines.append(f'{PREFIX}channelz_connections{{{ent}}} '
                         f'{info["connections"]}')
        for cid, ch in channelz.live_channels():
            info = channelz.channel_info(ch)
            ent = f'entity="channel",id="{cid}"'
            counters = getattr(ch, "call_counters", None)
            if counters is not None:
                cd = counters.as_dict()
                for key in ("calls_started", "calls_succeeded",
                            "calls_failed"):
                    lines.append(
                        f'{PREFIX}channelz_calls{{{ent},'
                        f'kind="{key[6:]}"}} {cd[key]}')
            lines.append(f'{PREFIX}channelz_streams{{{ent}}} '
                         f'{info["active_streams"]}')
            lines.append(f'{PREFIX}channelz_connections{{{ent}}} '
                         f'{info["connected"]}')
    except Exception:
        pass

    return "\n".join(lines) + "\n"


# -- request handling (shared by the sniff path and the standalone server) --

def _query_params(query: str) -> dict:
    out = {}
    for part in query.split("&"):
        k, _, v = part.partition("=")
        if k:
            out[k] = v
    return out


def _route(path: str) -> Tuple[int, str, bytes]:
    """(status, content_type, body) for one GET path.

    In a shard worker, the aggregate-aware routes
    (/metrics, /traces, /debug/flight, /debug/stalls, /debug/profile,
    /debug/waterfall, /healthz) merge EVERY live worker's view — one GET on
    the serving port tells the whole truth no matter which shard the accept
    spread picked. ``?local=1`` serves this worker alone (it is also the
    recursion guard for peer fetches)."""
    t0 = _time.monotonic_ns()
    try:
        route, _, query = path.partition("?")
        params = _query_params(query)
        if not params.get("local"):
            from tpurpc_torch.obs import shard as _shard

            if _shard.sharded():
                agg = _shard.route_aggregate(route, params)
                if agg is not None:
                    return agg
        return route_local(path)
    finally:
        _SCRAPE_US.record((_time.monotonic_ns() - t0) // 1000)


def healthz_doc() -> dict:
    """ONE structured health assembly feeding
    both ``/healthz`` faces. Every subsystem that used to compose its own
    ad-hoc text line (watchdog 503, fleet drain, cadence shedding, kv
    pressure, and now a firing SLO) contributes one entry to
    ``degraded_reasons`` — ``[{"reason": <slug>, "detail": <text>}]`` —
    so probes stop regex-ing prose. ``code`` is the HTTP status the text
    face answers (503 iff a watchdog stall or SLO page is live);
    ``lines`` are the legacy per-subsystem body lines, unchanged."""
    reasons: List[dict] = []
    code = 200
    # a live stall diagnosis degrades health — LBs and
    # probes see the wedge without scraping /debug/stalls themselves.
    # Ordered FIRST so the legacy degraded text body stays byte-for-byte.
    try:
        from tpurpc_torch.obs import watchdog as _watchdog

        active = _watchdog.get().active()
    except Exception:
        active = []
    if active:
        worst = active[0]
        code = 503
        reasons.append({
            "reason": "watchdog-stall",
            "detail": (f"{len(active)} stalled call(s); "
                       f"{worst['method']} blocked on {worst['stage']} "
                       f"for {worst['age_s']}s")})
    # a FIRING burn-rate alert is a page — degraded, like a
    # stall (sys.modules-gated: processes without an SLO plane keep their
    # exact old behavior)
    import sys

    slo_lines: List[str] = []
    try:
        slo_mod = sys.modules.get("tpurpc_torch.obs.slo")
        if slo_mod:
            fir = slo_mod.firing()
            if fir:
                code = 503
                f0 = fir[0]
                reasons.append({
                    "reason": "slo-firing",
                    "detail": (f"{len(fir)} firing SLO alert(s); "
                               f"{f0['objective']}/{f0['track']} burning "
                               f"{f0['burn_fast']}x fast-window budget")})
            slo_lines = slo_mod.health_lines()
    except Exception:
        pass
    # a draining server is HEALTHY but leaving — 200 with a
    # distinct body (a 503 would read as failure and page; orchestrators
    # key on the text to stop routing without alarming)
    try:
        from tpurpc_torch.rpc import channelz as _channelz

        draining = any(getattr(srv, "draining", False)
                       for _sid, srv in _channelz.live_servers())
    except Exception:
        draining = False
    if draining:
        reasons.append({"reason": "draining",
                        "detail": "graceful drain in progress (healthy, "
                                  "leaving rotation)"})
    # live decode schedulers append their shed/queue
    # state — during overload an operator (or probe) reads "shedding"
    # plus the queue numbers right here, without the metrics plane.
    # Still 200: a shedding server is doing its job, not failing.
    try:
        gen_mod = sys.modules.get("tpurpc_torch.serving.scheduler")
        lines_of = getattr(gen_mod, "health_lines", None)
        gen_lines = lines_of() if lines_of else []
    except Exception:
        gen_lines = []
    shedding = [ln for ln in gen_lines if "state=shedding" in ln]
    if shedding:
        reasons.append({"reason": "shedding",
                        "detail": f"{len(shedding)} scheduler(s) shedding "
                                  "batch-class load under pressure"})
    # live KV arenas append block occupancy / swap
    # pressure / quarantine counts — same sys.modules gate, so
    # processes without a KV plane keep their exact old bodies
    kv_lines: List[str] = []
    try:
        kv_mod = sys.modules.get("tpurpc_torch.serving.kv")
        if kv_mod and hasattr(kv_mod, "health_lines"):
            kv_lines = kv_mod.health_lines()
            pressured = []
            for m in list(getattr(kv_mod, "_LIVE", ()) or ()):
                try:
                    s = m.stats()
                    if s.get("swapped_blocks") or s.get("quarantined"):
                        pressured.append(m.name)
                except Exception:
                    continue
            if pressured:
                reasons.append({
                    "reason": "kv-pressure",
                    "detail": f"KV arena(s) under pressure "
                              f"(swap/quarantine): "
                              f"{', '.join(sorted(pressured))}"})
    except Exception:
        pass
    lines = gen_lines + kv_lines + slo_lines
    status = ("degraded" if code == 503
              else "draining" if draining else "ok")
    return {"status": status, "code": code, "draining": draining,
            "degraded_reasons": reasons, "lines": lines}


def route_local(path: str) -> Tuple[int, str, bytes]:
    """The single-process rendering of one GET path (no shard fan-out)."""
    route, _, query = path.partition("?")
    if route in ("/metrics", "/metrics/"):
        return 200, "text/plain; version=0.0.4", render_prometheus().encode()
    if route in ("/healthz", "/health"):
        params = _query_params(query)
        doc = healthz_doc()
        # the STRUCTURED face — one
        # degraded_reasons list instead of N ad-hoc text conventions
        if params.get("json"):
            return (doc["code"], "application/json",
                    json.dumps(doc, indent=1).encode())
        # the text face: every legacy body preserved byte-for-byte (the
        # fleet/shard/cadence tests and smokes key on these exact bytes)
        if doc["code"] == 503:
            worst = doc["degraded_reasons"][0]
            body = (f"degraded: {worst['detail']}\n").encode()
            return 503, "text/plain", body
        head = b"draining" if doc["draining"] else b"ok"
        gen_lines = doc["lines"]
        if gen_lines:
            body = head + b"\n" + "\n".join(gen_lines).encode() + b"\n"
            return 200, "text/plain", body
        if doc["draining"]:
            return 200, "text/plain", b"draining\n"
        return 200, "text/plain", b"ok\n"
    if route in ("/debug/flight", "/debug/flight/"):
        from tpurpc_torch.obs import flight as _flight

        params = _query_params(query)
        try:
            since_ns = int(params.get("since_ns") or 0)
        except ValueError:
            return 400, "text/plain", b"bad since_ns\n"
        if params.get("text"):
            return (200, "text/plain",
                    _flight.dump_text(since_ns=since_ns).encode())
        return (200, "application/json",
                json.dumps({"events": _flight.snapshot(since_ns=since_ns),
                            "capacity": _flight.RECORDER.capacity}).encode())
    if route in ("/debug/stalls", "/debug/stalls/"):
        from tpurpc_torch.obs import watchdog as _watchdog

        return (200, "application/json",
                json.dumps(_watchdog.get().snapshot(), indent=1).encode())
    if route in ("/debug/profile", "/debug/profile/"):
        from tpurpc_torch.obs import lens as _lens

        params = _query_params(query)
        if not _lens.enabled():
            return (200, "application/json",
                    json.dumps({"enabled": False,
                                "reason": "TPURPC_LENS=0"}).encode())
        _obs_profiler.ensure_started()  # client-only processes: first scrape
        if params.get("collapsed"):
            return (200, "text/plain",
                    _obs_profiler.collapsed_text().encode())
        snap = _obs_profiler.snapshot(
            include_samples=bool(params.get("samples")))
        snap["enabled"] = True
        return 200, "application/json", json.dumps(snap).encode()
    if route in ("/debug/waterfall", "/debug/waterfall/"):
        from tpurpc_torch.obs import lens as _lens

        params = _query_params(query)
        if params.get("text"):
            return 200, "text/plain", _lens.render_text().encode()
        return (200, "application/json",
                json.dumps(_lens.waterfall()).encode())
    if route in ("/debug/history", "/debug/history/"):
        # the ring tsdb — bounded metric history
        from tpurpc_torch.obs import tsdb as _tsdb

        params = _query_params(query)
        return (200, "application/json",
                json.dumps(_tsdb.history_doc(params)).encode())
    if route in ("/debug/slo", "/debug/slo/"):
        # objectives + burn rates + alert states
        from tpurpc_torch.obs import slo as _slo

        return (200, "application/json",
                json.dumps(_slo.slo_doc(), indent=1).encode())
    if route in ("/debug/seq", "/debug/seq/"):
        # per-sequence cost ledgers: live + recent-completed, account
        # rollup, step-time attribution check (?account= filters, ?n=
        # bounds the lists)
        from tpurpc_torch.obs import odyssey as _odyssey

        params = _query_params(query)
        return (200, "application/json",
                json.dumps(_odyssey.seq_doc(params), indent=1).encode())
    if route in ("/debug/diagnose", "/debug/diagnose/"):
        # ranked causal hypotheses for the
        # current symptom (?symptom= pins one; ?text=1 the prose face)
        from tpurpc_torch.obs import diagnose as _diagnose

        params = _query_params(query)
        doc = _diagnose.diagnose_doc(params)
        if params.get("text"):
            return (200, "text/plain",
                    _diagnose.render_text(doc).encode())
        return (200, "application/json",
                json.dumps(doc, indent=1).encode())
    if route in ("/channelz", "/channelz/"):
        from tpurpc_torch.rpc import channelz

        return (200, "application/json",
                json.dumps(channelz.snapshot(), indent=1).encode())
    if route in ("/traces", "/traces/"):
        trace_id: Optional[str] = None
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if k == "trace_id" and v:
                trace_id = v
        try:
            body = json.dumps(_tracing.chrome_trace(trace_id)).encode()
        except ValueError:
            return 400, "text/plain", b"bad trace_id\n"
        return 200, "application/json", body
    return (404, "text/plain",
            b"tpurpc-scope: /metrics /traces /channelz /healthz "
            b"/debug/flight /debug/stalls /debug/profile /debug/waterfall "
            b"/debug/history /debug/slo /debug/seq /debug/diagnose\n")


def _response(status: int, ctype: str, body: bytes,
              head_only: bool = False) -> List[bytes]:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              503: "Service Unavailable"}.get(status, "")
    head = (f"HTTP/1.0 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode()
    return [head] if head_only else [head, body]


def handle_http(endpoint, first: bytes) -> None:
    """Serve one HTTP request on a freshly-sniffed Endpoint and close it.

    ``first`` is whatever the protocol sniff already consumed. Reads to the
    end of the request line only (headers are irrelevant), bounded at 8 KiB
    / 5 s so a stuck client can't pin the sniff thread."""
    buf = bytearray(first)
    try:
        scratch = bytearray(1024)
        mv = memoryview(scratch)
        while b"\r\n" not in buf and b"\n" not in buf and len(buf) < 8192:
            n = endpoint.read_into(mv, timeout=5)
            if n == 0:
                break
            buf += mv[:n]
        line = bytes(buf).split(b"\n", 1)[0].strip().decode("latin-1")
        parts = line.split()
        method = parts[0] if parts else "GET"
        path = parts[1] if len(parts) > 1 else "/metrics"
        status, ctype, body = _route(path)
        endpoint.write(_response(status, ctype, body,
                                 head_only=method == "HEAD"))
    except Exception:
        pass  # a scrape must never take anything down
    finally:
        try:
            endpoint.close()
        except Exception:
            pass


def start_http_server(host: str = "127.0.0.1", port: int = 0):
    """Standalone introspection endpoint (client-only processes): returns
    ``(server, bound_port)``; ``server.shutdown()`` stops it. Daemon
    threads — it never blocks interpreter exit."""
    import http.server
    import socketserver
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            status, ctype, body = _route(self.path)
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_HEAD(self):  # noqa: N802
            status, ctype, body = _route(self.path)
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()

        def log_message(self, *args):  # quiet: scrapes are periodic
            pass

    class Srv(socketserver.ThreadingMixIn, http.server.HTTPServer):
        daemon_threads = True
        allow_reuse_address = True

    srv = Srv((host, port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="tpurpc-obs-http")
    t.start()
    return srv, srv.server_address[1]
