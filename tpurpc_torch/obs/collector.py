"""Fleet collector: one telemetry front door for N members.

A copy of ``tpurpc/obs/collector.py``. The collector (``python -m
tpurpc_torch.tools.collector``) polls every member's introspection routes
(``/metrics``, ``/debug/slo``, ``/debug/flight``, ``/traces``,
``/debug/seq``, ``/debug/diagnose``: the plain-HTTP plane ``curl`` and the shard fan-out
speak) and serves the merged views:

* ``GET /fleet/metrics``: every member's Prometheus series with a
  ``member="host:port"`` label injected first, counters passed through a
  :class:`tpurpc_torch.obs.tsdb.ResetClamp` so a restarted member cannot
  step a merged series backwards, plus ``tpurpc_member_up{member}`` and
  ``tpurpc_member_stale{member}``;
* ``GET /fleet/slo``: every member's ``/debug/slo`` plus a flat ``alerts``
  list, each alert tagged with its member;
* ``GET /fleet/seq``: every member's ``/debug/seq`` merged, sequence rows
  tagged with their member, account rollups summed across the fleet;
* ``GET /fleet/diagnose``: every member's diagnosis merged, hypotheses
  re-combined by cause across members, a ``corroboration`` map and the
  ``degraded`` member list;
* ``GET /healthz``: the collector's own liveness and member census.

A member that stops answering is marked stale after ``stale_after``
missed polls and its series vanish from ``/fleet/metrics``; a member that
answers again resumes, and the reset clamp continues its counters.
Targets are ``host:port`` or any resolver spec
:func:`tpurpc_torch.rpc.resolver.resolve_target` understands.

Left out, with its item: ``/fleet/timeline`` (``tools/timeline.py``,
ROADMAP A12).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from tpurpc_torch.obs.tsdb import ResetClamp

__all__ = ["FleetCollector", "resolve_targets"]


def resolve_targets(specs: List[str]) -> List[str]:
    """``host:port`` specs pass through; anything with a scheme goes to
    the resolver (``dns:///name:port`` fans out to every address)."""
    out: List[str] = []
    for spec in specs:
        if "://" in spec or spec.startswith("dns:"):
            try:
                from tpurpc_torch.rpc.resolver import resolve_target

                for addr in resolve_target(spec):
                    host = getattr(addr, "host", None) or addr[0]
                    port = getattr(addr, "port", None) or addr[1]
                    out.append(f"{host}:{port}")
                continue
            except Exception:
                pass  # fall through: treat as literal
        out.append(spec)
    # stable de-dup
    seen = set()
    uniq = []
    for t in out:
        if t not in seen:
            seen.add(t)
            uniq.append(t)
    return uniq


class _Member:
    __slots__ = ("target", "metrics_text", "slo", "flight", "anchor",
                 "seq", "diagnose", "last_ok_mono", "polls", "misses",
                 "resets_seen")

    def __init__(self, target: str):
        self.target = target
        self.metrics_text = ""
        self.slo: Optional[dict] = None
        self.flight: Optional[dict] = None
        self.anchor: Optional[dict] = None
        self.seq: Optional[dict] = None
        self.diagnose: Optional[dict] = None
        self.last_ok_mono = 0.0
        self.polls = 0
        self.misses = 0
        self.resets_seen = 0


class FleetCollector:
    """Polls the members on ``poll_s`` and renders the merged views.
    Pure-ish core: :meth:`poll_once` + the renderers are driven directly
    by tests; :meth:`serve` adds the HTTP face."""

    def __init__(self, targets: List[str], poll_s: float = 1.0,
                 stale_after: int = 3, fetch_timeout_s: float = 2.0):
        self.targets = list(targets)
        self.poll_s = poll_s
        self.stale_after = max(1, int(stale_after))
        self.fetch_timeout_s = fetch_timeout_s
        self._members: Dict[str, _Member] = {
            t: _Member(t) for t in self.targets}
        self._clamp = ResetClamp()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._httpd = None

    # -- polling --------------------------------------------------------------

    def _fetch(self, target: str, path: str) -> Optional[bytes]:
        try:
            with urllib.request.urlopen(
                    f"http://{target}{path}",
                    timeout=self.fetch_timeout_s) as resp:
                return resp.read()
        except Exception:
            return None

    def poll_once(self) -> None:
        for target in self.targets:
            m = self._members[target]
            m.polls += 1
            raw = self._fetch(target, "/metrics")
            if raw is None:
                m.misses += 1
                continue
            slo_raw = self._fetch(target, "/debug/slo")
            flight_raw = self._fetch(target, "/debug/flight")
            traces_raw = self._fetch(target, "/traces")
            seq_raw = self._fetch(target, "/debug/seq")
            diag_raw = self._fetch(target, "/debug/diagnose")
            with self._lock:
                m.misses = 0
                m.last_ok_mono = time.monotonic()
                m.metrics_text = raw.decode("utf-8", "replace")
                m.slo = _loads(slo_raw)
                m.flight = _loads(flight_raw)
                m.seq = _loads(seq_raw)
                m.diagnose = _loads(diag_raw)
                traces = _loads(traces_raw) or {}
                m.anchor = (traces.get("clock_anchor")
                            or _first_anchor(traces))

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.poll_s):
            try:
                self.poll_once()
            except Exception:
                pass  # a collector crash helps nobody

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = threading.Event()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="tpurpc-collector")
        self._thread = t
        t.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
        self._thread = None
        httpd = self._httpd
        if httpd is not None:
            try:
                httpd.shutdown()
            except Exception:
                pass
            self._httpd = None

    # -- member state ---------------------------------------------------------

    def member_state(self, m: _Member) -> str:
        if m.last_ok_mono == 0.0:
            return "never-seen"
        if m.misses >= self.stale_after:
            return "stale"
        return "up"

    def census(self) -> List[dict]:
        with self._lock:
            return [{"member": m.target, "state": self.member_state(m),
                     "polls": m.polls, "misses": m.misses,
                     "age_s": (round(time.monotonic() - m.last_ok_mono, 2)
                               if m.last_ok_mono else None)}
                    for m in self._members.values()]

    # -- /fleet/metrics -------------------------------------------------------

    @staticmethod
    def _member_label(line: str, member: str) -> str:
        brace = line.find("{")
        space = line.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            return f'{line[:brace]}{{member="{member}",{line[brace + 1:]}'
        name, _, rest = line.partition(" ")
        return f'{name}{{member="{member}"}} {rest}'

    def merged_metrics(self) -> str:
        """The fleet Prometheus text. A stale member contributes NO data
        series (vanish, never freeze) but stays in the census gauges;
        counters ride the reset clamp so a member restart reads as a flat
        spot, not a cliff."""
        types: Dict[str, str] = {}
        series: List[str] = []
        census: List[Tuple[str, str]] = []
        with self._lock:
            members = list(self._members.values())
        for m in members:
            state = self.member_state(m)
            census.append((m.target, state))
            if state != "up":
                continue
            counter_names = set()
            for line in m.metrics_text.splitlines():
                if line.startswith("# TYPE "):
                    parts = line.split()
                    if len(parts) >= 4:
                        types.setdefault(parts[2], parts[3])
                        if parts[3] == "counter":
                            counter_names.add(parts[2])
                    continue
                if not line or line.startswith("#"):
                    continue
                name, _, value = line.rpartition(" ")
                if name in counter_names or name.split("{", 1)[0] \
                        in counter_names:
                    try:
                        v = float(value)
                    except ValueError:
                        series.append(self._member_label(line, m.target))
                        continue
                    clamped = self._clamp.clamp((m.target, name), v)
                    if clamped != v:
                        m.resets_seen = self._clamp.resets
                    line = f"{name} {_fmt(clamped)}"
                series.append(self._member_label(line, m.target))
        lines = [f"# TYPE {name} {t}" for name, t in sorted(types.items())]
        lines.append("# TYPE tpurpc_member_up gauge")
        lines.append("# TYPE tpurpc_member_stale gauge")
        for target, state in census:
            up = 1 if state == "up" else 0
            stale = 1 if state == "stale" else 0
            lines.append(f'tpurpc_member_up{{member="{target}"}} {up}')
            lines.append(
                f'tpurpc_member_stale{{member="{target}"}} {stale}')
        lines.append(
            f"tpurpc_collector_counter_resets {self._clamp.resets}")
        lines.extend(series)
        return "\n".join(lines) + "\n"

    # -- /fleet/slo -----------------------------------------------------------

    def merged_slo(self) -> dict:
        members: Dict[str, dict] = {}
        alerts: List[dict] = []
        with self._lock:
            snap = [(m.target, self.member_state(m), m.slo)
                    for m in self._members.values()]
        for target, state, doc in snap:
            members[target] = {"state": state,
                               "slo": doc if state == "up" else None}
            if state != "up" or not doc:
                continue
            for a in doc.get("firing", ()):
                alerts.append(dict(a, member=target))
            for obj in doc.get("objectives", ()):
                for track, st in (obj.get("tracks") or {}).items():
                    if st.get("state") == "pending":
                        alerts.append({
                            "objective": obj.get("name"), "track": track,
                            "state": "pending",
                            "burn_fast": st.get("burn_fast"),
                            "burn_slow": st.get("burn_slow"),
                            "member": target})
        alerts.sort(key=lambda a: (a.get("state", "firing") != "firing",
                                   str(a.get("member"))))
        return {"members": members, "alerts": alerts,
                "firing": sum(1 for a in alerts
                              if a.get("state", "firing") == "firing")}

    # -- /fleet/seq -----------------------------------------------------------

    def merged_seq(self) -> dict:
        """The fleet-wide sequence/account view: every UP member's
        /debug/seq merged through the same pure merge the shard fan-out
        uses: rows tagged ``member``, account rollups summed across the
        fleet (a stale member's sequences vanish, never freeze)."""
        from tpurpc_torch.obs.odyssey import merge_seq_docs

        with self._lock:
            snap = [(m.target, self.member_state(m), m.seq)
                    for m in self._members.values()]
        docs = {t: doc for t, state, doc in snap
                if state == "up" and doc}
        out = merge_seq_docs(docs, label="member")
        out["members"] = {t: state for t, state, _d in snap}
        return out

    # -- /fleet/diagnose -------------------------------------------------------

    def merged_diagnose(self) -> dict:
        """The fleet-wide causal view: every UP member's /debug/diagnose
        merged through the same pure merge the shard fan-out uses —
        hypotheses re-combined by cause, evidence member-tagged, and a
        ``corroboration`` map naming which members cite each cause ("3
        members degraded, all cite the same peer" is one dict lookup)."""
        from tpurpc_torch.obs.diagnose import merge_diagnose_docs

        with self._lock:
            snap = [(m.target, self.member_state(m), m.diagnose)
                    for m in self._members.values()]
        docs = {t: doc for t, state, doc in snap
                if state == "up" and doc}
        out = merge_diagnose_docs(docs, label="member")
        out["members"] = {t: state for t, state, _d in snap}
        out["degraded"] = sorted(
            t for t, state, doc in snap
            if state == "up" and doc and doc.get("symptom"))
        return out

    # -- HTTP face ------------------------------------------------------------

    def route(self, path: str) -> Tuple[int, str, bytes]:
        route, _, _query = path.partition("?")
        if route in ("/fleet/metrics", "/fleet/metrics/", "/metrics"):
            return (200, "text/plain; version=0.0.4",
                    self.merged_metrics().encode())
        if route in ("/fleet/slo", "/fleet/slo/"):
            return (200, "application/json",
                    json.dumps(self.merged_slo(), indent=1).encode())
        if route in ("/fleet/seq", "/fleet/seq/"):
            return (200, "application/json",
                    json.dumps(self.merged_seq(), indent=1).encode())
        if route in ("/fleet/diagnose", "/fleet/diagnose/"):
            return (200, "application/json",
                    json.dumps(self.merged_diagnose(), indent=1).encode())
        if route in ("/healthz", "/health"):
            doc = {"status": "ok", "members": self.census(),
                   "poll_s": self.poll_s}
            return 200, "application/json", json.dumps(doc).encode()
        return (404, "text/plain",
                b"tpurpc-collector: /fleet/metrics /fleet/slo /fleet/seq "
                b"/fleet/diagnose /healthz\n")

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start polling + the HTTP face; returns the bound port."""
        import http.server
        import socketserver

        self.start()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                status, ctype, body = outer.route(self.path)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        class Srv(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = Srv((host, port), Handler)
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                             name="tpurpc-collector-http")
        t.start()
        return self._httpd.server_address[1]


def _loads(raw: Optional[bytes]) -> Optional[dict]:
    if raw is None:
        return None
    try:
        doc = json.loads(raw)
        return doc if isinstance(doc, dict) else None
    except ValueError:
        return None


def _first_anchor(traces: dict) -> Optional[dict]:
    anchors = traces.get("clock_anchors")
    if isinstance(anchors, dict) and anchors:
        return anchors[sorted(anchors)[0]]
    return None


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(v)
