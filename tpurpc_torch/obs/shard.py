"""Shard identity and cross-worker scrape aggregation.

A copy of ``tpurpc/obs/shard.py``. A sharded server
(:class:`tpurpc_torch.rpc.shard.ShardedServer`) runs N worker processes,
each with its own metrics registry, flight ring and watchdog. This module
makes one ``GET /metrics`` (or ``/traces``, ``/debug/flight``,
``/debug/stalls``, ``/debug/profile``, ``/debug/waterfall``,
``/debug/slo``, ``/debug/seq``, ``/debug/history``, ``/debug/diagnose``,
``/healthz``) on
the serving port tell the whole truth, whichever worker the accept spread
handed the scrape to:

* every worker runs a loopback-only scrape listener
  (:func:`tpurpc_torch.obs.scrape.start_http_server`) and the supervisor
  broadcasts the ``{shard_id: scrape_port}`` map to every worker;
* a worker answering an aggregate route fetches each peer's local view
  (``?local=1``, the recursion guard) over loopback, renders its own view
  in-process, and merges, tagging every series and event with
  ``shard="k"``; counters pass through a :class:`ResetClamp
  <tpurpc_torch.obs.tsdb.ResetClamp>` so a restarted worker cannot step a
  merged series backwards;
* a shard that died is unreachable: its series vanish from the next
  scrape, and ``tpurpc_shard_up`` enumerates who answered.

The hot path pays nothing: shard identity is two module ints, and the
fan-out runs at scrape time on the thread serving the HTTP request. The
port's workers start by spawn: :func:`set_identity` runs in the fresh
worker before its build, and nothing is inherited to reset.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "set_identity", "shard_id", "n_shards", "set_peers", "peers",
    "sharded", "route_aggregate", "aggregate_metrics", "aggregate_flight",
    "aggregate_stalls", "aggregate_healthz", "aggregate_traces",
    "aggregate_profile", "aggregate_waterfall", "aggregate_slo",
    "aggregate_history", "aggregate_seq", "aggregate_diagnose",
]

# Counter-reset hardening. A shard worker that
# died and was respawned restarts every counter at zero; summing or
# re-exporting its raw values silently steps the merged series BACKWARDS
# (a scrape-side cliff that poisons every rate() downstream). One
# process-wide ResetClamp — keyed (shard, series) — detects the monotonic
# break and continues each series from last-known + delta. It persists
# across scrapes by design: the clamp IS the memory of the restart.


def _reset_clamp():
    from tpurpc_torch.obs.tsdb import ResetClamp

    global _CLAMP
    if _CLAMP is None:
        _CLAMP = ResetClamp()
    return _CLAMP


_CLAMP = None

_lock = threading.Lock()
_SHARD_ID = -1   # -1 = this process is not a shard worker
_N_SHARDS = 0
_PEERS: Dict[int, int] = {}  # shard_id -> loopback scrape port

#: how long one peer fetch may take; a SIGKILLed worker's port refuses
#: instantly, so this bound only matters for a wedged-but-alive worker
_FETCH_TIMEOUT_S = 0.6


def set_identity(shard: int, total: int) -> None:
    global _SHARD_ID, _N_SHARDS
    with _lock:
        _SHARD_ID = int(shard)
        _N_SHARDS = int(total)


def shard_id() -> int:
    return _SHARD_ID


def n_shards() -> int:
    return _N_SHARDS


def set_peers(mapping: Dict[int, int]) -> None:
    """Install the supervisor-broadcast ``{shard_id: scrape_port}`` map
    (including this worker's own entry)."""
    global _PEERS
    with _lock:
        _PEERS = {int(k): int(v) for k, v in mapping.items()}


def peers() -> Dict[int, int]:
    with _lock:
        return dict(_PEERS)


def sharded() -> bool:
    """True when this process should answer scrapes with the AGGREGATE
    view (it is a shard worker and knows its peers)."""
    return _SHARD_ID >= 0 and bool(_PEERS)


# -- peer fetch ---------------------------------------------------------------

def _fetch(port: int, path: str) -> Optional[Tuple[int, bytes]]:
    """One loopback HTTP/1.0 GET; None when the peer is gone/wedged —
    the caller drops that shard from the merged view."""
    try:
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=_FETCH_TIMEOUT_S) as s:
            s.settimeout(_FETCH_TIMEOUT_S)
            s.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
            buf = bytearray()
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
    except OSError:
        return None
    head, _, body = bytes(buf).partition(b"\r\n\r\n")
    parts = head.split(None, 2)
    if len(parts) < 2:
        return None
    try:
        return int(parts[1]), body
    except ValueError:
        return None


def _each_shard(path: str):
    """Yield ``(shard_id, status, body_bytes)`` for every REACHABLE shard;
    self is rendered in-process (never through its own HTTP listener)."""
    from tpurpc_torch.obs import scrape as _scrape

    me = _SHARD_ID
    for k in sorted(peers()):
        if k == me:
            status, _ctype, body = _scrape.route_local(path)
            yield k, status, body
            continue
        got = _fetch(peers()[k], path if "?" in path else path + "?local=1")
        if got is None:
            continue  # dead/unreachable shard: drops out of the merge
        yield k, got[0], got[1]


# -- /metrics -----------------------------------------------------------------

def _shard_label(line: str, k: int) -> str:
    """Inject ``shard="k"`` as the first label of one exposition line."""
    brace = line.find("{")
    space = line.find(" ")
    if brace != -1 and (space == -1 or brace < space):
        return f'{line[:brace]}{{shard="{k}",{line[brace + 1:]}'
    name, _, rest = line.partition(" ")
    return f'{name}{{shard="{k}"}} {rest}'


def aggregate_metrics() -> str:
    """The merged Prometheus text: every reachable worker's series with a
    ``shard`` label, one ``# TYPE`` line per family, plus ``tpurpc_shard_up``
    per answering shard (a dead shard is ABSENT — presence is liveness)."""
    types: Dict[str, str] = {}
    series: List[str] = []
    up: List[int] = []
    clamp = _reset_clamp()
    for k, status, body in _each_shard("/metrics"):
        if status != 200:
            continue
        up.append(k)
        counters: set = set()
        for line in body.decode("utf-8", errors="replace").splitlines():
            if line.startswith("# TYPE "):
                parts = line.split()
                if len(parts) >= 4:
                    types.setdefault(parts[2], parts[3])
                    if parts[3] == "counter":
                        counters.add(parts[2])
                continue
            if not line or line.startswith("#"):
                continue
            name, _, value = line.rpartition(" ")
            if name and (name in counters
                         or name.split("{", 1)[0] in counters):
                # killed-and-restarted worker: clamp the monotonic break
                try:
                    v = float(value)
                except ValueError:
                    v = None
                if v is not None:
                    clamped = clamp.clamp((k, name), v)
                    if clamped != v:
                        line = (f"{name} {int(clamped)}"
                                if clamped.is_integer()
                                else f"{name} {clamped}")
            series.append(_shard_label(line, k))
    lines = [f"# TYPE {name} {t}" for name, t in sorted(types.items())]
    lines.append("# TYPE tpurpc_shard_up gauge")
    lines.extend(f'tpurpc_shard_up{{shard="{k}"}} 1' for k in up)
    lines.append(f"tpurpc_shards_configured {_N_SHARDS}")
    lines.extend(series)
    return "\n".join(lines) + "\n"


# -- /debug/flight ------------------------------------------------------------

def aggregate_flight(since_ns: int = 0) -> dict:
    """Every reachable shard's flight events in ONE time-ordered replay.
    CLOCK_MONOTONIC is system-wide on Linux, so cross-process ``t_ns``
    stamps order correctly — the whole point of merging: one timeline of
    what every worker's transport did."""
    events: List[dict] = []
    capacity = 0
    up: List[int] = []
    for k, status, body in _each_shard(
            f"/debug/flight?local=1&since_ns={since_ns}"):
        if status != 200:
            continue
        try:
            doc = json.loads(body)
        except ValueError:
            continue
        up.append(k)
        capacity = max(capacity, int(doc.get("capacity") or 0))
        for e in doc.get("events", ()):
            e["shard"] = k
            events.append(e)
    events.sort(key=lambda e: e.get("t_ns", 0))
    return {"events": events, "capacity": capacity, "shards": up}


def aggregate_flight_text(since_ns: int = 0) -> str:
    doc = aggregate_flight(since_ns=since_ns)
    events = doc["events"]
    if not events:
        return "flight recorder: no events (any shard)\n"
    t0 = events[0]["t_ns"]
    lines = [f"flight recorder: {len(events)} events across "
             f"{len(doc['shards'])} shard(s)"]
    for e in events:
        lines.append(
            f"  +{(e['t_ns'] - t0) / 1e6:10.3f}ms s{e.get('shard', '?')} "
            f"{e['event']:<22} {e.get('entity', '-'):<20} "
            f"a1={e['a1']} a2={e['a2']}")
    return "\n".join(lines) + "\n"


# -- /traces ------------------------------------------------------------------

def aggregate_traces(trace_id: str = "") -> dict:
    """Every reachable shard's span buffer in ONE chrome-trace document
    (a trace born on shard 2 is visible on the serving port). Each
    shard becomes its own process
    lane: its events are re-pid'd to the shard id, its ``process_name``
    metadata renamed, and its monotonic↔wall :func:`clock anchor
    <tpurpc_torch.obs.tracing.clock_anchor>` preserved per shard under
    ``clock_anchors`` — timestamps stay in each worker's monotonic clock
    here (a timeline tool rebases; CLOCK_MONOTONIC is
    system-wide on Linux, so same-host lanes already line up)."""
    events: List[dict] = []
    anchors: Dict[str, dict] = {}
    up: List[int] = []
    q = f"&trace_id={trace_id}" if trace_id else ""
    for k, status, body in _each_shard(f"/traces?local=1{q}"):
        if status != 200:
            continue
        try:
            doc = json.loads(body)
        except ValueError:
            continue
        up.append(k)
        anchor = doc.get("clock_anchor")
        if anchor:
            anchors[str(k)] = anchor
        for e in doc.get("traceEvents", ()):
            e["pid"] = k
            if e.get("ph") == "M" and e.get("name") == "process_name":
                e.setdefault("args", {})["name"] = f"tpurpc shard {k}"
            events.append(e)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "clock_anchors": anchors, "shards": up}


# -- /debug/profile -----------------------------------------------------------

def aggregate_profile(include_samples: bool = False) -> dict:
    """Per-shard profiler snapshots plus a merged per-stage sample count —
    the serving-port answer to "where do the cycles go, fleet-wide"."""
    shards: Dict[str, dict] = {}
    stages: Dict[str, int] = {}
    samples = 0
    q = "&samples=1" if include_samples else ""
    for k, status, body in _each_shard(f"/debug/profile?local=1{q}"):
        if status != 200:
            continue
        try:
            snap = json.loads(body)
        except ValueError:
            continue
        shards[str(k)] = snap
        samples += int(snap.get("samples") or 0)
        for stage, n in (snap.get("stages") or {}).items():
            stages[stage] = stages.get(stage, 0) + int(n)
    other = stages.get("other", 0)
    unatt = stages.get("unattributed", 0)
    denom = samples - other
    return {"shards": shards, "stages": stages, "samples": samples,
            "attributed_pct": (round((denom - unatt) / denom * 100, 1)
                               if denom else 0.0),
            "enabled": any(s.get("enabled") for s in shards.values())}


def aggregate_profile_collapsed() -> str:
    """Merged collapsed stacks, each line prefixed ``shard-k;`` so one
    flamegraph shows every worker side by side."""
    lines: List[str] = []
    for k, status, body in _each_shard("/debug/profile?local=1&collapsed=1"):
        if status != 200:
            continue
        for line in body.decode("utf-8", errors="replace").splitlines():
            if line:
                lines.append(f"shard-{k};{line}")
    return "\n".join(lines) + ("\n" if lines else "")


# -- /debug/waterfall ---------------------------------------------------------

def aggregate_waterfall() -> dict:
    """Per-shard waterfalls plus a merged hop table (bytes and busy_ns sum
    across workers; effective GB/s recomputed over the sums — N workers
    each moving b bytes in t ns aggregate to Nb/Nt, the same rate, not an
    inflated one)."""
    shards: Dict[str, dict] = {}
    merged: Dict[str, dict] = {}
    order: List[str] = []
    clamp = _reset_clamp()
    for k, status, body in _each_shard("/debug/waterfall?local=1"):
        if status != 200:
            continue
        try:
            doc = json.loads(body)
        except ValueError:
            continue
        shards[str(k)] = doc
        for row in doc.get("hops", ()):
            hop = row.get("hop")
            if hop not in merged:
                merged[hop] = {"hop": hop, "bytes": 0, "busy_ms": 0.0,
                               "copy_bytes": 0, "what": row.get("what", "")}
                order.append(hop)
            # these SUM raw per-shard counters — exactly the
            # merge a worker restart would step backwards; clamp each
            # shard's contribution to its monotone view first
            merged[hop]["bytes"] += int(clamp.clamp(
                (k, hop, "bytes"), int(row.get("bytes") or 0)))
            merged[hop]["busy_ms"] += clamp.clamp(
                (k, hop, "busy_ms"), float(row.get("busy_ms") or 0.0))
            merged[hop]["copy_bytes"] += int(clamp.clamp(
                (k, hop, "copy_bytes"), int(row.get("copy_bytes") or 0)))
    rows = []
    for hop in order:
        r = merged[hop]
        ns = r["busy_ms"] * 1e6
        r["gbps"] = round(r["bytes"] / ns, 3) if ns else 0.0
        r["busy_ms"] = round(r["busy_ms"], 3)
        rows.append(r)
    live = [r for r in rows if r["bytes"] > 0 and r["busy_ms"] > 0]
    return {"hops": rows,
            "slowest_hop": (min(live, key=lambda r: r["gbps"])["hop"]
                            if live else None),
            "shards": shards}


# -- /debug/slo + /debug/history ----------------------------------------------

def aggregate_slo() -> dict:
    """Every reachable shard's SLO document plus one flat shard-tagged
    ``firing`` list — the serving-port answer to "is anything paging"."""
    shards: Dict[str, dict] = {}
    firing: List[dict] = []
    for k, status, body in _each_shard("/debug/slo?local=1"):
        if status != 200:
            continue
        try:
            doc = json.loads(body)
        except ValueError:
            continue
        shards[str(k)] = doc
        for a in doc.get("firing", ()):
            firing.append(dict(a, shard=k))
    return {"shards": shards, "firing": firing}


def aggregate_seq() -> dict:
    """Every reachable shard's /debug/seq merged: sequence rows tagged
    ``shard``, account rollups and the step-time attribution totals
    summed (the pure merge is
    :func:`tpurpc_torch.obs.odyssey.merge_seq_docs`, shared with the fleet
    collector's /fleet/seq)."""
    from tpurpc_torch.obs import odyssey as _odyssey

    docs: Dict[str, dict] = {}
    for k, status, body in _each_shard("/debug/seq?local=1"):
        if status != 200:
            continue
        try:
            docs[str(k)] = json.loads(body)
        except ValueError:
            continue
    return _odyssey.merge_seq_docs(docs, label="shard")


def aggregate_diagnose(params: Optional[dict] = None) -> dict:
    """Every reachable shard's /debug/diagnose
    merged — hypotheses re-combined by cause across workers, evidence
    rows shard-tagged, cross-shard corroboration surfaced (the pure
    merge lives in :func:`tpurpc_torch.obs.diagnose.merge_diagnose_docs`,
    shared with the fleet collector's /fleet/diagnose)."""
    from tpurpc_torch.obs import diagnose as _diagnose

    want = (params or {}).get("symptom")
    path = "/debug/diagnose?local=1"
    if want:
        path += f"&symptom={want}"
    docs: Dict[str, dict] = {}
    for k, status, body in _each_shard(path):
        if status != 200:
            continue
        try:
            docs[str(k)] = json.loads(body)
        except ValueError:
            continue
    return _diagnose.merge_diagnose_docs(docs, label="shard")


def aggregate_history() -> dict:
    """Per-shard tsdb inventories (each worker samples its OWN registry —
    series merge happens at query time via the shard key, like /traces)."""
    shards: Dict[str, dict] = {}
    for k, status, body in _each_shard("/debug/history?local=1"):
        if status != 200:
            continue
        try:
            shards[str(k)] = json.loads(body)
        except ValueError:
            continue
    return {"shards": shards}


# -- /debug/stalls ------------------------------------------------------------

def aggregate_stalls() -> dict:
    """Per-shard watchdog snapshots plus a merged active/history view (each
    diagnosis tagged with its shard) — the keys tools.top and the smoke
    scripts already read stay present and truthful."""
    shards: Dict[str, dict] = {}
    active: List[dict] = []
    history: List[dict] = []
    inflight = 0
    for k, status, body in _each_shard("/debug/stalls"):
        if status != 200:
            continue
        try:
            snap = json.loads(body)
        except ValueError:
            continue
        shards[str(k)] = snap
        for d in snap.get("active", ()):
            d = dict(d, shard=k)
            active.append(d)
        for d in snap.get("history", ()):
            history.append(dict(d, shard=k))
        inflight += int(snap.get("inflight") or 0)
    history.sort(key=lambda d: d.get("since_ns", 0))
    return {"shards": shards, "active": active, "history": history,
            "inflight": inflight,
            "enabled": any(s.get("enabled") for s in shards.values())}


# -- /healthz -----------------------------------------------------------------

def aggregate_healthz() -> Tuple[int, bytes]:
    """Worst-of health: any degraded shard degrades the whole server (one
    wedged worker IS an incident); all-draining reports draining. A dead
    shard is skipped — its connections are already gone, and liveness is
    ``tpurpc_shard_up``'s job, not the health probe's."""
    degraded: List[str] = []
    bodies: List[bytes] = []
    for k, status, body in _each_shard("/healthz"):
        if status == 503:
            degraded.append(f"shard {k}: {body.decode(errors='replace').strip()}")
        bodies.append(body.strip())
    if degraded:
        return 503, ("\n".join(degraded) + "\n").encode()
    if bodies and all(b == b"draining" for b in bodies):
        return 200, b"draining\n"
    return 200, b"ok\n"


# -- scrape-plane hook --------------------------------------------------------

def route_aggregate(route: str, params: dict
                    ) -> Optional[Tuple[int, str, bytes]]:
    """The scrape plane's shard hook: the merged ``(status, ctype, body)``
    for an aggregate-aware route, or None for routes served locally
    (/channelz stays per-worker — channelz entities are process-scoped by
    design; scrape it via ?local=1 on a worker's own scrape port when
    debugging one shard)."""
    try:
        if route in ("/traces", "/traces/"):
            doc = aggregate_traces(trace_id=params.get("trace_id") or "")
            return 200, "application/json", json.dumps(doc).encode()
        if route in ("/debug/profile", "/debug/profile/"):
            if params.get("collapsed"):
                return (200, "text/plain",
                        aggregate_profile_collapsed().encode())
            doc = aggregate_profile(
                include_samples=bool(params.get("samples")))
            return 200, "application/json", json.dumps(doc).encode()
        if route in ("/debug/waterfall", "/debug/waterfall/"):
            doc = aggregate_waterfall()
            if params.get("text"):
                from tpurpc_torch.obs import lens as _lens

                return 200, "text/plain", _lens.render_text(doc).encode()
            return 200, "application/json", json.dumps(doc).encode()
        if route in ("/metrics", "/metrics/"):
            return 200, "text/plain; version=0.0.4", aggregate_metrics().encode()
        if route in ("/debug/flight", "/debug/flight/"):
            try:
                since_ns = int(params.get("since_ns") or 0)
            except ValueError:
                return 400, "text/plain", b"bad since_ns\n"
            if params.get("text"):
                return (200, "text/plain",
                        aggregate_flight_text(since_ns=since_ns).encode())
            return (200, "application/json",
                    json.dumps(aggregate_flight(since_ns=since_ns)).encode())
        if route in ("/debug/slo", "/debug/slo/"):
            return (200, "application/json",
                    json.dumps(aggregate_slo(), indent=1).encode())
        if route in ("/debug/seq", "/debug/seq/"):
            return (200, "application/json",
                    json.dumps(aggregate_seq(), indent=1).encode())
        if route in ("/debug/history", "/debug/history/") \
                and not params.get("series"):
            # a series drill-down (?series=) stays per-worker — points
            # from different registries must not interleave silently
            return (200, "application/json",
                    json.dumps(aggregate_history()).encode())
        if route in ("/debug/stalls", "/debug/stalls/"):
            return (200, "application/json",
                    json.dumps(aggregate_stalls(), indent=1).encode())
        if route in ("/debug/diagnose", "/debug/diagnose/"):
            doc = aggregate_diagnose(params)
            if params.get("text"):
                from tpurpc_torch.obs import diagnose as _diagnose

                return 200, "text/plain", _diagnose.render_text(doc).encode()
            return (200, "application/json",
                    json.dumps(doc, indent=1).encode())
        if route in ("/healthz", "/health"):
            status, body = aggregate_healthz()
            return status, "text/plain", body
    except Exception:
        # an aggregation bug must never take the scrape down: fall back to
        # the local view (the pre-manycore behavior)
        return None
    return None
