"""xDS: an xds resolver + EDS endpoint discovery over the real ADS wire.

The reference carries the xDS client_channel family — the ``xds:`` resolver
(``ext/filters/client_channel/resolver/xds/xds_resolver.cc``), the xds LB
policies (``lb_policy/xds/{cds,eds}.cc``) and the google-c2p variant — as
inherited inventory (SURVEY.md §2.4). This module is tpurpc's analog: the
gRPC xds UX (bootstrap file + ``xds:///service`` targets + dynamic
endpoint updates into the channel's composition tree), speaking the REAL
v3 ADS protobuf stream for EDS
(``AggregatedDiscoveryService/StreamAggregatedResources`` carrying
``ClusterLoadAssignment``, hand-rolled codec in
:mod:`tpurpc_torch.rpc.xds_v3`), so a stock control plane can feed endpoints.
LDS/RDS/CDS and the google-c2p resolver remain scoped out (ecosystem
surface); the legacy ADS-lite JSON wire stays available behind bootstrap
``server_features: ["ads_lite"]``.

Pieces (mirroring how gRPC's pieces fit):

* **Bootstrap** — ``GRPC_XDS_BOOTSTRAP`` (a JSON file path) or
  ``GRPC_XDS_BOOTSTRAP_CONFIG`` (inline JSON), the real gRPC knobs:
  ``{"xds_servers": [{"server_uri": "host:port"}], "node": {"id": ...}}``.
* **``xds:`` resolver** — registered into the channel's resolver registry
  (``register_resolver``, the fake-resolver seam): ``xds:///service``
  dials the bootstrap server and returns the service's CURRENT endpoint
  list — so a plain ``Channel("xds:///service")`` works with a static
  snapshot, grpcio-style.
* **:class:`XdsServicer`** — the control plane: per-service endpoint
  sets pushed to subscribers (``set_endpoints`` = the EDS
  ClusterLoadAssignment update). Attach to any tpurpc server.
* **:class:`XdsWatcher`** — the dynamic half: subscribes on the ADS-lite
  stream and feeds every update into ``Channel.update_addresses`` (the
  eds policy's job in the reference).
* **:func:`xds_channel`** — the one-call UX: bootstrap + first snapshot +
  watcher, returning a channel whose membership tracks the control plane.

Wire (ADS-lite): bidi stream ``/tpurpc.xds.v1.Ads/Stream``; the client
opens with ``{"node": {...}, "resource": "<service>"}`` (JSON) and
receives ``{"version": N, "endpoints": ["host:port", ...]}`` — the
current assignment immediately, then one message per change.

A copy of ``tpurpc/rpc/xds.py``: the same wires, method names and bytes,
so either package's watcher follows either package's control plane. The
``xds`` scheme goes into the port's own resolver registry
(``tpurpc_torch/rpc/resolver.py``) when this module is first imported, and
stays there. The v3 push loop is the reference's to the line, its 1 s
wait included: a resubscription on a live stream is pushed when that wait
runs out, not when the reader sees it (the wait's predicate reads only
``_version``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence

from tpurpc_torch.analysis.locks import make_condition

METHOD = "/tpurpc.xds.v1.Ads/Stream"


# -- bootstrap ---------------------------------------------------------------

def load_bootstrap() -> dict:
    """The gRPC bootstrap contract: file via GRPC_XDS_BOOTSTRAP, inline
    via GRPC_XDS_BOOTSTRAP_CONFIG (file wins, like gRPC)."""
    path = os.environ.get("GRPC_XDS_BOOTSTRAP")
    raw: Optional[str] = None
    if path:
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read()
    else:
        raw = os.environ.get("GRPC_XDS_BOOTSTRAP_CONFIG")
    if not raw:
        raise RuntimeError(
            "xds: target needs a bootstrap: set GRPC_XDS_BOOTSTRAP to a "
            "JSON file or GRPC_XDS_BOOTSTRAP_CONFIG to inline JSON")
    cfg = json.loads(raw)
    servers = cfg.get("xds_servers") or []
    if not servers or "server_uri" not in servers[0]:
        raise RuntimeError("xds bootstrap needs xds_servers[0].server_uri")
    return cfg


def _server_uri(cfg: dict) -> str:
    return cfg["xds_servers"][0]["server_uri"]


# -- control plane -----------------------------------------------------------

class XdsServicer:
    """ADS-lite control plane: per-service endpoint assignments, pushed.

    ``set_endpoints(service, ["h:p", ...])`` is the EDS update; every
    subscriber of that service receives the new assignment immediately,
    and a fresh subscriber gets the current one on subscribe."""

    #: lock map: which lock guards each field
    _GUARDED_BY = {"_assignments": "_lock", "_version": "_lock"}

    def __init__(self):
        self._lock = make_condition("XdsServicer._lock")
        self._assignments: Dict[str, List[str]] = {}
        self._version = 0

    def set_endpoints(self, service: str, endpoints: Sequence[str]) -> None:
        with self._lock:
            self._assignments[service] = list(endpoints)
            self._version += 1
            self._lock.notify_all()

    def get_endpoints(self, service: str) -> List[str]:
        with self._lock:
            return list(self._assignments.get(service, []))

    def _stream(self, request_iterator, ctx):
        first = next(iter(request_iterator), None)
        if first is None:
            return
        try:
            sub = json.loads(bytes(first).decode())
            resource = sub["resource"]
        except (ValueError, KeyError):
            from tpurpc_torch.rpc.status import AbortError, StatusCode

            raise AbortError(StatusCode.INVALID_ARGUMENT,
                             "ADS stream must open with "
                             '{"resource": "<service>"}') from None
        last_sent: Optional[List[str]] = None
        while ctx.is_active():
            with self._lock:
                current = list(self._assignments.get(resource, []))
                version = self._version
                if current == last_sent:
                    self._lock.wait_for(lambda: self._version != version,
                                        timeout=1.0)
                    continue
            last_sent = current
            yield json.dumps({"version": version,
                              "endpoints": current}).encode()

    def _stream_v3(self, request_iterator, ctx):
        """The REAL wire: v3 ADS ``StreamAggregatedResources``.
        Subscribes are DiscoveryRequests (hand-rolled
        codec, :mod:`tpurpc_torch.rpc.xds_v3` — the lb_v1 pattern); pushes are
        DiscoveryResponses carrying ClusterLoadAssignment Anys. A reader
        thread drains ACKs/resubscriptions so the push loop never blocks
        on the request side (real clients ACK every response)."""
        from tpurpc_torch.rpc import xds_v3

        subscribed: List[str] = []
        sub_changed = threading.Event()
        req_iter = iter(request_iterator)
        first = next(req_iter, None)
        if first is None:
            return
        req = xds_v3.decode_discovery_request(first)
        if req["type_url"] not in ("", xds_v3.CLA_TYPE_URL):
            from tpurpc_torch.rpc.status import AbortError, StatusCode

            raise AbortError(
                StatusCode.UNIMPLEMENTED,
                f"only {xds_v3.CLA_TYPE_URL} is served") from None
        subscribed = req["resource_names"]

        def drain_requests():
            # ACKs and resubscriptions; a resource_names change re-arms
            # the push loop (the A* protocols allow re-subscribing on the
            # same stream). The mutation, the flag, and the wakeup are ONE
            # critical section with the push loop's snapshot+clear — a
            # resubscription can land entirely before or entirely after a
            # snapshot, never half inside it (the unlocked
            # mutation relied on the 1 s wait timeout to be observed).
            for raw in req_iter:
                upd = xds_v3.decode_discovery_request(raw)
                if not upd["resource_names"]:
                    continue
                with self._lock:
                    # the compare must sit INSIDE the critical section too:
                    # comparing against `subscribed` unlocked reads the list
                    # while the push loop's snapshot may observe it — the
                    # residual window of the first fix
                    if upd["resource_names"] != subscribed:
                        subscribed[:] = upd["resource_names"]
                        sub_changed.set()
                        self._lock.notify_all()

        threading.Thread(target=drain_requests, daemon=True,
                         name="tpurpc-ads-v3-reader").start()
        last_sent: Optional[List[tuple]] = None
        nonce = 0
        while ctx.is_active():
            with self._lock:
                current = [(name, tuple(self._assignments.get(name, [])))
                           for name in subscribed]
                version = self._version
                # Re-check AND clear under the same lock as the snapshot:
                # the snapshot above already reflects any subscription the
                # flag announced (both mutate under self._lock), so clearing
                # here cannot eat a change the snapshot missed; one landing
                # after release simply re-sets the flag for the next lap.
                changed = sub_changed.is_set()
                if changed:
                    sub_changed.clear()
                if current == last_sent and not changed:
                    self._lock.wait_for(lambda: self._version != version,
                                        timeout=1.0)
                    continue
            last_sent = current
            nonce += 1
            yield xds_v3.encode_discovery_response(
                [(name, list(addrs)) for name, addrs in current],
                version_info=str(version), nonce=str(nonce))

    def attach(self, server) -> None:
        from tpurpc_torch.rpc import xds_v3
        from tpurpc_torch.rpc.server import stream_stream_rpc_method_handler

        server.add_method(METHOD,
                          stream_stream_rpc_method_handler(self._stream))
        server.add_method(xds_v3.METHOD,
                          stream_stream_rpc_method_handler(self._stream_v3))


# -- client side -------------------------------------------------------------

def _use_ads_lite(cfg: dict) -> bool:
    """Wire selection from the bootstrap: the REAL v3 ADS protobuf stream
    is the default (a stock control plane can serve it); the legacy JSON
    ADS-lite wire is opt-in via ``server_features: ["ads_lite"]`` (the
    gRPC bootstrap's server_features mechanism, repurposed)."""
    feats = (cfg.get("xds_servers") or [{}])[0].get("server_features", [])
    return "ads_lite" in feats


def _fetch_first(server_uri: str, method: str, sub: bytes, service: str,
                 timeout: float) -> bytes:
    """Shared snapshot-fetch skeleton: open ``method``, send ``sub``, HOLD
    the request side open until the first response lands (a generator that
    returns right after the subscribe half-closes immediately, and a
    strict control plane may treat client half-close as end-of-stream
    before its first push), cancel on every exit path, and
    return the first message's bytes. One copy of this subtle lifecycle
    for both wires."""
    from tpurpc_torch.rpc.channel import Channel

    with Channel(server_uri, connect_timeout=timeout) as ch:
        done = threading.Event()

        def reqs():
            yield sub
            done.wait(timeout)

        call = ch.stream_stream(method)(reqs(), timeout=timeout)
        try:
            first = next(iter(call), None)
        finally:
            done.set()
            try:
                call.cancel()
            except Exception:
                pass
        if first is None:
            raise RuntimeError(
                f"xds server {server_uri} closed the ADS stream without "
                f"an assignment for {service!r}")
        return bytes(first)


def _fetch_snapshot_v3(server_uri: str, service: str, node: dict,
                       timeout: float = 10.0) -> List[str]:
    """One v3 ADS subscribe → first ClusterLoadAssignment → done."""
    from tpurpc_torch.rpc import xds_v3

    sub = xds_v3.encode_discovery_request(
        [service], node_id=str(node.get("id", "")),
        node_cluster=str(node.get("cluster", "")))
    first = _fetch_first(server_uri, xds_v3.METHOD, sub, service, timeout)
    upd = xds_v3.decode_discovery_response(first)
    if service not in upd["assignments"]:
        raise RuntimeError(
            f"ADS response from {server_uri} carries no "
            f"ClusterLoadAssignment for {service!r}")
    return list(upd["assignments"][service])


def _fetch_snapshot(server_uri: str, service: str, node: dict,
                    timeout: float = 10.0) -> List[str]:
    """One subscribe → first assignment → done (the resolver's job).
    Legacy ADS-lite JSON wire (bootstrap ``server_features: ["ads_lite"]``)."""
    sub = json.dumps({"node": node, "resource": service}).encode()
    first = _fetch_first(server_uri, METHOD, sub, service, timeout)
    try:
        return list(json.loads(first.decode())["endpoints"])
    except (ValueError, KeyError) as exc:
        raise RuntimeError(
            f"malformed ADS response from {server_uri}") from exc


def _normalize(endpoints: Sequence[str]) -> list:
    """Endpoint strings → resolved (host, port) tuples, through the SAME
    normalization ``Channel.update_addresses`` applies — hostname
    endpoints must produce identical keys at construction and on every
    update, or the keep-live matching misses and a no-op update tears
    down live connections (channel.py's own warning)."""
    from tpurpc_torch.rpc.resolver import resolve_target

    out = []
    for e in endpoints:
        out.extend(resolve_target(e))
    return out


def _resolve_xds(rest: str):
    """Resolver for ``xds:///service`` (registered below)."""
    service = rest.lstrip("/")
    cfg = load_bootstrap()
    fetch = _fetch_snapshot if _use_ads_lite(cfg) else _fetch_snapshot_v3
    endpoints = fetch(_server_uri(cfg), service, cfg.get("node", {}))
    if not endpoints:
        raise ValueError(f"xds assignment for {service!r} is empty")
    return _normalize(endpoints)


def _install_resolver() -> None:
    from tpurpc_torch.rpc.resolver import register_resolver

    register_resolver("xds", _resolve_xds)


_install_resolver()


class XdsWatcher:
    """Dynamic membership: ADS-lite subscription → update_addresses.

    The eds-policy role (``lb_policy/xds/eds.cc``): every assignment
    change the control plane pushes lands in the channel's composition
    tree via :meth:`Channel.update_addresses` (kept subchannels keep
    their connections). Reconnects with backoff when the control plane
    drops; the channel keeps its LAST applied assignment meanwhile
    (gRPC's xds behavior: no assignment churn on control-plane loss).

    Structurally a sibling of :class:`~tpurpc_torch.rpc.lookaside.
    LookasideWatcher` (same subscribe/stream/apply/backoff skeleton) —
    kept separate because the wires diverge (grpclb speaks
    initial_response + ClientStats load reporting; ADS-lite is
    subscribe→assignments), but fixes to either loop's lifecycle
    handling likely apply to both."""

    def __init__(self, channel, service: str,
                 bootstrap: Optional[dict] = None):
        if getattr(channel, "_addrs", None) is None:
            raise ValueError(
                "xds watching needs a target-built channel "
                "(endpoint_factory channels have fixed membership)")
        self._channel = channel
        self._service = service
        self._cfg = bootstrap or load_bootstrap()
        self._stop = threading.Event()
        #: last NORMALIZED assignment applied (seeded from the channel's
        #: current membership): identical pushes — including the control
        #: plane's initial resend of the snapshot the resolver already
        #: fetched — are skipped, so a static assignment never churns the
        #: LB policy or disqualifies the channel's native fast path
        self._last_applied = list(channel._addrs)
        self.applied_versions: List[int] = []  # observability/test seam
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpurpc-xds")
        self._thread.start()

    def _run(self) -> None:
        run = (self._run_lite if _use_ads_lite(self._cfg)
               else self._run_v3)
        uri = _server_uri(self._cfg)
        backoff = 0.2
        while not self._stop.is_set():
            # _healthy: the stream delivered at least one response this
            # connection — reset the reconnect backoff EVEN when the stream
            # later dies by exception (a plane that served for hours then
            # dropped deserves a fast re-dial, not the escalated backoff)
            self._healthy = False
            try:
                run(uri)
            except Exception:
                if self._stop.is_set():
                    return
            if self._healthy:
                backoff = 0.2
            if self._stop.wait(backoff):
                return
            backoff = min(backoff * 2, 5.0)

    def _apply(self, endpoints, version: int) -> None:
        """One keep-the-last-good application unit: normalization may
        raise (bad host:port strings) and must NOT tear the stream down —
        a control plane resending one malformed assignment must not put
        the watcher in a reconnect loop."""
        try:
            addrs = _normalize(list(endpoints))
        except (ValueError, KeyError):
            return
        if addrs and addrs != self._last_applied:
            self._channel.update_addresses(addrs)
            self._last_applied = addrs
            self.applied_versions.append(version)

    def _run_v3(self, uri: str) -> None:
        """The real wire: v3 ADS subscribe → responses → ACK each one
        (version_info + response_nonce echoed, the A* protocols' ACK
        contract) → apply assignments. A response that does not DECODE at
        all is skipped without ACK (its nonce is unreadable, so no NACK is
        possible either); a decodable response is always ACKed, even when
        its assignment is unusable — keep-the-last-good without stalling
        an ACK-gated control plane."""
        import queue as _queue

        from tpurpc_torch.rpc import xds_v3
        from tpurpc_torch.rpc.channel import Channel

        node = self._cfg.get("node", {})
        node_id = str(node.get("id", ""))
        with Channel(uri, connect_timeout=10.0) as bch:
            self._bch = bch  # stop() closes it to unblock the recv
            acks: "_queue.Queue[bytes]" = _queue.Queue()

            def reqs():
                yield xds_v3.encode_discovery_request(
                    [self._service], node_id=node_id,
                    node_cluster=str(node.get("cluster", "")))
                while not self._stop.is_set():
                    try:
                        yield acks.get(timeout=0.2)
                    except _queue.Empty:
                        continue

            for msg in bch.stream_stream(xds_v3.METHOD)(reqs(),
                                                        timeout=None):
                if self._stop.is_set():
                    return
                self._healthy = True
                try:
                    upd = xds_v3.decode_discovery_response(bytes(msg))
                except ValueError:
                    continue  # undecodable: no nonce to ACK/NACK with
                acks.put(xds_v3.encode_discovery_request(
                    [self._service], version_info=upd["version_info"],
                    response_nonce=upd["nonce"], node_id=node_id))
                if self._service in upd["assignments"]:
                    try:
                        version = int(upd["version_info"])
                    except ValueError:
                        version = -1
                    self._apply(upd["assignments"][self._service], version)

    def _run_lite(self, uri: str) -> None:
        """Legacy ADS-lite JSON wire (bootstrap server_features
        ["ads_lite"])."""
        from tpurpc_torch.rpc.channel import Channel

        node = self._cfg.get("node", {})
        with Channel(uri, connect_timeout=10.0) as bch:
            self._bch = bch  # stop() closes it to unblock the recv
            sub = json.dumps({"node": node,
                              "resource": self._service}).encode()

            def reqs():
                yield sub
                while not self._stop.wait(0.2):
                    pass

            for msg in bch.stream_stream(METHOD)(reqs(), timeout=None):
                if self._stop.is_set():
                    return
                self._healthy = True  # resets backoff even if we die later
                try:
                    upd = json.loads(bytes(msg).decode())
                    endpoints = list(upd["endpoints"])
                    version = int(upd.get("version", -1))
                except (ValueError, KeyError):
                    continue  # malformed push (incl. version): keep last good
                self._apply(endpoints, version)

    def stop(self) -> None:
        self._stop.set()
        bch = getattr(self, "_bch", None)
        if bch is not None:
            try:
                bch.close()
            except Exception:
                pass
        self._thread.join(timeout=5)


def xds_channel(target: str, bootstrap: Optional[dict] = None, **channel_kw):
    """``xds:///service`` → a channel whose membership tracks the control
    plane. Returns ``(channel, watcher)``; stop the watcher before (or
    with) closing the channel."""
    if not target.startswith("xds:"):
        raise ValueError(f"not an xds target: {target!r}")
    from tpurpc_torch.rpc.channel import Channel

    service = target[4:].lstrip("/")
    cfg = bootstrap or load_bootstrap()
    fetch = _fetch_snapshot if _use_ads_lite(cfg) else _fetch_snapshot_v3
    endpoints = fetch(_server_uri(cfg), service, cfg.get("node", {}))
    if not endpoints:
        raise ValueError(f"xds assignment for {service!r} is empty")
    addrs = _normalize(endpoints)  # same keys update_addresses will produce
    ch = Channel("ipv4:" + ",".join(f"{h}:{p}" for h, p in addrs),
                 lb_policy=channel_kw.pop("lb_policy", "round_robin"),
                 **channel_kw)
    watcher = XdsWatcher(ch, service, bootstrap=cfg)
    return ch, watcher
