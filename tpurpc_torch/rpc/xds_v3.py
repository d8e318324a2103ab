"""Envoy xDS v3 ADS wire codec — the REAL protocol for EDS.

The ADS-lite wire speaks a custom JSON control-plane protocol; a stock
control plane (go-control-plane, Istio) could not serve it. This module
adds the actual v3 surface for the one resource type tpurpc consumes —
cluster load assignments (EDS) — in the same hand-rolled-codec style the
repo already proved against real protobuf for grpc.lb.v1
(:mod:`tpurpc_torch.rpc.lb_v1`, validated in ``tests/test_lookaside.py``).

Wire shape (gRPC's ``src/core/ext/filters/client_channel/resolver/xds/``
consumes the same stream through its XdsClient):

    /envoy.service.discovery.v3.AggregatedDiscoveryService/
        StreamAggregatedResources            (bidi)

    DiscoveryRequest  { string version_info = 1; Node node = 2;
                        repeated string resource_names = 3;
                        string type_url = 4; string response_nonce = 5; }
    Node              { string id = 1; string cluster = 2;
                        string user_agent_name = 6; }
    DiscoveryResponse { string version_info = 1;
                        repeated google.protobuf.Any resources = 2;
                        string type_url = 4; string nonce = 5; }
    Any               { string type_url = 1; bytes value = 2; }

    ClusterLoadAssignment (envoy.config.endpoint.v3) {
        string cluster_name = 1;
        repeated LocalityLbEndpoints endpoints = 2; }
    LocalityLbEndpoints { repeated LbEndpoint lb_endpoints = 2;
                          uint32 priority = 5; }
    LbEndpoint  { Endpoint endpoint = 1; HealthStatus health_status = 2; }
    Endpoint    { Address address = 1; }
    Address     { SocketAddress socket_address = 1; }
    SocketAddress { string address = 2; uint32 port_value = 3; }

Unknown fields are skipped everywhere (proto3 semantics), so responses
from real control planes — which populate far more of these messages —
decode fine. LDS/RDS/CDS and the c2p resolver stay scoped out: this is
the EDS endpoint-feed, the piece tpurpc's channel
actually consumes via ``update_addresses``.

The ACK protocol (XdsWatcher._run_v3): every DECODABLE DiscoveryResponse
is answered with a DiscoveryRequest echoing ``version_info`` +
``response_nonce`` — even when its assignment is unusable, so an
ACK-gated control plane never stalls. A response that does not decode at
all is skipped without ACK (its nonce is unreadable, so a NACK is not
possible either); NACK-with-error_detail is not implemented.

A copy of ``tpurpc/rpc/xds_v3.py``; every encoder's output is the
reference's, byte for byte.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from tpurpc_torch.wire.protowire import fields, ld, vf

SERVICE = "envoy.service.discovery.v3.AggregatedDiscoveryService"
METHOD = f"/{SERVICE}/StreamAggregatedResources"
CLA_TYPE_URL = ("type.googleapis.com/"
                "envoy.config.endpoint.v3.ClusterLoadAssignment")

#: HealthStatus values that mean "dial this" (UNKNOWN=0 and HEALTHY=1 —
#: envoy treats UNKNOWN as healthy; everything else is excluded)
_DIALABLE_HEALTH = (0, 1)


def _s(field_no: int, text: str) -> bytes:
    return ld(field_no, text.encode()) if text else b""


# -- DiscoveryRequest ---------------------------------------------------------

def encode_discovery_request(resource_names: Sequence[str],
                             type_url: str = CLA_TYPE_URL,
                             version_info: str = "",
                             response_nonce: str = "",
                             node_id: str = "",
                             node_cluster: str = "") -> bytes:
    node = _s(1, node_id) + _s(2, node_cluster) + _s(6, "tpurpc")
    out = _s(1, version_info)
    if node:
        out += ld(2, node)
    for name in resource_names:
        out += ld(3, name.encode())
    out += _s(4, type_url) + _s(5, response_nonce)
    return out


def decode_discovery_request(buf) -> dict:
    """{"version_info", "resource_names", "type_url", "response_nonce",
    "node_id"} — the control-plane side's view of a subscribe/ACK."""
    out = {"version_info": "", "resource_names": [], "type_url": "",
           "response_nonce": "", "node_id": ""}
    for fno, wt, val in fields(bytes(buf)):
        if wt != 2:
            continue
        if fno == 1:
            out["version_info"] = val.decode("utf-8", "replace")
        elif fno == 2:
            for nfno, nwt, nval in fields(val):
                if nfno == 1 and nwt == 2:
                    out["node_id"] = nval.decode("utf-8", "replace")
        elif fno == 3:
            out["resource_names"].append(val.decode("utf-8", "replace"))
        elif fno == 4:
            out["type_url"] = val.decode("utf-8", "replace")
        elif fno == 5:
            out["response_nonce"] = val.decode("utf-8", "replace")
    return out


# -- ClusterLoadAssignment ----------------------------------------------------

def encode_cluster_load_assignment(cluster_name: str,
                                   endpoints: Sequence[str],
                                   priority: int = 0) -> bytes:
    """One locality holding every endpoint (the common flat case a test
    control plane emits; real planes shard by locality and the decoder
    flattens them back). Unparsable "host:port" strings are SKIPPED (the
    lb_v1 encoder's rule): a control plane crashing its own push stream
    on one malformed assignment entry would wedge every subscriber."""
    lb_eps = b""
    for addr in endpoints:
        host, _, port_s = addr.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            continue  # no/garbage port: SocketAddress cannot carry it
        if not host:
            continue
        sock = _s(2, host.strip("[]")) + vf(3, port)
        lb_eps += ld(2, ld(1, ld(1, ld(1, sock))))
    locality = lb_eps + vf(5, priority)
    return _s(1, cluster_name) + ld(2, locality)


def decode_cluster_load_assignment(buf) -> Tuple[str, List[str]]:
    """→ (cluster_name, ["host:port", ...]) across ALL localities, ordered
    by priority (stable within a locality), unhealthy endpoints excluded."""
    cluster = ""
    localities: List[Tuple[int, List[str]]] = []
    for fno, wt, val in fields(bytes(buf)):
        if fno == 1 and wt == 2:
            cluster = val.decode("utf-8", "replace")
        elif fno == 2 and wt == 2:
            prio = 0
            addrs: List[str] = []
            for lfno, lwt, lval in fields(val):
                if lfno == 5 and lwt == 0:
                    prio = lval
                elif lfno == 2 and lwt == 2:  # LbEndpoint
                    health = 0
                    hostport = None
                    for efno, ewt, eval_ in fields(lval):
                        if efno == 2 and ewt == 0:
                            health = eval_
                        elif efno == 1 and ewt == 2:  # Endpoint
                            for afno, awt, aval in fields(eval_):
                                if afno == 1 and awt == 2:  # Address
                                    hostport = _decode_address(aval)
                    if hostport and health in _DIALABLE_HEALTH:
                        addrs.append(hostport)
            localities.append((prio, addrs))
    localities.sort(key=lambda t: t[0])
    flat: List[str] = []
    for _, addrs in localities:
        flat.extend(addrs)
    return cluster, flat


def _decode_address(buf) -> Optional[str]:
    for fno, wt, val in fields(buf):
        if fno == 1 and wt == 2:  # SocketAddress
            host = ""
            port = 0
            for sfno, swt, sval in fields(val):
                if sfno == 2 and swt == 2:
                    host = sval.decode("utf-8", "replace")
                elif sfno == 3 and swt == 0:
                    port = sval
            if host:
                return f"[{host}]:{port}" if ":" in host else f"{host}:{port}"
    return None


# -- DiscoveryResponse --------------------------------------------------------

def encode_discovery_response(assignments: Sequence[Tuple[str,
                                                          Sequence[str]]],
                              version_info: str, nonce: str) -> bytes:
    out = _s(1, version_info)
    for cluster, endpoints in assignments:
        cla = encode_cluster_load_assignment(cluster, endpoints)
        out += ld(2, _s(1, CLA_TYPE_URL) + ld(2, cla))
    out += _s(4, CLA_TYPE_URL) + _s(5, nonce)
    return out


def decode_discovery_response(buf) -> dict:
    """{"version_info", "nonce", "type_url",
    "assignments": {cluster: [addr, ...]}} — non-CLA resources skipped."""
    out = {"version_info": "", "nonce": "", "type_url": "",
           "assignments": {}}
    for fno, wt, val in fields(bytes(buf)):
        if wt != 2:
            continue
        if fno == 1:
            out["version_info"] = val.decode("utf-8", "replace")
        elif fno == 4:
            out["type_url"] = val.decode("utf-8", "replace")
        elif fno == 5:
            out["nonce"] = val.decode("utf-8", "replace")
        elif fno == 2:  # Any
            a_type = ""
            a_val = b""
            for afno, awt, aval in fields(val):
                if afno == 1 and awt == 2:
                    a_type = aval.decode("utf-8", "replace")
                elif afno == 2 and awt == 2:
                    a_val = aval
            if a_type == CLA_TYPE_URL:
                cluster, addrs = decode_cluster_load_assignment(a_val)
                if cluster:
                    out["assignments"][cluster] = addrs
    return out


__all__ = ["SERVICE", "METHOD", "CLA_TYPE_URL",
           "encode_discovery_request", "decode_discovery_request",
           "encode_cluster_load_assignment",
           "decode_cluster_load_assignment",
           "encode_discovery_response", "decode_discovery_response"]
