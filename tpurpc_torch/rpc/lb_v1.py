"""grpc.lb.v1 wire codec — stock grpclb interop for the look-aside LB.

The reference's grpclb policy (``lb_policy/grpclb/grpclb.cc``) speaks the
``grpc.lb.v1.LoadBalancer/BalanceLoad`` bidi stream defined in
``src/proto/grpc/lb/v1/load_balancer.proto``. tpurpc's look-aside module
(:mod:`tpurpc_torch.rpc.lookaside`) carries the same control loop over a
tpurpc-native JSON protocol; this module adds the standard protobuf wire
so stock grpclb clients can subscribe to a tpurpc balancer and a tpurpc
watcher can consume a stock balancer. Hand-rolled field codec in the
style of :mod:`tpurpc_torch.rpc.health` (no generated code needed).

Message subset (fields we produce/consume; unknown fields are skipped):

    LoadBalanceRequest  { InitialLoadBalanceRequest initial_request = 1; }
    InitialLoadBalanceRequest { string name = 1; }
    LoadBalanceResponse { InitialLoadBalanceResponse initial_response = 1;
                          ServerList server_list = 2;
                          FallbackResponse fallback_response = 3; }
    ServerList { repeated Server servers = 1; }
    Server { bytes ip_address = 1;     // 4 or 16 bytes, network order
             int32 port = 2;
             string load_balance_token = 3;
             bool drop = 4; }

grpc.lb.v1 addresses are IPs, not hostnames: list entries that do not
parse as IPv4/IPv6 are skipped on encode (traced), matching what a stock
balancer could legally emit.

A copy of ``tpurpc/rpc/lb_v1.py``; every encoder's output is the
reference's, byte for byte.
"""

from __future__ import annotations

import socket
from typing import List, Optional, Sequence, Tuple

from tpurpc_torch.rpc.lookaside import trace_lb  # one registry slot, one knob
from tpurpc_torch.wire.protowire import fields, ld, vf

SERVICE = "grpc.lb.v1.LoadBalancer"
METHOD = f"/{SERVICE}/BalanceLoad"


def _split_hostport(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host.strip("[]"), int(port)


def encode_initial_request(name: str) -> bytes:
    """LoadBalanceRequest{initial_request{name}} — the subscribe message a
    grpclb client opens the stream with."""
    return ld(1, ld(1, name.encode()))


def decode_request(buf) -> Optional[str]:
    """Returns the subscribed name for an initial_request, None for
    client_stats / unknown (grpclb clients send stats on the same stream;
    a balancer ignores what it doesn't consume)."""
    for fno, wt, val in fields(bytes(buf)):
        if fno == 1 and wt == 2:
            for ifno, iwt, ival in fields(val):
                if ifno == 1 and iwt == 2:
                    return ival.decode("utf-8", "replace")
            return ""  # initial_request with no name: subscribe to default
    return None


def encode_initial_response(report_interval_s: float = 0.0) -> bytes:
    """LoadBalanceResponse{initial_response{...}} — sent once at stream
    start. ``report_interval_s > 0`` asks the client to stream ClientStats
    on that cadence (field 2, a google.protobuf.Duration)."""
    inner = b""
    if report_interval_s > 0:
        secs = int(report_interval_s)
        nanos = int(round((report_interval_s - secs) * 1e9))
        if nanos >= 1_000_000_000:  # round() carry: Duration caps nanos
            secs += 1
            nanos -= 1_000_000_000
        inner = ld(2, vf(1, secs) + vf(2, nanos))
    return ld(1, inner)


def encode_client_stats(started: int, finished: int,
                        known_received: int) -> bytes:
    """LoadBalanceRequest{client_stats} — the load report a grpclb client
    streams back when the balancer requested an interval. Counts are
    DELTAS since the previous report (grpclb accounting)."""
    return ld(2, vf(2, started) + vf(3, finished) + vf(7, known_received))


def decode_client_stats(buf) -> Optional[dict]:
    """Returns {"started", "finished", "known_received"} for a
    client_stats request, else None (initial_request / unknown)."""
    for fno, wt, val in fields(bytes(buf)):
        if fno == 2 and wt == 2:
            out = {"started": 0, "finished": 0, "known_received": 0}
            for sfno, swt, sval in fields(val):
                if swt != 0:
                    continue
                if sfno == 2:
                    out["started"] = sval
                elif sfno == 3:
                    out["finished"] = sval
                elif sfno == 7:
                    out["known_received"] = sval
            return out
    return None


def encode_server_list(addrs: Sequence[str]) -> bytes:
    """LoadBalanceResponse{server_list} from "ip:port" strings."""
    servers = b""
    for addr in addrs:
        try:
            host, port = _split_hostport(addr)
        except ValueError:
            trace_lb.log("grpc.lb.v1: skipping unparsable address %r", addr)
            continue
        packed = None
        for fam in (socket.AF_INET, socket.AF_INET6):
            try:
                packed = socket.inet_pton(fam, host)
                break
            except OSError:
                continue
        if packed is None:
            trace_lb.log("grpc.lb.v1: skipping non-IP address %r "
                         "(the wire carries packed IPs)", addr)
            continue
        servers += ld(1, ld(1, packed) + vf(2, port))
    return ld(2, servers)


def decode_response(buf) -> Tuple[str, object]:
    """Returns ("initial", report_interval_seconds), ("server_list",
    ["ip:port", ...]), ("fallback", None), or ("unknown", None)."""
    for fno, wt, val in fields(bytes(buf)):
        if fno == 1 and wt == 2:
            interval = 0.0
            for ifno, iwt, ival in fields(val):
                if ifno == 2 and iwt == 2:  # Duration{seconds=1, nanos=2}
                    secs = nanos = 0
                    for dfno, dwt, dval in fields(ival):
                        if dfno == 1 and dwt == 0:
                            secs = dval
                        elif dfno == 2 and dwt == 0:
                            nanos = dval
                    interval = secs + nanos / 1e9
            return "initial", interval
        if fno == 3 and wt == 2:
            return "fallback", None
        if fno == 2 and wt == 2:
            out: List[str] = []
            for sfno, swt, sval in fields(val):
                if sfno != 1 or swt != 2:
                    continue
                ip = b""
                port = 0
                drop = False
                for ffno, fwt, fval in fields(sval):
                    if ffno == 1 and fwt == 2:
                        ip = fval
                    elif ffno == 2 and fwt == 0:
                        port = fval
                    elif ffno == 4 and fwt == 0:
                        drop = bool(fval)
                if drop or not ip:
                    continue  # drop-entries steer load shedding, not dialing
                if len(ip) == 4:
                    out.append(f"{socket.inet_ntop(socket.AF_INET, ip)}:{port}")
                elif len(ip) == 16:
                    out.append(
                        f"[{socket.inet_ntop(socket.AF_INET6, ip)}]:{port}")
            return "server_list", out
    return "unknown", None


__all__ = ["SERVICE", "METHOD", "encode_initial_request", "decode_request",
           "encode_initial_response", "encode_server_list",
           "decode_response", "encode_client_stats", "decode_client_stats"]
