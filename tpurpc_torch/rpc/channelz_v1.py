"""grpc.channelz.v1 wire-compatible service — the standard introspection
protocol (proto at ``src/proto/grpc/channelz/channelz.proto``). A copy of
``tpurpc/rpc/channelz_v1.py``, hand-rolled over
:mod:`tpurpc_torch.wire.protowire` like health and reflection, covering the
subset debugging tools actually walk:

    GetServers / GetServer           (ServerRef + ServerData counters +
                                      listen SocketRefs)
    GetTopChannels / GetChannel      (ChannelRef + ChannelData: state,
                                      target, call counters)
    GetServerSockets / GetSocket     (live connections: SocketRef per
                                      connection; SocketData streams_started
                                      + local/remote TcpIpAddress)

Pagination follows the proto contract: requests carry ``start_*_id`` and
``max_results``; responses list id-ordered entities and set ``end`` when
the page reaches the registry's end. The richer JSON snapshot
stays at ``/tpurpc.Channelz/Get``
(:func:`tpurpc_torch.rpc.channelz.add_channelz_service`).
"""

from __future__ import annotations

from tpurpc_torch.rpc import channelz as _cz
from tpurpc_torch.rpc.server import Server, unary_unary_rpc_method_handler
from tpurpc_torch.rpc.status import AbortError, StatusCode
from tpurpc_torch.wire.protowire import fields, ld, vf

SERVICE = "grpc.channelz.v1.Channelz"

# ChannelConnectivityState.State enum values (channelz.proto:
# UNKNOWN=0, IDLE=1, CONNECTING=2, READY=3, TRANSIENT_FAILURE=4, SHUTDOWN=5)
_STATE_IDLE = 1
_STATE_READY = 3
_STATE_TRANSIENT_FAILURE = 4
_STATE_SHUTDOWN = 5

_MAX_PAGE = 100


def _timestamp(unix_s: float) -> bytes:
    if not unix_s:
        return b""
    sec = int(unix_s)
    nanos = int((unix_s - sec) * 1e9)
    return vf(1, sec) + vf(2, nanos)


def _server_msg(sid: int, srv) -> bytes:
    ref = vf(1, sid) + ld(2, b"tpurpc.Server")
    counters = getattr(srv, "call_counters", None)
    data = b""
    if counters is not None:
        data += vf(2, counters.started) + vf(3, counters.succeeded)
        data += vf(4, counters.failed)
        ts = _timestamp(counters.last_call_started)
        if ts:
            data += ld(5, ts)
    out = ld(1, ref) + ld(2, data)
    for port in getattr(srv, "bound_ports", []):
        # SocketRef{socket_id, name}: ids come from the SAME entity-id
        # space as servers/channels (channelz requires global uniqueness —
        # a raw port number would collide with entity ids)
        out += ld(3, vf(1, _cz.socket_id_for(srv, port))
                  + ld(2, f"listen:{port}".encode()))
    return out


def _channel_state(ch) -> int:
    if ch._is_closed():
        return _STATE_SHUTDOWN
    subs = getattr(ch, "_subchannels", [])
    live = [s._conn for s in subs if s._conn is not None and s._conn.alive]
    return _STATE_READY if live else _STATE_IDLE


def _channel_msg(cid: int, ch) -> bytes:
    ref = vf(1, cid) + ld(2, b"tpurpc.Channel")
    data = ld(1, vf(1, _channel_state(ch)))  # ChannelConnectivityState
    addrs = getattr(ch, "_addrs", None)
    if addrs:
        target = ",".join(f"{h}:{p}" for h, p in addrs)
        data += ld(2, target.encode())
    counters = getattr(ch, "call_counters", None)
    if counters is not None:
        data += vf(4, counters.started) + vf(5, counters.succeeded)
        data += vf(6, counters.failed)
        ts = _timestamp(counters.last_call_started)
        if ts:
            data += ld(7, ts)
    return ld(1, ref) + ld(2, data)


def _page_params(raw: bytes):
    start, max_results = 0, _MAX_PAGE
    try:
        for f, _w, v in fields(bytes(raw)):
            if f == 1:
                start = int(v)
            elif f == 2:
                max_results = max(1, min(int(v), _MAX_PAGE))
    except ValueError:
        raise AbortError(StatusCode.INVALID_ARGUMENT,
                         "malformed channelz request") from None
    return start, max_results


def _id_param(raw: bytes) -> int:
    try:
        for f, _w, v in fields(bytes(raw)):
            if f == 1:
                return int(v)
    except ValueError:
        pass
    raise AbortError(StatusCode.INVALID_ARGUMENT,
                     "malformed channelz request")


def _get_servers(raw, _ctx) -> bytes:
    start, n = _page_params(raw)
    rows = [(i, s) for i, s in _cz.live_servers() if i >= start]
    out = b"".join(ld(1, _server_msg(i, s)) for i, s in rows[:n])
    if len(rows) <= n:
        out += vf(2, 1)  # end = true
    return out


def _get_top_channels(raw, _ctx) -> bytes:
    start, n = _page_params(raw)
    rows = [(i, c) for i, c in _cz.live_channels() if i >= start]
    out = b"".join(ld(1, _channel_msg(i, c)) for i, c in rows[:n])
    if len(rows) <= n:
        out += vf(2, 1)
    return out


def _get_server(raw, _ctx) -> bytes:
    want = _id_param(raw)
    for i, s in _cz.live_servers():
        if i == want:
            return ld(1, _server_msg(i, s))
    raise AbortError(StatusCode.NOT_FOUND, f"no server with id {want}")


def _get_channel(raw, _ctx) -> bytes:
    want = _id_param(raw)
    for i, c in _cz.live_channels():
        if i == want:
            return ld(1, _channel_msg(i, c))
    raise AbortError(StatusCode.NOT_FOUND, f"no channel with id {want}")


def _conn_name(conn) -> str:
    ep = getattr(conn, "endpoint", None)
    peer = getattr(ep, "peer", "?")
    local = getattr(ep, "local_address", "?")
    return f"{peer} -> {local}"


def _tcpip_address(addr_str: str) -> bytes:
    """'ipv4:1.2.3.4:56' → Address{tcpip_address{ip_address, port}}."""
    import socket as _socket

    try:
        body = addr_str.split(":", 1)[1] if ":" in addr_str else addr_str
        host, _, port_s = body.rpartition(":")
        packed = _socket.inet_aton(host)
        return ld(1, ld(1, packed) + vf(2, int(port_s)))
    except (OSError, ValueError, IndexError):
        return b""


def _socket_msg(sid: int, conn) -> bytes:
    ref = vf(1, sid) + ld(2, _conn_name(conn).encode())
    data = vf(1, getattr(conn, "streams_started", 0))
    ep = getattr(conn, "endpoint", None)
    out = ld(1, ref) + ld(2, data)
    local = _tcpip_address(getattr(ep, "local_address", "") or "")
    remote = _tcpip_address(getattr(ep, "peer", "") or "")
    if local:
        out += ld(3, local)
    if remote:
        out += ld(4, remote)
    return out


def _get_server_sockets(raw, _ctx) -> bytes:
    # GetServerSocketsRequest: server_id=1, start_socket_id=2, max_results=3
    want, start, limit = 0, 0, _MAX_PAGE
    try:
        for f, _w, v in fields(bytes(raw)):
            if f == 1:
                want = int(v)
            elif f == 2:
                start = int(v)
            elif f == 3:
                limit = max(1, min(int(v), _MAX_PAGE))
    except ValueError:
        raise AbortError(StatusCode.INVALID_ARGUMENT,
                         "malformed channelz request") from None
    for i, s in _cz.live_servers():
        if i == want:
            rows = sorted(
                (_cz.socket_id_for(conn, 0), conn)
                for conn in list(getattr(s, "_connections", [])))
            rows = [(sid, c) for sid, c in rows if sid >= start]
            out = b"".join(
                ld(1, vf(1, sid) + ld(2, _conn_name(c).encode()))
                for sid, c in rows[:limit])
            if len(rows) <= limit:
                out += vf(2, 1)  # end = true
            return out
    raise AbortError(StatusCode.NOT_FOUND, f"no server with id {want}")


def _listen_socket_msg(sid: int, srv, port: int) -> bytes:
    ref = vf(1, sid) + ld(2, f"listen:{port}".encode())
    return ld(1, ref) + ld(2, b"")  # a listen socket carries no stream data


def _get_socket(raw, _ctx) -> bytes:
    want = _id_param(raw)
    for _i, s in _cz.live_servers():
        for conn in list(getattr(s, "_connections", [])):
            if _cz.socket_id_for(conn, 0) == want:
                return ld(1, _socket_msg(want, conn))
        # listen sockets: the ids GetServer advertises must resolve too
        for port in getattr(s, "bound_ports", []):
            if _cz.socket_id_for(s, port) == want:
                return ld(1, _listen_socket_msg(want, s, port))
    raise AbortError(StatusCode.NOT_FOUND, f"no socket with id {want}")


def enable_channelz(server: Server) -> None:
    """Serve grpc.channelz.v1 on this server (wire-compatible subset)."""
    for name, fn in (("GetServers", _get_servers),
                     ("GetTopChannels", _get_top_channels),
                     ("GetServer", _get_server),
                     ("GetChannel", _get_channel),
                     ("GetServerSockets", _get_server_sockets),
                     ("GetSocket", _get_socket)):
        server.add_method(f"/{SERVICE}/{name}",
                          unary_unary_rpc_method_handler(fn))
