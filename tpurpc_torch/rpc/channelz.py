"""channelz-lite: live introspection of servers and channels.

A copy of ``tpurpc/rpc/channelz.py``: gRPC's channelz capability without
the protobuf service wrapper — a process-wide weak registry of servers and
channels, their call counters (:class:`CallCounters`), and JSON-able
snapshots, exposed programmatically and as a bytes RPC method
(:func:`add_channelz_service`). The grpc.channelz.v1 wire service over the
same registry is :mod:`tpurpc_torch.rpc.channelz_v1`.
"""

from __future__ import annotations

import json
import time
import weakref
from typing import Dict

from tpurpc_torch.analysis.locks import make_lock

_lock = make_lock("channelz._lock")
_servers: "weakref.WeakSet" = weakref.WeakSet()
_channels: "weakref.WeakSet" = weakref.WeakSet()


class CallCounters:
    """started/succeeded/failed + last-activity timestamps (channelz core).

    Lock-guarded: one instance is shared by every thread of a channel or
    server, and ``+=`` is a read-modify-write the GIL can split."""

    __slots__ = ("started", "succeeded", "failed", "last_call_started",
                 "_mu")

    #: lock map: which lock guards each field
    _GUARDED_BY = {"started": "_mu", "succeeded": "_mu", "failed": "_mu",
                   "last_call_started": "_mu"}

    def __init__(self):
        self.started = 0
        self.succeeded = 0
        self.failed = 0
        self.last_call_started = 0.0
        self._mu = make_lock("CallCounters._mu")

    def on_start(self) -> None:
        with self._mu:
            self.started += 1
            # channelz REPORTS this as an absolute wall timestamp
            self.last_call_started = time.time()  # tpr: allow(wallclock)

    def on_finish(self, ok: bool) -> None:
        with self._mu:
            if ok:
                self.succeeded += 1
            else:
                self.failed += 1

    def as_dict(self) -> Dict:
        # snapshot under the same lock as the writers: a reader between the
        # started += 1 and the timestamp store would report a call count
        # with the previous call's timestamp (unlocked-snapshot window)
        with self._mu:
            return {"calls_started": self.started,
                    "calls_succeeded": self.succeeded,
                    "calls_failed": self.failed,
                    "last_call_started": self.last_call_started}


_next_id = 0


def _assign_id(obj) -> None:
    global _next_id
    _next_id += 1
    obj._channelz_id = _next_id


def register_server(srv) -> None:
    with _lock:
        _assign_id(srv)
        _servers.add(srv)


def register_channel(ch) -> None:
    with _lock:
        _assign_id(ch)
        _channels.add(ch)


def live_servers():
    """(id, server) pairs, id-ordered (channelz v1 pagination contract)."""
    with _lock:
        return sorted(((s._channelz_id, s) for s in _servers))


def live_channels():
    with _lock:
        return sorted(((c._channelz_id, c) for c in _channels))


def socket_id_for(obj, port: int) -> int:
    """Stable channelz id for a socket-like entity (a server's listen port
    or a live connection), drawn from the same entity-id space as
    servers/channels (global uniqueness contract). The id is stored ON the
    object — it dies with it (a registry keyed by ``id(obj)`` would grow
    forever and alias recycled ids)."""
    global _next_id
    attr = f"_channelz_sock_{port}"
    sid = getattr(obj, attr, None)
    if sid is None:
        with _lock:
            sid = getattr(obj, attr, None)  # double-check under the lock
            if sid is None:
                _next_id += 1
                sid = _next_id
                try:
                    setattr(obj, attr, sid)
                except AttributeError:
                    pass  # __slots__ object: fall back to a fresh id per call
    return sid


def server_info(srv) -> Dict:
    conns = list(getattr(srv, "_connections", []))
    info = {
        "ports": list(getattr(srv, "bound_ports", [])),
        "methods": sorted(srv._methods.keys()),
        "connections": len(conns),
        # connection-management state (keepalive/max_age drain visibility)
        "draining_connections": sum(
            1 for c in conns if getattr(c, "draining", False)),
        "active_streams": sum(len(getattr(c, "_streams", ())) for c in conns),
        "interceptors": len(getattr(srv, "interceptors", [])),
    }
    counters = getattr(srv, "call_counters", None)
    if counters is not None:
        info.update(counters.as_dict())
    return info


def channel_info(ch) -> Dict:
    subs = getattr(ch, "_subchannels", [])
    live = [s._conn for s in subs if s._conn is not None and s._conn.alive]
    return {
        "subchannels": len(subs),
        "connected": len(live),
        "draining": sum(1 for c in live if getattr(c, "draining", False)),
        "active_streams": sum(len(getattr(c, "_streams", ())) for c in live),
        "lb_policy": getattr(getattr(ch, "_policy", None), "name", "?"),
        "closed": ch._is_closed(),
    }


def snapshot() -> Dict:
    with _lock:
        servers = list(_servers)
        channels = list(_channels)
    return {
        "servers": [server_info(s) for s in servers],
        "channels": [channel_info(c) for c in channels],
    }


def add_channelz_service(srv) -> None:
    """Expose the snapshot as ``/tpurpc.Channelz/Get`` (bytes → JSON bytes)."""
    from tpurpc_torch.rpc.server import unary_unary_rpc_method_handler

    srv.add_method(
        "/tpurpc.Channelz/Get",
        unary_unary_rpc_method_handler(
            lambda _req, _ctx: json.dumps(snapshot()).encode()))
