"""Look-aside load balancing — the grpclb capability, tpurpc-shaped.

The reference ships ``lb_policy/grpclb/grpclb.cc``: the channel opens a
stream to a BALANCER service, receives ServerList updates, directs RPCs at
the listed backends, and falls back to its resolver-provided addresses if
the balancer is unreachable (fallback timer). This module is that control
loop over tpurpc's own streaming RPC + :meth:`Channel.update_addresses`:

server side::

    balancer = LoadBalancerServicer()
    balancer.attach(admin_server)                 # serves /tpurpc.lb.v1.*
    balancer.set_servers("inventory", ["10.0.0.5:50051", "10.0.0.6:50051"])

client side::

    ch = rpc.Channel("fallback-host:50051", lb_policy="round_robin")
    watcher = enable_lookaside(ch, "balancer-host:9000", name="inventory")
    ...                                            # calls rebalance live
    watcher.stop()

Two wire formats. Native: JSON bodies on ``/tpurpc.lb.v1.LoadBalancer/
BalanceLoad`` (request ``{"name": ...}``, responses ``{"servers":
["h:p", ...]}``). Standard: the grpc.lb.v1 protobuf stream
(:mod:`tpurpc_torch.rpc.lb_v1`) — ``attach`` serves both, and
``enable_lookaside(..., wire="grpclb")`` consumes a stock balancer.

A copy of ``tpurpc/rpc/lookaside.py``, with the same method names and
bytes on both wires, so either package's watcher follows either package's
balancer. Its ``lookaside`` trace flag sits in the port's own registry
(``tpurpc_torch/utils/trace.py``).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Sequence

from tpurpc_torch.rpc.status import RpcError
from tpurpc_torch.utils.trace import TraceFlag

trace_lb = TraceFlag("lookaside")

SERVICE = "tpurpc.lb.v1.LoadBalancer"
METHOD = f"/{SERVICE}/BalanceLoad"


class LoadBalancerServicer:
    """Balancer service: per-name server lists, pushed to subscribers.

    ``set_servers(name, addrs)`` updates a list and wakes every watcher
    stream; each stream immediately receives the current list on
    subscribe (grpclb's initial ServerList)."""

    def __init__(self, stats_interval_s: float = 0.0):
        self._lock = threading.Condition()
        self._lists: Dict[str, List[str]] = {}
        self._epoch = 0
        #: >0 asks grpc.lb.v1 subscribers to stream ClientStats load
        #: reports on this cadence (the grpclb load-reporting loop)
        self._stats_interval_s = stats_interval_s
        self._client_stats: Dict[str, Dict[str, int]] = {}

    def stats(self, name: str) -> Dict[str, int]:
        """Accumulated ClientStats deltas reported by grpc.lb.v1
        subscribers of ``name`` (empty until a report arrives)."""
        with self._lock:
            return dict(self._client_stats.get(name, {}))

    def _record_stats(self, name: str, report: Dict[str, int]) -> None:
        with self._lock:
            acc = self._client_stats.setdefault(
                name, {"started": 0, "finished": 0, "known_received": 0})
            for key, val in report.items():
                acc[key] = acc.get(key, 0) + val

    def set_servers(self, name: str, addrs: Sequence[str]) -> None:
        with self._lock:
            self._lists[name] = list(addrs)
            self._epoch += 1
            self._lock.notify_all()

    def _updates(self, name: str, ctx):
        """Yield the current list for ``name``, then every change, until
        the stream dies — shared by both wire formats."""
        last_sent: Optional[List[str]] = None
        while ctx.is_active():
            with self._lock:
                current = list(self._lists.get(name, []))
                epoch = self._epoch
                if current == last_sent:
                    # wait for a change (bounded so ctx liveness re-checks)
                    self._lock.wait_for(lambda: self._epoch != epoch,
                                        timeout=1.0)
                    continue
            last_sent = current
            yield current

    def _balance_load(self, request_iterator, ctx):
        first = next(iter(request_iterator), None)
        if first is None:
            return
        try:
            name = json.loads(bytes(first).decode())["name"]
        except (ValueError, KeyError):
            from tpurpc_torch.rpc.status import AbortError, StatusCode

            raise AbortError(StatusCode.INVALID_ARGUMENT,
                             "malformed BalanceLoad request") from None
        for current in self._updates(name, ctx):
            yield json.dumps({"servers": current}).encode()

    def _balance_load_v1(self, request_iterator, ctx):
        """The stock grpc.lb.v1 wire (tpurpc_torch.rpc.lb_v1): initial_response
        first (optionally requesting ClientStats reports), then a
        ServerList per change — what a stock grpclb client expects from
        its balancer. Incoming ClientStats are drained on a side thread
        (the update loop must not block on a quiet client)."""
        from tpurpc_torch.rpc import lb_v1

        it = iter(request_iterator)
        first = next(it, None)
        if first is None:
            return
        try:
            name = lb_v1.decode_request(first)
        except ValueError:  # malformed protobuf, not a handler bug
            name = None
        if name is None:
            from tpurpc_torch.rpc.status import AbortError, StatusCode

            raise AbortError(StatusCode.INVALID_ARGUMENT,
                             "BalanceLoad stream must open with "
                             "initial_request") from None

        def drain_reports():
            for msg in it:
                try:
                    report = lb_v1.decode_client_stats(msg)
                except ValueError:
                    continue
                if report:
                    self._record_stats(name, report)

        threading.Thread(target=drain_reports, daemon=True,
                         name="tpurpc-lb-stats").start()
        yield lb_v1.encode_initial_response(self._stats_interval_s)
        for current in self._updates(name, ctx):
            yield lb_v1.encode_server_list(current)

    def attach(self, server) -> None:
        """Registers BOTH wires: the tpurpc-native JSON method and the
        standard grpc.lb.v1 protobuf method."""
        from tpurpc_torch.rpc import lb_v1
        from tpurpc_torch.rpc.server import stream_stream_rpc_method_handler

        server.add_method(METHOD,
                          stream_stream_rpc_method_handler(self._balance_load))
        server.add_method(
            lb_v1.METHOD,
            stream_stream_rpc_method_handler(self._balance_load_v1))


class LookasideWatcher:
    """The client control loop: subscribe, apply updates, fall back."""

    def __init__(self, channel, balancer_target: str, name: str,
                 fallback_timeout: float = 10.0, wire: str = "tpurpc"):
        if wire not in ("tpurpc", "grpclb"):
            raise ValueError(f"unknown look-aside wire {wire!r} "
                             "(tpurpc | grpclb)")
        self._wire = wire
        if getattr(channel, "_addrs", None) is None:
            # fail fast: endpoint_factory channels have fixed membership;
            # discovering this on the first ServerList would kill the
            # watcher thread silently
            raise ValueError(
                "look-aside balancing needs a target-built channel "
                "(endpoint_factory channels have fixed membership)")
        self._channel = channel
        self._balancer_target = balancer_target
        self._name = name
        self._fallback_timeout = fallback_timeout
        #: the resolver-provided addresses to fall back to (grpclb fallback)
        self._fallback_addrs = list(channel._addrs)
        self._stop = threading.Event()
        self._applied_balancer_list = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpurpc-lookaside")
        self._thread.start()

    def _run(self) -> None:
        from tpurpc_torch.rpc.channel import Channel

        backoff = 0.2
        while not self._stop.is_set():
            try:
                with Channel(self._balancer_target,
                             connect_timeout=self._fallback_timeout) as bch:
                    self._bch = bch  # stop() closes it to unblock the recv
                    if self._wire == "grpclb":
                        from tpurpc_torch.rpc import lb_v1

                        method = lb_v1.METHOD
                        sub = lb_v1.encode_initial_request(self._name)
                    else:
                        method = METHOD
                        sub = json.dumps({"name": self._name}).encode()
                    stream = bch.stream_stream(method)
                    self._stats_interval = 0.0  # set by initial_response

                    def reqs():
                        yield sub
                        # hold the stream open until stop; on the grpclb
                        # wire, stream ClientStats DELTAS whenever the
                        # balancer's initial_response requested a cadence
                        # (grpclb load reporting). Baseline from the
                        # CURRENT counters: a reconnected stream must not
                        # re-report the channel's lifetime totals.
                        cc = self._channel.call_counters
                        last = (cc.started, cc.succeeded + cc.failed,
                                cc.succeeded)
                        next_report: Optional[float] = None
                        while not self._stop.wait(0.2):
                            interval = self._stats_interval
                            if self._wire != "grpclb" or interval <= 0:
                                continue
                            now = time.monotonic()
                            if next_report is None:
                                next_report = now + interval
                            if now < next_report:
                                continue
                            next_report = now + interval
                            from tpurpc_torch.rpc import lb_v1

                            cur = (cc.started, cc.succeeded + cc.failed,
                                   cc.succeeded)
                            delta = tuple(c - l for c, l in zip(cur, last))
                            last = cur
                            # known_received = SUCCEEDED only: failed calls
                            # never reached a server and must read as loss
                            # to a balancer computing finished - received
                            yield lb_v1.encode_client_stats(
                                delta[0], delta[1], delta[2])
                        return

                    for msg in stream(reqs(), timeout=None):
                        if self._stop.is_set():
                            return
                        if self._wire == "grpclb":
                            from tpurpc_torch.rpc import lb_v1

                            try:
                                kind, servers = lb_v1.decode_response(msg)
                            except ValueError:
                                # one bad message must not tear the stream
                                # down (the JSON path skips these too)
                                trace_lb.log("undecodable LoadBalanceResponse"
                                             " skipped")
                                continue
                            if kind == "initial":
                                self._stats_interval = float(servers or 0.0)
                                continue
                            if kind in ("fallback", "unknown"):
                                continue
                        else:
                            try:
                                servers = json.loads(
                                    bytes(msg).decode()).get("servers")
                            except ValueError:
                                servers = None
                        if not servers:
                            trace_lb.log("ignoring malformed/empty "
                                         "ServerList update")
                            continue
                        if servers:
                            trace_lb.log("lookaside %r -> %d servers",
                                         self._name, len(servers))
                            self._channel.update_addresses(servers)
                            self._applied_balancer_list = True
                        backoff = 0.2
            except (RpcError, OSError, ValueError) as exc:
                trace_lb.log("balancer stream failed: %s", exc)
            if self._stop.is_set():
                return
            # balancer unreachable: restore the fallback list once
            # (grpclb fallback-to-resolver rule), then retry with backoff
            if self._applied_balancer_list and self._fallback_addrs:
                try:
                    self._channel.update_addresses(self._fallback_addrs)
                    self._applied_balancer_list = False
                    trace_lb.log("lookaside %r: fell back to resolver list",
                                 self._name)
                except (RpcError, RuntimeError):
                    pass  # channel closing
            if self._stop.wait(backoff):
                return
            backoff = min(backoff * 2, 5.0)

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        bch = getattr(self, "_bch", None)
        if bch is not None:
            try:
                bch.close()  # unblocks a watcher parked in recv
            except Exception:
                pass
        self._thread.join(timeout=timeout)


def enable_lookaside(channel, balancer_target: str, name: str,
                     fallback_timeout: float = 10.0,
                     wire: str = "tpurpc") -> LookasideWatcher:
    """Attach a grpclb-style watcher to ``channel``; returns the watcher
    (call ``stop()`` before closing the channel). ``wire="grpclb"``
    speaks the standard grpc.lb.v1 protobuf stream (stock balancers);
    the default speaks the tpurpc-native JSON protocol."""
    return LookasideWatcher(channel, balancer_target, name,
                            fallback_timeout, wire)
