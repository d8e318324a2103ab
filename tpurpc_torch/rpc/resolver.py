"""Name resolution and load-balancing policies for the client channel.

A copy of ``tpurpc/rpc/resolver.py``, with ``least_loaded``'s flight events
(``SUBCH_EJECT``/``SUBCH_REINSTATE`` under ``lb:least_loaded``). The
``xds`` scheme is
registered by ``tpurpc_torch/rpc/xds.py``, imported on the first ``xds:``
target. The
reference inherits these from gRPC's client_channel filter. Same target UX:

* ``"host:port"`` / ``"dns:///host:port"`` → DNS resolution (getaddrinfo)
* ``"ipv4:1.2.3.4:5,6.7.8.9:10"``          → static address list
* ``register_resolver("scheme", fn)``       → the fake-resolver test seam

Policies: ``pick_first`` (dial addresses in order, stick with the winner —
gRPC's default), ``round_robin`` (rotate subchannels per call),
``ring_hash`` (consistent hashing: same calls land on the same backend,
and a dead backend's keys spill to its ring successor only),
``least_loaded`` (load reports piggybacked in trailing metadata drive an
EWMA pick order with outlier ejection of slow or erroring backends), and
the composites ``priority`` and ``weighted_target`` (:func:`make_policy`).
A resolver may deliver a service config with its addresses
(:class:`Resolution`); the channel applies it
(``tpurpc_torch/rpc/service_config.py``).
"""

from __future__ import annotations

import hashlib
import itertools
import socket
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

Address = Tuple[str, int]
ResolveFn = Callable[[str], List[Address]]

_RESOLVERS: dict = {}


class Resolution:
    """One resolver result: addresses plus (optionally) the service config
    the resolver delivers with them — gRPC's resolver-result shape
    (``resolver.h`` Result carries addresses + service_config; the
    client_channel consumes per-method timeout/retry from it,
    ``service_config.cc``). ``service_config`` is the raw JSON dict."""

    __slots__ = ("addresses", "service_config")

    def __init__(self, addresses: List[Address],
                 service_config: "Optional[dict]" = None):
        self.addresses = list(addresses)
        self.service_config = service_config


def register_resolver(scheme: str, fn: ResolveFn) -> None:
    """Register a scheme (the reference's fake resolver seam,
    ``resolver/fake/fake_resolver.cc``). The fn may return a plain address
    list, an ``(addresses, service_config_dict)`` tuple, or a
    :class:`Resolution` — the latter two deliver per-method config with
    the membership, the way gRPC resolvers do."""
    _RESOLVERS[scheme] = fn


def _as_resolution(result) -> Resolution:
    if isinstance(result, Resolution):
        return result
    if (isinstance(result, tuple) and len(result) == 2
            and isinstance(result[1], (dict, type(None)))):
        return Resolution(list(result[0]), result[1])
    return Resolution(list(result), None)


def _parse_hostport(hp: str) -> Address:
    host, _, port_s = hp.rpartition(":")
    if not host or not port_s.isdigit():
        raise ValueError(f"bad address {hp!r} (want host:port)")
    return host, int(port_s)


def _dns_resolve(hostport: str) -> List[Address]:
    host, port = _parse_hostport(hostport)
    try:
        infos = socket.getaddrinfo(host, port, type=socket.SOCK_STREAM)
    except socket.gaierror as exc:
        raise ValueError(f"resolution of {host!r} failed: {exc}") from exc
    seen = []
    for _family, _type, _proto, _canon, sockaddr in infos:
        addr = (sockaddr[0], sockaddr[1])
        if addr not in seen:
            seen.append(addr)
    return seen or [(host, port)]


def resolve_target(target: str) -> List[Address]:
    """gRPC-style target URI → ordered address list."""
    return resolve_target_full(target).addresses


def resolve_target_full(target: str) -> Resolution:
    """gRPC-style target URI → :class:`Resolution` (addresses + any
    service config the scheme's resolver attached)."""
    scheme, sep, rest = target.partition(":")
    if sep and scheme == "xds" and scheme not in _RESOLVERS:
        # lazy: importing the xds module registers its resolver (bootstrap
        # + an ADS snapshot; tpurpc_torch/rpc/xds.py)
        import tpurpc_torch.rpc.xds  # noqa: F401
    if sep and scheme in _RESOLVERS:
        return _as_resolution(_RESOLVERS[scheme](rest.lstrip("/")))
    if target.startswith("dns:"):
        return Resolution(_dns_resolve(target[4:].lstrip("/")))
    if target.startswith("ipv4:") or target.startswith("ipv6:"):
        rest = target.split(":", 1)[1]
        return Resolution([_parse_hostport(a) for a in rest.split(",") if a])
    if target.startswith("static:"):
        return Resolution([_parse_hostport(a)
                           for a in target[7:].split(",") if a])
    return Resolution(_dns_resolve(target))


class PickFirst:
    """Try addresses in order; stick with the first that connects."""

    name = "pick_first"

    def __init__(self, n: int):
        self._n = n
        self._current = 0
        self._lock = threading.Lock()

    def order(self) -> Sequence[int]:
        with self._lock:
            cur = self._current
        return [(cur + i) % self._n for i in range(self._n)]

    def connected(self, idx: int) -> None:
        with self._lock:
            self._current = idx

    def failed(self, idx: int) -> None:
        with self._lock:
            if self._current == idx:
                self._current = (idx + 1) % self._n


class RoundRobin:
    """Rotate across subchannels per call."""

    name = "round_robin"

    def __init__(self, n: int):
        self._n = n
        self._counter = itertools.count()
        self._lock = threading.Lock()

    def order(self) -> Sequence[int]:
        with self._lock:
            start = next(self._counter) % self._n
        return [(start + i) % self._n for i in range(self._n)]

    def connected(self, idx: int) -> None:
        pass

    def failed(self, idx: int) -> None:
        pass


class LeastLoaded:
    """Load-aware picking from ORCA-style per-response load reports (the
    gRPC analog is the xds ``orca_load_report`` consumed by custom LB
    policies).

    Servers piggyback ``tpurpc-load: "<inflight>,<queue_depth>,<p99_ms>"``
    in trailing metadata (see :meth:`tpurpc_torch.rpc.server.Server._load_md`);
    the channel strips it off every response and feeds
    :meth:`load_report`. Pick order sorts subchannels by an EWMA of the
    reported utilization (inflight + queue depth), with a rotating
    tiebreak so equally-loaded backends still round-robin.

    Outlier ejection covers the two degradation modes load alone misses:

    * **erroring** — ``ejection_failures`` consecutive dial/call failures
      eject the subchannel for ``ejection_s`` seconds; any success resets
      the streak.
    * **slow** — a backend whose reported p99 EWMA exceeds
      ``slow_mult`` × the fleet median (above a 1 ms floor) is ejected
      the same way — a replica in GC hell or on a sick host reports
      modest queue depth while serving garbage latency. (The port's
      servers report a p99 of 0.0 until the watchdog is ported, so among
      them this ejection never fires.)

    Ejection expiry reinstates the backend so a recovered replica is
    re-probed; ejected backends still appear LAST in
    the pick order — a fleet with every member ejected degrades to
    round-robin rather than failing picks.
    """

    name = "least_loaded"
    ewma_alpha = 0.3

    def __init__(self, n: int, *, ejection_failures: int = 3,
                 ejection_s: float = 5.0, slow_mult: float = 4.0):
        self._n = n
        self.ejection_failures = ejection_failures
        self.ejection_s = ejection_s
        self.slow_mult = slow_mult
        self._counter = itertools.count()
        self._lock = threading.Lock()
        self._load = [0.0] * n          # EWMA of inflight + queue depth
        self._p99 = [0.0] * n           # EWMA of reported p99 (ms)
        self._reported = [False] * n
        self._fail_streak = [0] * n
        self._ejected_until = [0.0] * n
        # interned once; emits below are pure-int (flight lint discipline)
        from tpurpc_torch.obs import flight as _flight

        self._flight = _flight
        self._ftag = _flight.tag_for("lb:least_loaded")

    @staticmethod
    def parse_report(raw) -> "Optional[Tuple[float, float]]":
        """``b"3,5,12.5"`` → ``(utilization, p99_ms)`` or None on junk."""
        try:
            if isinstance(raw, (bytes, bytearray, memoryview)):
                raw = bytes(raw).decode("ascii")
            parts = str(raw).split(",")
            inflight = float(parts[0])
            qdepth = float(parts[1]) if len(parts) > 1 else 0.0
            p99_ms = float(parts[2]) if len(parts) > 2 else 0.0
            return max(0.0, inflight) + max(0.0, qdepth), max(0.0, p99_ms)
        except (ValueError, IndexError):
            return None

    def load_report(self, idx: int, raw) -> None:
        """One server-piggybacked report for subchannel ``idx`` (called by
        the channel on every response carrying one)."""
        parsed = self.parse_report(raw)
        if parsed is None or not 0 <= idx < self._n:
            return
        util, p99_ms = parsed
        a = self.ewma_alpha
        with self._lock:
            if self._reported[idx]:
                self._load[idx] += a * (util - self._load[idx])
                self._p99[idx] += a * (p99_ms - self._p99[idx])
            else:
                self._reported[idx] = True
                self._load[idx] = util
                self._p99[idx] = p99_ms
            self._maybe_eject_slow_locked(idx)

    def _maybe_eject_slow_locked(self, idx: int) -> None:
        now = time.monotonic()
        if now < self._ejected_until[idx]:
            return
        peers = [self._p99[i] for i in range(self._n)
                 if i != idx and self._reported[i]]
        if not peers:
            return
        peers.sort()
        median = peers[len(peers) // 2]
        if self._p99[idx] > max(1.0, median * self.slow_mult):
            self._ejected_until[idx] = now + self.ejection_s
            self._flight.emit(self._flight.SUBCH_EJECT, self._ftag, idx, 1)

    def order(self) -> Sequence[int]:
        now = time.monotonic()
        with self._lock:
            rr = next(self._counter) % self._n
            expired = [i for i in range(self._n)
                       if self._ejected_until[i]
                       and now >= self._ejected_until[i]]
            for i in expired:
                self._ejected_until[i] = 0.0
                self._fail_streak[i] = 0
                self._flight.emit(self._flight.SUBCH_REINSTATE,
                                  self._ftag, i)
            ranked = sorted(
                range(self._n),
                key=lambda i: (1 if now < self._ejected_until[i] else 0,
                               self._load[i], (i - rr) % self._n))
        return ranked

    def connected(self, idx: int) -> None:
        with self._lock:
            if 0 <= idx < self._n:
                self._fail_streak[idx] = 0

    def failed(self, idx: int) -> None:
        if not 0 <= idx < self._n:
            return
        with self._lock:
            self._fail_streak[idx] += 1
            if (self._fail_streak[idx] >= self.ejection_failures
                    and time.monotonic() >= self._ejected_until[idx]):
                self._ejected_until[idx] = (time.monotonic()
                                            + self.ejection_s)
                self._flight.emit(self._flight.SUBCH_EJECT,
                                  self._ftag, idx, 0)

    def snapshot(self) -> dict:
        """Introspection/test seam: current EWMAs + ejection state."""
        now = time.monotonic()
        with self._lock:
            return {
                "load": list(self._load),
                "p99_ms": list(self._p99),
                "reported": list(self._reported),
                "ejected": [now < t for t in self._ejected_until],
                "fail_streak": list(self._fail_streak),
            }


_call_key = threading.local()


class ring_hash_key:
    """Route calls made inside this context by a consistent-hash key:

    >>> with ring_hash_key("user-42"):
    ...     stub.Get(req)        # always lands on the same backend

    The reference's ring_hash policy hashes a per-RPC attribute (the xds
    hash policy); the channel API has no per-call LB metadata plumbing,
    so the key rides a thread-local that :class:`RingHash` reads at pick
    time. Without an active key, picks rotate (round-robin degenerate)."""

    def __init__(self, key: str):
        self._key = key

    def __enter__(self):
        self._prev = getattr(_call_key, "key", None)
        _call_key.key = self._key
        return self

    def __exit__(self, *exc):
        _call_key.key = self._prev
        return False


class RingHash:
    """Consistent hashing over subchannel indices.

    Each backend index is placed on a 2^32 ring at ``replicas`` points
    (md5 of ``"{idx}:{r}"``); a call's key hashes to a ring point and the
    preference order is the distinct backends encountered walking clockwise
    — so losing a backend moves only its arc to its successor, the property
    the reference's policy exists for."""

    name = "ring_hash"
    replicas = 64

    def __init__(self, n: int):
        self._n = n
        self._counter = itertools.count()
        self._lock = threading.Lock()
        points: List[Tuple[int, int]] = []
        for idx in range(n):
            for r in range(self.replicas):
                h = hashlib.md5(f"{idx}:{r}".encode()).digest()
                points.append((int.from_bytes(h[:4], "big"), idx))
        points.sort()
        self._points = points

    def _walk(self, start_hash: int) -> Sequence[int]:
        """Distinct backend indices in clockwise ring order from a point."""
        import bisect

        i = bisect.bisect_left(self._points, (start_hash, -1))
        order: List[int] = []
        seen = set()
        for k in range(len(self._points)):
            _, idx = self._points[(i + k) % len(self._points)]
            if idx not in seen:
                seen.add(idx)
                order.append(idx)
                if len(order) == self._n:
                    break
        return order

    def order(self) -> Sequence[int]:
        key: Optional[str] = getattr(_call_key, "key", None)
        if key is None:
            with self._lock:
                start = next(self._counter) % self._n
            return [(start + i) % self._n for i in range(self._n)]
        h = hashlib.md5(key.encode()).digest()
        return self._walk(int.from_bytes(h[:4], "big"))

    def connected(self, idx: int) -> None:
        pass

    def failed(self, idx: int) -> None:
        pass


class _IndexMapped:
    """Adapter running a child policy over a subset of the channel's
    subchannel indices: the child sees local indices ``0..k-1``; the adapter
    translates to/from the global ones. This is what lets ``priority`` and
    ``weighted_target`` compose arbitrary leaf policies (the reference builds
    the same shape as a tree of LB policies handing each child its own
    address sublist — ``lb_policy/priority/priority.cc``,
    ``weighted_target/weighted_target.cc``)."""

    def __init__(self, child, indices: Sequence[int]):
        self.child = child
        self.indices = list(indices)
        self._rev = {g: l for l, g in enumerate(self.indices)}

    def order(self) -> Sequence[int]:
        return [self.indices[i] for i in self.child.order()]

    def connected(self, gidx: int) -> None:
        if gidx in self._rev:
            self.child.connected(self._rev[gidx])

    def failed(self, gidx: int) -> None:
        if gidx in self._rev:
            self.child.failed(self._rev[gidx])


class Priority:
    """Ordered failover across child policies (ref
    ``lb_policy/priority/priority.cc``): all traffic goes to the
    highest-priority child with a usable backend; when every backend of the
    active child is marked failed, traffic fails over to the next child.
    Failed marks expire after ``failover_timeout_s`` so a recovered
    higher-priority child gets re-probed and traffic **fails back** (the
    reference drives this with its failover timer + child re-activation).

    The emitted order always appends the lower-priority children after the
    active child's backends — a single call can thus ride the channel's
    walk-the-order dial loop through a mid-call failover without waiting for
    the mark bookkeeping to settle."""

    name = "priority"

    def __init__(self, children: Sequence[_IndexMapped],
                 failover_timeout_s: float = 10.0):
        if not children:
            raise ValueError("priority needs at least one child")
        self._children = list(children)
        self.failover_timeout_s = failover_timeout_s
        self._failed_at: dict = {}          # global idx -> monotonic mark
        self._lock = threading.Lock()

    def _usable(self, child: _IndexMapped, now: float) -> bool:
        for g in child.indices:
            t = self._failed_at.get(g)
            if t is None or now - t >= self.failover_timeout_s:
                return True  # healthy, or failed mark expired: re-probe
        return False

    def order(self) -> Sequence[int]:
        import time as _time

        now = _time.monotonic()
        with self._lock:
            ranked = sorted(
                range(len(self._children)),
                key=lambda i: 0 if self._usable(self._children[i], now) else 1)
        out: List[int] = []
        seen = set()
        for ci in ranked:
            for g in self._children[ci].order():
                if g not in seen:
                    seen.add(g)
                    out.append(g)
        return out

    def connected(self, gidx: int) -> None:
        with self._lock:
            self._failed_at.pop(gidx, None)
        for c in self._children:
            c.connected(gidx)

    def failed(self, gidx: int) -> None:
        import time as _time

        with self._lock:
            self._failed_at[gidx] = _time.monotonic()
        for c in self._children:
            c.failed(gidx)


class WeightedTarget:
    """Weight-proportional traffic split across named targets, each with its
    own child policy (ref ``lb_policy/weighted_target/weighted_target.cc``).
    Pick uses smooth weighted round-robin (deterministic: a weight-3 target
    gets exactly 3 of every ``total`` picks, maximally interleaved), then
    the remaining targets are appended so dial failures spill over."""

    name = "weighted_target"

    def __init__(self, targets: Sequence[Tuple[float, _IndexMapped]]):
        if not targets:
            raise ValueError("weighted_target needs at least one target")
        self._targets = [(float(w), c) for w, c in targets]
        if any(w <= 0 for w, _ in self._targets):
            raise ValueError("weights must be positive")
        self._current = [0.0] * len(self._targets)
        self._lock = threading.Lock()

    def order(self) -> Sequence[int]:
        with self._lock:
            total = sum(w for w, _ in self._targets)
            for i, (w, _) in enumerate(self._targets):
                self._current[i] += w
            ranked = sorted(range(len(self._targets)),
                            key=lambda i: -self._current[i])
            self._current[ranked[0]] -= total
        out: List[int] = []
        seen = set()
        for ti in ranked:
            for g in self._targets[ti][1].order():
                if g not in seen:
                    seen.add(g)
                    out.append(g)
        return out

    def connected(self, gidx: int) -> None:
        for _, c in self._targets:
            c.connected(gidx)

    def failed(self, gidx: int) -> None:
        for _, c in self._targets:
            c.failed(gidx)


POLICIES = {"pick_first": PickFirst, "round_robin": RoundRobin,
            "ring_hash": RingHash, "least_loaded": LeastLoaded}


def make_policy(spec, n: int):
    """Build an LB policy.

    ``spec`` is either a policy name (``"pick_first"``, ``"round_robin"``,
    ``"ring_hash"``) over all ``n`` subchannels, or a composition tree à la
    gRPC service config (ref priority/weighted_target policies):

    >>> make_policy({"priority": {
    ...     "children": [
    ...         {"policy": "round_robin", "indices": [0, 1]},
    ...         {"policy": "pick_first", "indices": [2]},
    ...     ], "failover_timeout_s": 5}}, 3)
    >>> make_policy({"weighted_target": {"targets": [
    ...     {"weight": 3, "policy": "pick_first", "indices": [0]},
    ...     {"weight": 1, "policy": "pick_first", "indices": [1]},
    ... ]}}, 2)

    Children nest: a ``policy`` value may itself be a dict spec (e.g. a
    weighted_target of priority lists), in which case its ``indices`` are
    the universe its nested spec's indices refer into.
    """
    if isinstance(spec, str):
        try:
            return POLICIES[spec](n)
        except KeyError:
            raise ValueError(f"unknown lb policy {spec!r} "
                             f"(have {sorted(POLICIES)})") from None
    if not isinstance(spec, dict) or len(spec) != 1:
        raise ValueError(f"lb policy spec must be a name or one-key dict, "
                         f"got {spec!r}")
    kind, body = next(iter(spec.items()))

    def build_child(entry) -> _IndexMapped:
        indices = entry.get("indices")
        if not indices:
            raise ValueError(f"child {entry!r} needs non-empty 'indices'")
        bad = [i for i in indices if not 0 <= i < n]
        if bad:
            raise ValueError(f"child indices {bad} out of range 0..{n - 1}")
        child = make_policy(entry.get("policy", "pick_first"), len(indices))
        return _IndexMapped(child, indices)

    if kind == "priority":
        if isinstance(body, list):
            body = {"children": body}
        if not isinstance(body, dict) or "children" not in body:
            raise ValueError(f"priority spec needs 'children': {body!r}")
        children = [build_child(e) for e in body["children"]]
        return Priority(children,
                        failover_timeout_s=body.get("failover_timeout_s",
                                                    10.0))
    if kind == "weighted_target":
        if isinstance(body, list):
            body = {"targets": body}
        if not isinstance(body, dict) or "targets" not in body:
            raise ValueError(f"weighted_target spec needs 'targets': {body!r}")
        targets = [(e.get("weight", 1), build_child(e))
                   for e in body["targets"]]
        return WeightedTarget(targets)
    raise ValueError(f"unknown composite lb policy {kind!r} "
                     f"(have: priority, weighted_target)")
