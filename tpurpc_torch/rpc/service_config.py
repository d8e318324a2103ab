"""JSON service config: per-method timeout, retry and hedging delivered
by the resolver.

A copy of ``tpurpc/rpc/service_config.py``. The channel consumes a service
config attached to a resolver result: per-method timeouts and retry or
hedging policies arrive from the name resolver, not from call sites, with
retry THROTTLING shared channel-wide (gRFC A6):

* resolvers may return ``(addresses, service_config_dict)`` — see
  :func:`tpurpc_torch.rpc.resolver.resolve_target_full`; the channel parses
  the dict through :class:`ServiceConfig` and consults it per method.
* the JSON schema is gRPC's own (gRFC A2 names + A6 retryPolicy)::

      {"methodConfig": [{
           "name": [{"service": "pkg.Svc", "method": "Echo"}],
           "timeout": "1.5s",
           "waitForReady": true,
           "retryPolicy": {"maxAttempts": 4,
                           "initialBackoff": "0.05s",
                           "maxBackoff": "1s",
                           "backoffMultiplier": 2,
                           "retryableStatusCodes": ["UNAVAILABLE"]}}],
       "retryThrottling": {"maxTokens": 10, "tokenRatio": 0.1}}

* name matching precedence is gRPC's: exact service+method, then
  service-wide (no ``method``), then the global default (empty ``{}``).
* an application-supplied ``retry_policy``/call timeout always wins over
  the config (explicit code beats delivered config; for timeouts the
  EFFECTIVE deadline is the min of the two, gRPC's rule).
"""

from __future__ import annotations

import json
import re
import threading
from typing import Dict, List, Optional, Tuple

from tpurpc_torch.rpc.status import StatusCode

_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)s$")


def _parse_duration(v) -> float:
    """gRPC JSON duration: ``"1.5s"`` (proto3 JSON form) or a bare number
    of seconds (tolerated for hand-written configs)."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    if isinstance(v, str):
        m = _DURATION_RE.match(v.strip())
        if m:
            return float(m.group(1))
    raise ValueError(f"bad duration {v!r} (want e.g. \"1.5s\")")


class RetryThrottle:
    """Channel-wide retry token bucket (gRFC A6, ``retry_throttle.cc``).

    Every retryable failure costs one token; every success refunds
    ``token_ratio``. Retries are permitted only while the bucket is above
    half — so a backend in collapse stops receiving retry storms even
    though individual calls still carry retry policies."""

    def __init__(self, max_tokens: float, token_ratio: float):
        if max_tokens <= 0 or token_ratio <= 0:
            raise ValueError("maxTokens and tokenRatio must be positive")
        self.max_tokens = float(max_tokens)
        self.token_ratio = float(token_ratio)
        self._tokens = float(max_tokens)
        self._lock = threading.Lock()

    def carry_from(self, prev: "Optional[RetryThrottle]") -> "RetryThrottle":
        """Preserve drain state across config updates (``retry_throttle.cc``
        behavior): a re-resolution re-delivering the config must NOT refill
        the bucket — that would resume a suppressed retry storm on every
        resolver refresh. Same params → adopt the previous token count;
        changed ``maxTokens`` → scale it proportionally."""
        if prev is None:
            return self
        with prev._lock:
            prev_tokens, prev_max = prev._tokens, prev.max_tokens
        with self._lock:
            self._tokens = min(self.max_tokens,
                               prev_tokens * (self.max_tokens / prev_max))
        return self

    def record_failure(self) -> None:
        with self._lock:
            self._tokens = max(0.0, self._tokens - 1.0)

    def record_success(self) -> None:
        with self._lock:
            self._tokens = min(self.max_tokens,
                               self._tokens + self.token_ratio)

    def allow_retry(self) -> bool:
        with self._lock:
            return self._tokens > self.max_tokens / 2.0

    def tokens(self) -> float:  # observability/test seam
        with self._lock:
            return self._tokens


class MethodConfig:
    """One resolved per-method view: what the channel consults at call time."""

    __slots__ = ("timeout", "retry_policy", "wait_for_ready",
                 "hedging_policy")

    def __init__(self, timeout: Optional[float] = None,
                 retry_policy=None, wait_for_ready: Optional[bool] = None,
                 hedging_policy=None):
        self.timeout = timeout
        self.retry_policy = retry_policy
        self.wait_for_ready = wait_for_ready
        self.hedging_policy = hedging_policy


_EMPTY = MethodConfig()


#: gRPC caps service-config maxAttempts at 5 (retry_service_config.cc
#: clamps with a log line rather than rejecting) — a resolver cannot
#: configure an unbounded retry budget
MAX_ATTEMPTS_CAP = 5


def _parse_retry_policy(body: dict):
    from tpurpc_torch.rpc.channel import RetryPolicy  # lazy: a cycle

    if not isinstance(body, dict):
        raise ValueError(f"retryPolicy must be an object, got {body!r}")
    codes = []
    for name in body.get("retryableStatusCodes", ()):
        try:
            codes.append(StatusCode[str(name).upper()])
        except KeyError:
            raise ValueError(f"unknown status code {name!r} in "
                             "retryableStatusCodes") from None
    if not codes:
        raise ValueError("retryPolicy needs non-empty retryableStatusCodes")
    max_attempts = int(body.get("maxAttempts", 0))
    if max_attempts < 2:
        raise ValueError("retryPolicy.maxAttempts must be >= 2")
    initial = _parse_duration(body.get("initialBackoff", "0.05s"))
    maxi = _parse_duration(body.get("maxBackoff", "1s"))
    mult = float(body.get("backoffMultiplier", 2.0))
    # zero/negative backoff would be a sleepless hammer loop against a
    # failing backend; the reference rejects these at parse
    if initial <= 0 or maxi <= 0 or mult <= 0:
        raise ValueError("retryPolicy backoff values must be positive")
    return RetryPolicy(
        max_attempts=min(max_attempts, MAX_ATTEMPTS_CAP),
        initial_backoff=initial,
        max_backoff=maxi,
        backoff_multiplier=mult,
        retryable_codes=codes)


def _parse_hedging_policy(body: dict):
    """gRFC A6 ``hedgingPolicy``: N staggered attempts under one deadline.

    Schema (proto3 JSON, like retryPolicy)::

        "hedgingPolicy": {"maxAttempts": 3,
                          "hedgingDelay": "0.01s",
                          "nonFatalStatusCodes": ["UNAVAILABLE"]}

    A status in ``nonFatalStatusCodes`` lets the NEXT hedge fire
    immediately; any other failure is fatal and resolves the call. The
    same ``maxAttempts`` cap as retryPolicy applies."""
    from tpurpc_torch.rpc.channel import HedgingPolicy  # lazy: a cycle

    if not isinstance(body, dict):
        raise ValueError(f"hedgingPolicy must be an object, got {body!r}")
    codes = []
    for name in body.get("nonFatalStatusCodes", ()):
        try:
            codes.append(StatusCode[str(name).upper()])
        except KeyError:
            raise ValueError(f"unknown status code {name!r} in "
                             "nonFatalStatusCodes") from None
    max_attempts = int(body.get("maxAttempts", 0))
    if max_attempts < 2:
        raise ValueError("hedgingPolicy.maxAttempts must be >= 2")
    delay = _parse_duration(body.get("hedgingDelay", "0s"))
    if delay < 0:
        raise ValueError("hedgingPolicy.hedgingDelay must be >= 0")
    return HedgingPolicy(
        max_attempts=min(max_attempts, MAX_ATTEMPTS_CAP),
        hedging_delay=delay,
        non_fatal_codes=codes or (StatusCode.UNAVAILABLE,))


def split_method(method: str) -> Tuple[str, str]:
    """``"/pkg.Svc/Echo"`` → ``("pkg.Svc", "Echo")`` (tolerates no slash)."""
    path = method.lstrip("/")
    service, _, name = path.rpartition("/")
    return service, name


class ServiceConfig:
    """Parsed service config. Construction VALIDATES (a malformed config is
    rejected whole, like the reference's service_config parse — the channel
    then keeps its previous config rather than half-applying)."""

    def __init__(self, method_configs: List[Tuple[List[Tuple[str, str]],
                                                  MethodConfig]],
                 retry_throttle: Optional[RetryThrottle],
                 raw: dict):
        self._exact: Dict[Tuple[str, str], MethodConfig] = {}
        self._service: Dict[str, MethodConfig] = {}
        self._default: Optional[MethodConfig] = None
        self.retry_throttle = retry_throttle
        self.raw = raw
        for names, mc in method_configs:
            for service, name in names:
                if service and name:
                    self._exact.setdefault((service, name), mc)
                elif service:
                    self._service.setdefault(service, mc)
                else:
                    if self._default is None:
                        self._default = mc

    @classmethod
    def from_json(cls, obj) -> "ServiceConfig":
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)
        if not isinstance(obj, dict):
            raise ValueError(f"service config must be an object, got "
                             f"{type(obj).__name__}")
        throttle = None
        if "retryThrottling" in obj:
            rt = obj["retryThrottling"]
            if not isinstance(rt, dict):
                raise ValueError(f"retryThrottling must be an object, "
                                 f"got {rt!r}")
            throttle = RetryThrottle(rt.get("maxTokens", 0),
                                     rt.get("tokenRatio", 0))
        entries: List[Tuple[List[Tuple[str, str]], MethodConfig]] = []
        mc_list = obj.get("methodConfig", ())
        if not isinstance(mc_list, (list, tuple)):
            raise ValueError(f"methodConfig must be a list, got {mc_list!r}")
        for entry in mc_list:
            if not isinstance(entry, dict):
                raise ValueError(f"methodConfig entry must be an object, "
                                 f"got {entry!r}")
            names: List[Tuple[str, str]] = []
            nm_list = entry.get("name", ())
            if not isinstance(nm_list, (list, tuple)):
                raise ValueError(f"methodConfig name must be a list, "
                                 f"got {nm_list!r}")
            for nm in nm_list:
                if not isinstance(nm, dict):
                    raise ValueError(f"methodConfig name entry must be an "
                                     f"object, got {nm!r}")
                service = nm.get("service", "")
                name = nm.get("method", "")
                if name and not service:
                    raise ValueError("method name without service in "
                                     f"methodConfig name {nm!r}")
                names.append((service, name))
            if not names:
                raise ValueError("methodConfig entry without name list")
            if "retryPolicy" in entry and "hedgingPolicy" in entry:
                # gRFC A6: a method has ONE of the two execution strategies
                raise ValueError("methodConfig entry has both retryPolicy "
                                 "and hedgingPolicy (mutually exclusive)")
            mc = MethodConfig(
                timeout=(_parse_duration(entry["timeout"])
                         if "timeout" in entry else None),
                retry_policy=(_parse_retry_policy(entry["retryPolicy"])
                              if "retryPolicy" in entry else None),
                wait_for_ready=entry.get("waitForReady"),
                hedging_policy=(_parse_hedging_policy(entry["hedgingPolicy"])
                                if "hedgingPolicy" in entry else None))
            entries.append((names, mc))
        return cls(entries, throttle, obj)

    def for_method(self, method: str) -> MethodConfig:
        service, name = split_method(method)
        mc = self._exact.get((service, name))
        if mc is not None:
            return mc
        mc = self._service.get(service)
        if mc is not None:
            return mc
        return self._default if self._default is not None else _EMPTY
