"""Interceptors + fault injection.

A copy of ``tpurpc/rpc/interceptors.py``. grpcio-shaped interception so
middleware ports directly:

* server: objects with ``intercept_service(continuation, details)`` →
  ``Server(interceptors=[...])`` (grpcio ``grpc.ServerInterceptor``), run
  on both wire planes (the native framing and HTTP/2)
* client: :func:`intercept_channel` wrapping the four multicallable shapes
  (grpcio ``grpc.intercept_channel``)

On top of them, :class:`FaultInjector` reproduces gRPC's fault_injection
filter: per-method abort code/probability and injected delay, configured
programmatically instead of via service config JSON. It wraps the
handler's behavior, so an aborted attempt never reaches it: on the
device-ring platform such an attempt lands nothing in the ring.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, Optional, Sequence

from tpurpc_torch.rpc.status import AbortError, Metadata, StatusCode


class HandlerCallDetails:
    __slots__ = ("method", "invocation_metadata")

    def __init__(self, method: str, invocation_metadata: Metadata):
        self.method = method
        self.invocation_metadata = invocation_metadata


class ServerInterceptor:
    """Override intercept_service; return a handler (possibly wrapped)."""

    def intercept_service(self, continuation: Callable,
                          details: HandlerCallDetails):
        return continuation(details)


def apply_server_interceptors(handler, method: str, metadata: Metadata,
                              interceptors: Sequence[ServerInterceptor]):
    """Run the chain innermost-last, like grpcio."""
    details = HandlerCallDetails(method, metadata)

    def base(_details):
        return handler

    continuation = base
    for icpt in reversed(list(interceptors)):
        continuation = (lambda d, icpt=icpt, nxt=continuation:
                        icpt.intercept_service(nxt, d))
    return continuation(details)


# -- client side -------------------------------------------------------------

class ClientCallDetails:
    __slots__ = ("method", "timeout", "metadata")

    def __init__(self, method: str, timeout: Optional[float],
                 metadata: Optional[Metadata]):
        self.method = method
        self.timeout = timeout
        self.metadata = metadata


class ClientInterceptor:
    """One hook for all four shapes (grpcio splits these into four ABCs;
    the merged form is what nearly every real interceptor writes anyway)."""

    def intercept_call(self, continuation: Callable,
                       details: ClientCallDetails, request_or_iterator):
        return continuation(details, request_or_iterator)


class _InterceptedMultiCallable:
    def __init__(self, inner, method: str,
                 interceptors: Sequence[ClientInterceptor]):
        self._inner = inner
        self._method = method
        self._interceptors = list(interceptors)

    def _invoke(self, request_or_iterator, timeout, metadata, with_call: bool):
        def base(details: ClientCallDetails, req):
            if with_call:
                return self._inner.with_call(req, timeout=details.timeout,
                                             metadata=details.metadata)
            return self._inner(req, timeout=details.timeout,
                               metadata=details.metadata)

        continuation = base
        for icpt in reversed(self._interceptors):
            continuation = (lambda d, r, icpt=icpt, nxt=continuation:
                            icpt.intercept_call(nxt, d, r))
        return continuation(ClientCallDetails(self._method, timeout, metadata),
                            request_or_iterator)

    def __call__(self, request_or_iterator, timeout=None, metadata=None):
        return self._invoke(request_or_iterator, timeout, metadata, False)

    def with_call(self, request_or_iterator, timeout=None, metadata=None):
        return self._invoke(request_or_iterator, timeout, metadata, True)


class _InterceptedChannel:
    def __init__(self, channel, interceptors: Sequence[ClientInterceptor]):
        self._channel = channel
        self._interceptors = list(interceptors)

    def _wrap(self, factory, method, *codecs):
        return _InterceptedMultiCallable(factory(method, *codecs), method,
                                         self._interceptors)

    def unary_unary(self, method, *codecs):
        return self._wrap(self._channel.unary_unary, method, *codecs)

    def unary_stream(self, method, *codecs):
        return self._wrap(self._channel.unary_stream, method, *codecs)

    def stream_unary(self, method, *codecs):
        return self._wrap(self._channel.stream_unary, method, *codecs)

    def stream_stream(self, method, *codecs):
        return self._wrap(self._channel.stream_stream, method, *codecs)

    def ping(self, timeout: float = 5.0):
        """Passes through to the wrapped channel's ``ping``. The port's
        ``Channel`` has none yet (it comes with the keepalive and
        connectivity pieces of ``rpc/channel.py``), so on it this raises
        ``AttributeError``."""
        return self._channel.ping(timeout)

    def close(self):
        return self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def intercept_channel(channel, *interceptors: ClientInterceptor):
    return _InterceptedChannel(channel, interceptors)


# -- fault injection ---------------------------------------------------------

class FaultConfig:
    __slots__ = ("abort_code", "abort_message", "abort_fraction",
                 "delay_s", "delay_fraction")

    def __init__(self, abort_code: Optional[StatusCode] = None,
                 abort_message: str = "injected failure",
                 abort_fraction: float = 0.0, delay_s: float = 0.0,
                 delay_fraction: float = 0.0):
        self.abort_code = abort_code
        self.abort_message = abort_message
        self.abort_fraction = abort_fraction
        self.delay_s = delay_s
        self.delay_fraction = delay_fraction


class FaultInjector(ServerInterceptor):
    """Per-method delay/abort injection (gRPC's fault_injection filter).

    ``configs`` maps method path (or ``"*"``) → :class:`FaultConfig`.
    Deterministic under a seeded ``rng`` for tests: each call draws the
    delay's number first (when ``delay_s`` is set), then the abort's (when
    ``abort_code`` is set).
    """

    def __init__(self, configs: Dict[str, FaultConfig],
                 rng: Optional[random.Random] = None):
        self.configs = dict(configs)
        self._rng = rng or random.Random()

    def intercept_service(self, continuation, details: HandlerCallDetails):
        cfg = self.configs.get(details.method) or self.configs.get("*")
        handler = continuation(details)
        if cfg is None or handler is None:
            return handler

        from tpurpc_torch.rpc.server import RpcMethodHandler

        inner = handler.behavior

        def faulty(request_or_iterator, context):
            if cfg.delay_s and self._rng.random() < cfg.delay_fraction:
                time.sleep(cfg.delay_s)
            if (cfg.abort_code is not None
                    and self._rng.random() < cfg.abort_fraction):
                raise AbortError(cfg.abort_code, cfg.abort_message)
            return inner(request_or_iterator, context)

        return RpcMethodHandler(handler.kind, faulty,
                                handler.request_deserializer,
                                handler.response_serializer)
