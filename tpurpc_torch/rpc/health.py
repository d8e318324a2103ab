"""gRPC Health Checking service (grpc.health.v1) for tpurpc_torch servers.

A copy of ``tpurpc/rpc/health.py``; the same bytes on the framed transport.
The standard ``/grpc.health.v1.Health/{Check,Watch}`` protocol every gRPC
deployment's load balancers and orchestrators probe (the reference inherits
it from upstream: ``src/proto/grpc/health/v1/health.proto`` +
``src/python/grpcio_health_checking``). Message encoding is hand-rolled —
the messages are one field each, and hard-coding the two tag bytes beats a
protobuf dependency:

    HealthCheckRequest  { string service = 1; }          → 0x0A len bytes
    HealthCheckResponse { ServingStatus status = 1; }     → 0x08 varint

Served on every transport, and to stock gRPC clients over the HTTP/2
plane (``tpurpc_torch/wire/grpc_h2.py``).
"""

from __future__ import annotations

import enum
import threading
from typing import Dict, Iterator

from tpurpc_torch.rpc.server import (Server, unary_stream_rpc_method_handler,
                                     unary_unary_rpc_method_handler)
from tpurpc_torch.rpc.status import AbortError, StatusCode
from tpurpc_torch.wire.protowire import decode_varint as _decode_varint
from tpurpc_torch.wire.protowire import encode_varint as _encode_varint

SERVICE_NAME = "grpc.health.v1.Health"
#: the conventional key for "the server as a whole"
OVERALL = ""


class ServingStatus(enum.IntEnum):
    UNKNOWN = 0
    SERVING = 1
    NOT_SERVING = 2
    SERVICE_UNKNOWN = 3  # Watch-only, per the health spec


def encode_request(service: str) -> bytes:
    raw = service.encode("utf-8")
    if not raw:
        return b""  # proto3: default value omitted
    return b"\x0a" + _encode_varint(len(raw)) + raw


def decode_request(buf) -> str:
    data = bytes(buf)
    pos = 0
    service = ""
    while pos < len(data):
        tag = data[pos]
        pos += 1
        if tag == 0x0A:  # field 1, length-delimited
            ln, pos = _decode_varint(data, pos)
            service = data[pos:pos + ln].decode("utf-8")
            pos += ln
        elif tag & 0x07 == 0:  # unknown varint field
            _, pos = _decode_varint(data, pos)
        elif tag & 0x07 == 2:  # unknown length-delimited field
            ln, pos = _decode_varint(data, pos)
            pos += ln
        else:
            break  # unknown fixed-width field: nothing legal follows here
    return service


def encode_response(status: ServingStatus) -> bytes:
    if status == ServingStatus.UNKNOWN:
        return b""
    return b"\x08" + _encode_varint(int(status))


def decode_response(buf) -> ServingStatus:
    data = bytes(buf)
    pos = 0
    while pos < len(data):
        tag = data[pos]
        pos += 1
        if tag == 0x08:
            val, pos = _decode_varint(data, pos)
            return ServingStatus(val)
        elif tag & 0x07 == 0:
            _, pos = _decode_varint(data, pos)
        elif tag & 0x07 == 2:
            ln, pos = _decode_varint(data, pos)
            pos += ln
        else:
            break
    return ServingStatus.UNKNOWN


class HealthServicer:
    """Status registry + the two health RPCs (grpcio's HealthServicer shape).

    ``set(service, status)`` updates a service's state and wakes every
    watcher; the overall server state lives under the empty service name.
    """

    def __init__(self):
        self._lock = threading.Condition()
        self._statuses: Dict[str, ServingStatus] = {
            OVERALL: ServingStatus.SERVING}
        self._epoch = 0  # bumped per set(); watchers wait on it

    def set(self, service: str, status: ServingStatus) -> None:
        with self._lock:
            self._statuses[service] = ServingStatus(status)
            self._epoch += 1
            self._lock.notify_all()

    def set_all(self, status: ServingStatus) -> None:
        """Flip EVERY registered service (the overall key included) in one
        epoch — what :meth:`tpurpc_torch.rpc.server.Server.drain` calls so LBs
        and watchers see the whole backend leave rotation at once
        (grpcio's ``enter_graceful_shutdown`` analog)."""
        with self._lock:
            for service in self._statuses:
                self._statuses[service] = ServingStatus(status)
            self._epoch += 1
            self._lock.notify_all()

    def _check(self, raw, ctx) -> bytes:
        try:
            service = decode_request(raw)
        except (ValueError, IndexError, UnicodeDecodeError):
            raise AbortError(StatusCode.INVALID_ARGUMENT,
                            "malformed HealthCheckRequest") from None
        with self._lock:
            status = self._statuses.get(service)
        if status is None:
            # spec: Check on an unregistered service → NOT_FOUND
            raise AbortError(StatusCode.NOT_FOUND,
                             f"unknown service {service!r}")
        return encode_response(status)

    def _watch(self, raw, ctx) -> Iterator[bytes]:
        try:
            service = decode_request(raw)
        except (ValueError, IndexError, UnicodeDecodeError):
            raise AbortError(StatusCode.INVALID_ARGUMENT,
                            "malformed HealthCheckRequest") from None
        last = None
        while ctx.is_active():
            with self._lock:
                status = self._statuses.get(service,
                                            ServingStatus.SERVICE_UNKNOWN)
                epoch = self._epoch
            if status != last:
                last = status
                yield encode_response(status)
            with self._lock:
                # wake on any set(); re-check OUR service + ctx liveness.
                # Bounded wait so a cancelled stream is noticed promptly.
                if self._epoch == epoch:
                    self._lock.wait(timeout=0.25)

    def add_to_server(self, server: Server) -> None:
        server.add_method(
            f"/{SERVICE_NAME}/Check",
            unary_unary_rpc_method_handler(self._check))
        server.add_method(
            f"/{SERVICE_NAME}/Watch",
            unary_stream_rpc_method_handler(self._watch))
        # the server drives this servicer on drain() (NOT_SERVING
        # fleet-wide while connections bleed)
        server._health_servicer = self


def add_health_servicer(server: Server) -> HealthServicer:
    """Convenience: attach a fresh HealthServicer; returns it for set()."""
    servicer = HealthServicer()
    servicer.add_to_server(server)
    return servicer
