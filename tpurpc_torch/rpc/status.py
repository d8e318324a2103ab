"""RPC status codes and errors — the surface contract of every call.

A copy of ``tpurpc/rpc/status.py``: gRPC's 16 canonical codes; transport
failures surface as ``UNAVAILABLE`` so the client may reconnect and retry;
a channel's connectivity states.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional, Sequence, Tuple

Metadata = Sequence[Tuple[str, "str | bytes"]]
Serializer = Callable[[object], bytes]
Deserializer = Callable[[bytes], object]


def identity_codec(x):
    """Default (de)serializer: the application speaks raw bytes."""
    return x


def deserialize(deserializer, buf):
    """Apply ``deserializer`` to a received message buffer.

    Messages arrive as memoryviews over detached assembly storage. grpcio's
    contract hands deserializers *bytes*, so views are materialized first (a
    ledgered host copy) — except for deserializers marked ``alias_ok =
    True`` (the tensor codec), which decode zero-copy over the view."""
    if isinstance(buf, memoryview) and not getattr(deserializer, "alias_ok",
                                                   False):
        from tpurpc_torch.tpu import ledger as _ledger

        _ledger.host_copy(len(buf))
        buf = bytes(buf)
    return deserializer(buf)


class StatusCode(enum.IntEnum):
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class ChannelConnectivity(enum.Enum):
    """grpc.ChannelConnectivity's analog (connectivity_state.h's states),
    read by :meth:`tpurpc_torch.rpc.channel.Channel.get_state`."""

    IDLE = 0
    CONNECTING = 1
    READY = 2
    TRANSIENT_FAILURE = 3
    SHUTDOWN = 4


class RpcError(Exception):
    """Raised on the client when a call terminates with a non-OK status."""

    def __init__(self, code: StatusCode, details: str = "",
                 trailing_metadata: Optional[Metadata] = None):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details
        self._trailing = tuple(trailing_metadata or ())

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details

    def trailing_metadata(self) -> Metadata:
        return self._trailing


class AbortError(Exception):
    """Raised inside a server handler by ``context.abort`` to end the RPC."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(f"{code.name}: {details}")
        self.code = code
        self.details = details
