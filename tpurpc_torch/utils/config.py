"""Typed runtime configuration, read once from the environment.

A trimmed copy of ``tpurpc/utils/config.py``: the same ``Platform`` spellings
(``GRPC_PLATFORM_TYPE=TCP|RDMA_BP|RDMA_EVENT|RDMA_BPEV|TPU|RDMA_TPU``) and the
same ring-size knobs, so one environment drives both packages, plus the
port's ``device`` field (``TPURPC_TORCH_DEVICE``, default ``cuda``): where
tensors live when a caller names no device. The connection lifecycle's keys
keep the reference's names, defaults and variables: keepalive, the client's
idle timeout and the server's max connection age (each 0, off, by default,
with gRPC's ``GRPC_ARG_*`` spellings accepted), idle-pair parking
(``TPURPC_PAIR_PARK_S``, 0.0, off) and the accept burst
(``TPURPC_ACCEPT_BURST``, 64).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import threading
from typing import Optional, Tuple

import torch


class Platform(enum.Enum):
    """Which byte-pipe ``create_endpoint`` dispatches to. ``TPU`` is the mode
    whose receive ring is device-resident (on a CUDA card in this package)."""

    TCP = "TCP"
    RING_BP = "RING_BP"        # busy-poll
    RING_EVENT = "RING_EVENT"  # event/interrupt
    RING_BPEV = "RING_BPEV"    # hybrid spin-then-block
    TPU = "TPU"                # device-resident receive ring

    @property
    def is_ring(self) -> bool:
        return self is not Platform.TCP

    @property
    def discipline(self) -> Optional[str]:
        """Wakeup discipline for ring platforms; None for TCP."""
        return {
            Platform.RING_BP: "busy",
            Platform.RING_EVENT: "event",
            Platform.RING_BPEV: "hybrid",
            Platform.TPU: "hybrid",
        }.get(self)


_PLATFORM_ALIASES = {
    "TCP": Platform.TCP,
    "RDMA_BP": Platform.RING_BP,
    "RDMA_EVENT": Platform.RING_EVENT,
    "RDMA_BPEV": Platform.RING_BPEV,
    "RING_BP": Platform.RING_BP,
    "RING_EVENT": Platform.RING_EVENT,
    "RING_BPEV": Platform.RING_BPEV,
    "TPU": Platform.TPU,
    "RDMA_TPU": Platform.TPU,
}


def env_lookup(name: str, *aliases: str) -> Tuple[Optional[str], Optional[str]]:
    """First non-empty value among ``name`` and its aliases → (key, value)."""
    for key in (name, *aliases):
        val = os.environ.get(key)
        if val is not None and val != "":
            return key, val
    return None, None


def _env(name: str, *aliases: str) -> Optional[str]:
    return env_lookup(name, *aliases)[1]


def _env_float(name: str, default: float, *aliases: str) -> float:
    key, val = env_lookup(name, *aliases)
    if val is None:
        return default
    try:
        return float(val)
    except ValueError as exc:
        raise ValueError(f"{key}={val!r} is not a number") from exc


def _env_int(name: str, default: int, *aliases: str) -> int:
    key, val = env_lookup(name, *aliases)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError as exc:
        raise ValueError(f"{key}={val!r} is not an integer") from exc


@dataclasses.dataclass(frozen=True)
class Config:
    """Process-wide config snapshot (fields as in the reference's Config)."""

    platform: Platform = Platform.TCP
    ring_buffer_size_kb: int = 4096
    poller_thread_num: int = 1
    busy_polling_timeout_us: int = 500
    poller_sleep_timeout_ms: int = 1000
    send_chunk_size: int = 512 * 1024
    pair_pool_size: int = 128
    poller_capacity: int = 4096
    #: device receive-ring capacity for Platform.TPU endpoints (16 MiB)
    hbm_ring_size_kb: int = 16384
    #: largest acceptable received message, bytes (-1 = unlimited)
    max_recv_message_length: int = 64 << 20
    #: completed-but-unconsumed messages buffered per stream
    stream_queue_depth: int = 64
    #: client keepalive: PING the server after this many ms of inactivity;
    #: 0 or less disables (gRPC's default)
    keepalive_time_ms: int = 0
    #: how long the keepalive PONG may take before the connection is dead
    keepalive_timeout_ms: int = 20000
    #: close a client connection with no streams after this much
    #: inactivity; 0 or less disables
    client_idle_timeout_ms: int = 0
    #: the server GOAWAYs a connection older than this; in-flight calls
    #: drain, new calls dial fresh; 0 or less disables
    max_connection_age_ms: int = 0
    #: MemoryDomain of the ring's one-sided writes: "shm", "local" or
    #: "tcp_window"
    ring_domain: str = "shm"
    #: tcp_window: the address peers dial to reach this process's record
    #: server (advertised inside region handles; a reachable address for
    #: real cross-host deployments), and the record server's bind address
    tcpw_host: str = "127.0.0.1"
    tcpw_bind: str = "0.0.0.0"
    #: park a pair whose rings have been quiet this many seconds: its host
    #: ring regions go to the process's RingPool and its poller slot frees
    #: until the next byte; 0 (the default) disables parking
    pair_park_s: float = 0.0
    #: how many pending connections one listener wakeup may accept (each
    #: still passes the admission probe before any handshake work)
    accept_burst: int = 64
    #: where tensors live when a caller names no device
    device: str = "cuda"

    @property
    def ring_buffer_size(self) -> int:
        """Ring capacity in bytes, rounded up to a power of two."""
        size = self.ring_buffer_size_kb * 1024
        return 1 << max(12, (size - 1).bit_length())

    @property
    def hbm_ring_size(self) -> int:
        """Device ring capacity in bytes, power-of-two rounded."""
        size = self.hbm_ring_size_kb * 1024
        return 1 << max(12, (size - 1).bit_length())

    @property
    def max_recv_message_bytes(self) -> Optional[int]:
        if self.max_recv_message_length < 0:
            return None
        return self.max_recv_message_length

    def resolve_recv_limit(self, override: Optional[int]) -> Optional[int]:
        """None → config default, negative → unlimited (None), else as given."""
        if override is None:
            return self.max_recv_message_bytes
        if override < 0:
            return None
        return override

    @classmethod
    def from_env(cls) -> "Config":
        raw = _env("TPURPC_PLATFORM_TYPE", "GRPC_PLATFORM_TYPE")
        if raw is None:
            platform = Platform.TCP
        else:
            try:
                platform = _PLATFORM_ALIASES[raw.strip().upper()]
            except KeyError:
                raise ValueError(
                    f"unknown platform type {raw!r}; expected one of "
                    f"{sorted(_PLATFORM_ALIASES)}") from None
        return cls(
            platform=platform,
            ring_buffer_size_kb=_env_int(
                "TPURPC_RING_BUFFER_SIZE_KB", cls.ring_buffer_size_kb,
                "GRPC_RDMA_RING_BUFFER_SIZE_KB"),
            poller_thread_num=_env_int(
                "TPURPC_POLLER_THREAD_NUM", cls.poller_thread_num,
                "GRPC_RDMA_POLLER_THREAD_NUM"),
            busy_polling_timeout_us=_env_int(
                "TPURPC_BUSY_POLLING_TIMEOUT_US", cls.busy_polling_timeout_us,
                "GRPC_RDMA_BUSY_POLLING_TIMEOUT_US"),
            poller_sleep_timeout_ms=_env_int(
                "TPURPC_POLLER_SLEEP_TIMEOUT_MS", cls.poller_sleep_timeout_ms,
                "GRPC_RDMA_POLLER_SLEEP_TIMEOUT_MS"),
            send_chunk_size=_env_int(
                "TPURPC_SEND_CHUNK_SIZE", cls.send_chunk_size,
                "GRPC_RDMA_SEND_CHUNK_SIZE"),
            pair_pool_size=_env_int("TPURPC_PAIR_POOL_SIZE", cls.pair_pool_size),
            poller_capacity=_env_int("TPURPC_POLLER_CAPACITY",
                                     cls.poller_capacity),
            hbm_ring_size_kb=_env_int(
                "TPURPC_HBM_RING_SIZE_KB", cls.hbm_ring_size_kb),
            max_recv_message_length=_env_int(
                "TPURPC_MAX_RECV_MESSAGE_LENGTH", cls.max_recv_message_length),
            stream_queue_depth=_env_int(
                "TPURPC_STREAM_QUEUE_DEPTH", cls.stream_queue_depth),
            keepalive_time_ms=_env_int(
                "TPURPC_KEEPALIVE_TIME_MS", cls.keepalive_time_ms,
                "GRPC_ARG_KEEPALIVE_TIME_MS"),
            keepalive_timeout_ms=_env_int(
                "TPURPC_KEEPALIVE_TIMEOUT_MS", cls.keepalive_timeout_ms,
                "GRPC_ARG_KEEPALIVE_TIMEOUT_MS"),
            client_idle_timeout_ms=_env_int(
                "TPURPC_CLIENT_IDLE_TIMEOUT_MS", cls.client_idle_timeout_ms,
                "GRPC_ARG_CLIENT_IDLE_TIMEOUT_MS"),
            max_connection_age_ms=_env_int(
                "TPURPC_MAX_CONNECTION_AGE_MS", cls.max_connection_age_ms,
                "GRPC_ARG_MAX_CONNECTION_AGE_MS"),
            ring_domain=(_env("TPURPC_RING_DOMAIN", "GRPC_RDMA_DOMAIN")
                         or cls.ring_domain).strip().lower(),
            tcpw_host=_env("TPURPC_TCPW_HOST") or cls.tcpw_host,
            tcpw_bind=_env("TPURPC_TCPW_BIND") or cls.tcpw_bind,
            pair_park_s=_env_float("TPURPC_PAIR_PARK_S", cls.pair_park_s),
            accept_burst=_env_int("TPURPC_ACCEPT_BURST", cls.accept_burst),
            device=(_env("TPURPC_TORCH_DEVICE") or cls.device).strip().lower(),
        )


_lock = threading.Lock()
_instance: Optional[Config] = None


def get_config() -> Config:
    """Lazy process-wide singleton."""
    global _instance
    if _instance is None:
        with _lock:
            if _instance is None:
                _instance = Config.from_env()
    return _instance


def set_config(config: Optional[Config]) -> None:
    """Override (or with ``None`` reset) the singleton — tests and embedders."""
    global _instance
    with _lock:
        _instance = config


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``device`` when given,
    else the config's. A CUDA device with no card raises — the port never
    carries on silently on the CPU."""
    dev = torch.device(device if device is not None else get_config().device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but no CUDA device is available; "
                "pass device='cpu' or set TPURPC_TORCH_DEVICE=cpu to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
