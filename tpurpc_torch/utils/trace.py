"""Trace-flag registry and leveled logging.

Mirrors the reference's ``grpc_core::TraceFlag`` registry driven by the ``GRPC_TRACE``
env var with ``GRPC_VERBOSITY`` levels (``src/core/lib/debug/trace.{h,cc}``), including
the fork-added flags ``rdma`` (``endpoint.cc:31``) and ``rdma_sr_event`` /
``rdma_sr_event_debug`` (``rdma_sender_receiver_event.cc:4-6``).  Same env grammar:
comma-separated flag names, ``all`` / ``list_tracers`` specials, ``-name`` negation.
``TPURPC_TRACE`` / ``TPURPC_VERBOSITY`` are read first, falling back to the ``GRPC_*``
names so reference debugging habits carry over.

A copy of ``tpurpc/utils/trace.py``. The registry is the port's own: a flag
made here is not listed by the reference's ``list_tracers`` and the other
way round, and each package's ``reapply_env`` re-reads only its own flags.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict

_registry: Dict[str, "TraceFlag"] = {}
_registry_lock = threading.Lock()


class TraceFlag:
    """A named boolean tracing switch; cheap to test on hot paths."""

    __slots__ = ("name", "enabled")

    def __init__(self, name: str, default: bool = False):
        self.name = name
        self.enabled = default
        with _registry_lock:
            _registry[name] = self
        _apply_env_to(self)

    def __bool__(self) -> bool:
        if _list_pending:
            _print_tracers()
        return self.enabled

    def log(self, fmt: str, *args) -> None:
        if _list_pending:
            _print_tracers()
        if self.enabled:
            _emit("TRACE", f"[{self.name}] " + (fmt % args if args else fmt))


#: a ``list_tracers`` token was seen in the trace spec and the registry
#: dump hasn't printed yet — flushed on the first flag USE (by then the
#: process's flags are registered), mirroring the reference's
#: ``GRPC_TRACE=list_tracers`` one-shot listing (trace.cc LogAllTracers)
_list_pending = False


def _trace_spec() -> str:
    from tpurpc_torch.utils.config import _env

    return _env("TPURPC_TRACE", "GRPC_TRACE") or ""


def _print_tracers() -> None:
    global _list_pending
    _list_pending = False
    with _registry_lock:
        flags = sorted(_registry.items())
    _emit("INFO", "available tracers:")
    for name, f in flags:
        _emit("INFO", f"  {name}: {'on' if f.enabled else 'off'}")


def _apply_env_to(flag: TraceFlag) -> None:
    global _list_pending
    spec = _trace_spec()
    if not spec:
        return
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok == "list_tracers":
            _list_pending = True
            continue
        neg = tok.startswith("-")
        name = tok[1:] if neg else tok
        if name == "all" or name == flag.name:
            flag.enabled = not neg


def reapply_env() -> None:
    """Re-read the trace env for every registered flag (tests use this)."""
    global _list_pending
    _list_pending = False
    with _registry_lock:
        flags = list(_registry.values())
    for f in flags:
        f.enabled = False
        _apply_env_to(f)


def list_tracers() -> Dict[str, bool]:
    with _registry_lock:
        return {name: f.enabled for name, f in _registry.items()}


# --- leveled logging (ref: gpr_log + GRPC_VERBOSITY, src/core/lib/gpr/log.cc) ---

_LEVELS = {"DEBUG": 0, "INFO": 1, "ERROR": 2, "NONE": 3}


def _verbosity() -> int:
    from tpurpc_torch.utils.config import _env

    raw = (_env("TPURPC_VERBOSITY", "GRPC_VERBOSITY") or "ERROR").upper()
    return _LEVELS.get(raw, 2)


def _emit(level: str, msg: str) -> None:
    # ONE wall-clock read for the whole stamp: deriving the seconds and the
    # sub-second fraction from separate reads tears across a second boundary
    # (…:01.999 followed by …:01.000042). Log stamps are absolute times for
    # humans; anything computing durations uses time.monotonic().
    now = time.time()  # tpr: allow(wallclock)
    ts = time.strftime("%H:%M:%S", time.localtime(now))
    tid = threading.get_ident() & 0xFFFF
    print(f"{level[0]}{ts}.{int(now * 1e6) % 1000000:06d} {tid:5d} {msg}",
          file=sys.stderr, flush=True)


def log_debug(fmt: str, *args) -> None:
    if _verbosity() <= 0:
        _emit("DEBUG", fmt % args if args else fmt)


def log_info(fmt: str, *args) -> None:
    if _verbosity() <= 1:
        _emit("INFO", fmt % args if args else fmt)


def log_error(fmt: str, *args) -> None:
    if _verbosity() <= 2:
        _emit("ERROR", fmt % args if args else fmt)


# Fork-equivalent flags (SURVEY.md §5 "Tracing").
trace_ring = TraceFlag("ring")            # ref flag: "rdma" (endpoint.cc:31)
trace_ring_event = TraceFlag("ring_event")  # ref: "rdma_sr_event"
trace_endpoint = TraceFlag("endpoint")
trace_http2 = TraceFlag("http2")          # ref: "http" chttp2 trace
trace_rpc = TraceFlag("rpc")              # ref: "api"/"call_error" surface traces
trace_tpu = TraceFlag("tpu")              # new: device-ring path
