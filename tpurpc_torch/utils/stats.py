"""Profiling spans and counters: a copy of ``tpurpc/utils/stats.py``.

Named spans (``with profile("op"):``) accumulate per thread into
log-bucketed histograms while ``TPURPC_PROFILING`` (or ``GRPC_PROFILING``)
is on, and print as a table (:func:`print_table`); batch histograms,
counters and a by-category copy ledger are façades over the metrics
registry (:mod:`tpurpc_torch.obs.metrics`).
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def _enabled() -> bool:
    from tpurpc_torch.utils.config import _env

    return (_env("TPURPC_PROFILING", "GRPC_PROFILING") or "").lower() in (
        "1", "true", "micro", "on")


class _Hist:
    """Tiny log-bucketed latency histogram (stand-in for HdrHistogram_c)."""

    __slots__ = ("buckets", "count", "total_ns", "max_ns")

    def __init__(self):
        self.buckets = [0] * 64
        self.count = 0
        self.total_ns = 0
        self.max_ns = 0

    def record(self, ns: int) -> None:
        self.count += 1
        self.total_ns += ns
        if ns > self.max_ns:
            self.max_ns = ns
        self.buckets[min(63, max(0, ns.bit_length()))] += 1

    def percentile(self, q: float) -> float:
        """Log-bucketed percentile with within-bucket interpolation.

        Bucket ``i`` holds values whose bit_length is ``i``, i.e. the
        half-open range ``[2^(i-1), 2^i)``. The old behavior returned the
        bucket's UPPER bound, so a reported p50/p99 could run ~2x high;
        interpolating linearly inside the bucket keeps the error within
        the bucket's own resolution."""
        if self.count == 0:
            return 0.0
        target = math.ceil(self.count * q)
        seen = 0
        for i, n in enumerate(self.buckets):
            if not n:
                continue
            if seen + n >= target:
                lo = 0.0 if i == 0 else float(1 << (i - 1))
                hi = float(1 << i)
                frac = (target - seen) / n
                return min(lo + frac * (hi - lo), float(self.max_ns))
            seen += n
        return float(self.max_ns)


class _ThreadSlots(threading.local):
    def __init__(self):
        self.slots: Dict[str, _Hist] = defaultdict(_Hist)
        self.registered = False


_tls = _ThreadSlots()
_all_slots_lock = threading.Lock()
_all_slots: List[Dict[str, _Hist]] = []
_force_enabled: Optional[bool] = None


def enable(on: Optional[bool] = True) -> None:
    """Programmatic switch (None returns control to ``TPURPC_PROFILING``)."""
    global _force_enabled
    _force_enabled = on


def profiling_on() -> bool:
    return _force_enabled if _force_enabled is not None else _enabled()


class profile:
    """``with profile("op"):`` span — the ``GRPCProfiler`` RAII equivalent."""

    __slots__ = ("op", "t0")

    def __init__(self, op: str):
        self.op = op
        self.t0 = 0

    def __enter__(self):
        if profiling_on():
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.t0:
            if not _tls.registered:
                with _all_slots_lock:
                    _all_slots.append(_tls.slots)
                _tls.registered = True
            _tls.slots[self.op].record(time.perf_counter_ns() - self.t0)
            self.t0 = 0
        return False


def snapshot() -> Dict[str, Tuple[int, float, float, float]]:
    """op → (count, mean_us, p50_us, p99_us) merged across threads."""
    merged: Dict[str, _Hist] = defaultdict(_Hist)
    with _all_slots_lock:
        slot_dicts = list(_all_slots)
    for slots in slot_dicts:
        # Other threads keep recording while we read; retry if the dict resizes
        # under us.  Slightly torn counts are fine for stats; crashing is not.
        for _ in range(5):
            try:
                items = list(slots.items())
                break
            except RuntimeError:
                continue
        else:
            items = []
        for op, h in items:
            m = merged[op]
            m.count += h.count
            m.total_ns += h.total_ns
            m.max_ns = max(m.max_ns, h.max_ns)
            for i, n in enumerate(h.buckets):
                m.buckets[i] += n
    return {
        op: (
            h.count,
            (h.total_ns / h.count / 1e3) if h.count else 0.0,
            h.percentile(0.5) / 1e3,
            h.percentile(0.99) / 1e3,
        )
        for op, h in merged.items()
    }


def print_table() -> str:
    """The profile spans as an ASCII table (printed and returned)."""
    rows = snapshot()
    if not rows:
        return "(no profiling data)"
    header = f"{'op':<32} {'count':>10} {'mean(us)':>10} {'p50(us)':>10} {'p99(us)':>10}"
    lines = [header, "-" * len(header)]
    for op in sorted(rows):
        c, mean, p50, p99 = rows[op]
        lines.append(f"{op:<32} {c:>10} {mean:>10.2f} {p50:>10.1f} {p99:>10.1f}")
    out = "\n".join(lines)
    print(out)
    return out


# ---------------------------------------------------------------------------
# Batch + wakeup counters — the batched receive pipeline's observability.
#
# Always on (unlike the profile spans): one lock-guarded integer bump per
# BATCH, which is exactly the amortization the pipeline exists to buy — if
# these counters were per-message they would be part of the problem they
# measure. The bench reads them to report batch_msgs_per_wakeup and the
# adaptive poller's spin/sleep ratio.
#
# The STORE is the metrics registry (tpurpc_torch/obs/metrics.py): these
# functions are a façade over it, with no parallel bookkeeping behind them.
# ---------------------------------------------------------------------------

from tpurpc_torch.obs import metrics as _metrics  # noqa: E402

#: compat alias: BatchHist is the registry's exact-count histogram
BatchHist = _metrics.Histogram


def batch_hist(name: str) -> "_metrics.Histogram":
    """Named batch-size histogram (created on first use). Canonical names:
    ``ring_drain`` (messages per receive drain), ``ring_write`` (messages
    per gathered send batch), ``h2_data_coalesce`` (DATA frames merged per
    dispatch), ``resp_coalesce`` (responses per gathered server writev),
    ``fanin_batch`` (rows per dispatched fan-in batch)."""
    return _metrics.histogram(name, kind="size")


def counter_inc(name: str, n: int = 1) -> None:
    """Bump a named monotonic counter. Canonical names: ``wait_spin_hit`` /
    ``wait_spin_miss`` (hybrid busy window fired / expired), ``wait_sleep``
    (waiter parked on fds), ``poller_scan_hot`` / ``poller_scan_idle``
    (background scans that found / did not find work)."""
    _metrics.counter(name).inc(n)


def counters_snapshot() -> Dict[str, int]:
    return _metrics.registry().counters_snapshot()


def batch_snapshot() -> Dict[str, Dict[str, float]]:
    return _metrics.registry().histograms_snapshot()


def reset_batch_stats() -> None:
    """Zero the registry's histograms/counters (bench round isolation)."""
    _metrics.reset()


# ---------------------------------------------------------------------------
# Copy ledger by category, folded onto the metrics registry: each category
# is a registry counter named ``copyledger_<category>``, so an export sees
# the same numbers with zero duplicate accounting.
# ---------------------------------------------------------------------------

class CopyLedger:
    """Counts bytes moved by each mechanism on the hot paths.

    Categories:
      host_copy      — CPU memcpy through host DRAM (what we are eliminating)
      device_dma     — NIC/DMA bytes landing directly in device memory
      device_alias   — bytes surfaced zero-copy (aliased, no move at all)
      host_staged    — bytes bounced host→device because true DMA is unavailable
    """

    CATEGORIES = ("host_copy", "device_dma", "device_alias", "host_staged")

    def __init__(self):
        self._counters = {c: _metrics.counter(f"copyledger_{c}")
                          for c in self.CATEGORIES}

    def add(self, category: str, nbytes: int) -> None:
        c = self._counters.get(category)
        if c is None:
            raise ValueError(
                f"unknown copy-ledger category {category!r}; "
                f"expected one of {self.CATEGORIES}")
        c.inc(nbytes)

    def reset(self) -> None:
        for c in self._counters.values():
            c.reset()

    def as_dict(self) -> Dict[str, int]:
        return {name: c.snapshot() for name, c in self._counters.items()}

    def __getattr__(self, name: str) -> int:
        counters = self.__dict__.get("_counters") or {}
        if name in counters:
            return counters[name].snapshot()
        raise AttributeError(name)


ledger = CopyLedger()
