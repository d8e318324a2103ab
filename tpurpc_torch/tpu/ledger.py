"""Copy ledger: byte-exact accounting of host memcpys and DMAs per path.

A copy of ``tpurpc/tpu/ledger.py``. Every data-plane layer reports its copies
here, so "zero-copy" is a measured claim:

* ``host_copy``  — CPU memcpy between two host buffers
* ``dma_h2d``    — host buffer → device memory
* ``dma_d2h``    — device memory → host buffer
* ``dma_d2d``    — device → device movement (ring landing write, a wrapped
                   view's gather, a copied view)
* ``zero_copy``  — payload bytes delivered by aliasing: no bytes moved
* ``rdma_write`` — one-sided placement into a peer's landing region

Counters are process-wide and monotonic; :func:`track` snapshots a window.
They live in the metrics registry (:mod:`tpurpc_torch.obs.metrics`) as
``ledger_<kind>`` and ``ledger_<kind>_ops``, so one store feeds both faces;
a registry ``reset()`` zeroes them too, so measure deltas, never totals.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

from tpurpc_torch.obs import metrics as _metrics

_KINDS = ("host_copy", "dma_h2d", "dma_d2h", "dma_d2d", "zero_copy",
          "rdma_write")

_lock = threading.Lock()
#: the store is the metrics registry: one counter per kind (bytes) and one
#: per kind's op count (one per reported movement, so "this placement was
#: exactly ONE device write" is assertable), named ``ledger_<key>``
_counters: Dict[str, _metrics.Counter] = {
    key: _metrics.counter(f"ledger_{key}")
    for key in _KINDS + tuple(k + "_ops" for k in _KINDS)}


def add(kind: str, nbytes: int) -> None:
    if nbytes:
        with _lock:
            _counters[kind].inc(nbytes)
            _counters[kind + "_ops"].inc()


def host_copy(nbytes: int) -> None:
    add("host_copy", nbytes)


def dma_h2d(nbytes: int) -> None:
    add("dma_h2d", nbytes)


def dma_d2h(nbytes: int) -> None:
    add("dma_d2h", nbytes)


def dma_d2d(nbytes: int) -> None:
    add("dma_d2d", nbytes)


def zero_copy(nbytes: int) -> None:
    add("zero_copy", nbytes)


def rdma_write(nbytes: int) -> None:
    add("rdma_write", nbytes)


def snapshot() -> Dict[str, int]:
    with _lock:
        return {k: c.value for k, c in _counters.items()}


def reset() -> None:
    with _lock:
        for c in _counters.values():
            c.reset()


class Window:
    """Counter deltas over a tracked region."""

    def __init__(self, start: Dict[str, int]):
        self._start = start
        self.delta: Dict[str, int] = {}

    def close(self, end: Dict[str, int]) -> None:
        self.delta = {k: end[k] - self._start[k] for k in end}

    def __getitem__(self, k: str) -> int:
        return self.delta[k]


_active_windows = 0


def tracking() -> bool:
    """True while any ``track()`` window is open. Fast paths that bypass
    the instrumented Python data plane (the channel's native fast paths)
    consult this and step aside: a copy-ledger measurement must measure
    the path whose copies the ledger counts."""
    return _active_windows > 0


@contextlib.contextmanager
def track():
    """``with ledger.track() as w: ...`` → ``w["host_copy"]`` etc."""
    global _active_windows
    w = Window(snapshot())
    with _lock:
        _active_windows += 1
    try:
        yield w
    finally:
        with _lock:
            _active_windows -= 1
        w.close(snapshot())
