"""Process-wide timer wheel: one thread for every scheduled deadline.

A copy of ``tpurpc/utils/timers.py``, with this package's own wheel. The
standard library's ``Timer`` spawns a thread per timer, which a hot path
cannot afford; here every deadline in the process sits on one heap serviced by
one thread:

    handle = schedule(0.3, fn)   # fn() on the wheel thread after 0.3 s
    handle.cancel()              # best effort; a no-op once fired

Callbacks run on the single wheel thread and must be short and must not
block: work that writes to an endpoint goes through :func:`run_blocking`.
An exception in a callback is printed to stderr and swallowed, so one bad
callback cannot stop every timer in the process.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
import traceback
from typing import Callable, Optional


class TimerHandle:
    """Cancellation is flag-based (the heap entry stays until its deadline)
    but the callback reference is dropped EAGERLY: a cancelled 2-hour
    keepalive timer must not pin its connection closure (endpoint, buffers)
    for 2 hours."""

    __slots__ = ("cancelled", "fn")

    def __init__(self, fn: Callable[[], None]):
        self.cancelled = False
        self.fn: Optional[Callable[[], None]] = fn

    def cancel(self) -> None:
        self.cancelled = True
        self.fn = None  # release the closure (and everything it captures)


class TimerWheel:
    _instance: "Optional[TimerWheel]" = None
    _instance_lock = threading.Lock()

    @classmethod
    def get(cls) -> "TimerWheel":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = TimerWheel()
            return cls._instance

    def __init__(self):
        self._cond = threading.Condition()
        self._heap: list = []
        self._seq = itertools.count()  # tie-break: heap never compares fns
        self._thread: Optional[threading.Thread] = None

    def schedule(self, delay_s: float, fn: Callable[[], None]) -> TimerHandle:
        handle = TimerHandle(fn)
        when = time.monotonic() + max(0.0, delay_s)
        with self._cond:
            heapq.heappush(self._heap, (when, next(self._seq), handle))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                name="tpurpc-torch-timers")
                self._thread.start()
            self._cond.notify()
        return handle

    def _run(self) -> None:
        while True:
            with self._cond:
                while True:
                    now = time.monotonic()
                    if not self._heap:
                        # park until new work (bounded: a dead wheel thread
                        # is restarted by schedule(), but don't exit eagerly
                        # and churn threads under bursty load)
                        self._cond.wait(timeout=60.0)
                        if not self._heap:
                            return  # idle a full minute: let the thread go
                        continue
                    when = self._heap[0][0]
                    if when <= now:
                        _, _, handle = heapq.heappop(self._heap)
                        break
                    self._cond.wait(timeout=when - now)
            fn = handle.fn
            if handle.cancelled or fn is None:
                continue
            try:
                fn()
            except Exception:
                traceback.print_exc()


def schedule(delay_s: float, fn: Callable[[], None]) -> TimerHandle:
    """Module-level convenience over the singleton wheel."""
    return TimerWheel.get().schedule(delay_s, fn)


_blocking_pool = None
_blocking_lock = threading.Lock()


def run_blocking(fn: Callable[[], None]) -> None:
    """Run ``fn`` off the wheel thread (small shared daemon pool).

    Wheel callbacks must not block — but timer-driven WORK often does
    (keepalive PINGs and GOAWAYs are endpoint writes that can stall on
    transport backpressure; teardown closes fds). One blocked send on the
    wheel would freeze every timer in the process; here it occupies one of
    a few shared workers instead (still bounded, still not per-connection
    threads)."""
    global _blocking_pool
    with _blocking_lock:
        if _blocking_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _blocking_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="tpurpc-torch-timerio")
        pool = _blocking_pool
    pool.submit(fn)
