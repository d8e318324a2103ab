"""Device-resident receive ring: tensor payloads live in device memory and
consumers get lease-backed device views.

The port of ``tpurpc/tpu/hbm_ring.py``. The credit algebra is the
reference's: power-of-two capacity, monotonic ``tail``/``head``, a ``_live``
map from span to ``[count, consumed]``, a timed wait for space, a head that
advances only over a consumed prefix, zero-size spans that never enter
``_live``, a poison view that undoes its count, and region leases that can
be released unfilled.

The device parts, on a CUDA card (or the CPU when asked for):

* ``place`` / ``place_many`` / ``fill`` — one host→device copy into a
  staging tensor (ledger ``dma_h2d``), then ONE landing write into the ring
  (``dma_d2d``): ``ring[p:p+n].copy_(staged)`` for an unwrapped span, the
  ``ring_scatter`` kernel for a span across the wrap point. The staging copy
  completes before ``place`` returns, so the caller may reuse its host
  buffer at once.
* ``view`` — an unwrapped span is a slice of the ring reinterpreted with
  ``.view(dtype).reshape(shape)``: a real alias (ledger ``zero_copy``,
  ``aliased=True`` on the lease, checked with ``data_ptr()``). A span whose
  offset is not a multiple of the dtype's size is copied (``dma_d2d``). A
  wrapped span is gathered by the ``ring_window`` kernel (``dma_d2d``).

Placement, the kernels and the consumer all run on the calling thread's
current CUDA stream, so reads are ordered after the landing write. A
consumer may read its view on another stream: it releases the lease on the
stream that read it, ``release`` records a CUDA event there against the
span, and the landing write that next covers any byte of the span makes its
stream wait on that event first. The ring is one allocation for its whole
life (no donation), and ``place`` asserts that ``data_ptr()`` never
changes.

Observability, under the reference's names: the ``hbm_place_msgs`` and
``hbm_place_bytes`` counters and the ``hbm`` lens hop (one set of bumps
per ``place``/``place_many``/``fill``; its busy time is the host's dispatch
time of the landing, as in the reference, since no hook waits on the
device), the ``hbm_ring_occupancy_bytes`` fleet gauge (the host's ``tail -
head``, read at scrape time), and the ``hbm-place`` (``place``,
``place_many``, ``_land_locked``) and ``device-dispatch`` (``view``)
profiler stages.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpurpc_torch.obs import lens as _lens
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.ops.ring_scatter import ring_scatter
from tpurpc_torch.ops.ring_window import ring_window
from tpurpc_torch.tpu import ledger
from tpurpc_torch.utils.buffers import as_u8, host_tensor
from tpurpc_torch.utils.config import resolve_device


# device-ring placement totals (one add per placement batch) and the
# scrape-time occupancy of live rings
_HBM_PLACE_MSGS = _metrics.counter("hbm_place_msgs")
_HBM_PLACE_BYTES = _metrics.counter("hbm_place_bytes")
_HBM_RINGS = _metrics.fleet("hbm_ring_occupancy_bytes",
                            lambda r: r.tail - r.head)

# the `hbm` lens hop: bytes landed in the device ring and the host time the
# placement's dispatch took. The landing stages host -> device (dma_h2d),
# so every placed byte is also a copy byte
_LENS_HBM_BYTES, _LENS_HBM_NS, _LENS_HBM_COPY = _lens.hop_counters("hbm")

_LENS_STAGES = {
    "place": "hbm-place",
    "place_many": "hbm-place",
    "_land_locked": "hbm-place",
    "view": "device-dispatch",
}
_profiler.register_stages(__file__, _LENS_STAGES)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a numpy dtype-like."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class HbmRing:
    """Byte ring in device memory with host-tracked head/tail + leases."""

    def __init__(self, capacity: int, device=None):
        if capacity < 64 or capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two >= 64")
        self.capacity = capacity
        self._mask = capacity - 1
        self.device = resolve_device(device)
        self.buf = torch.zeros(capacity, dtype=torch.uint8, device=self.device)
        #: the ring's address; views alias it, so it must never move
        self._base_ptr = self.buf.data_ptr()
        self.tail = 0   # absolute bytes ever placed
        self.head = 0   # absolute bytes ever freed
        self._lock = threading.Lock()
        #: signaled whenever the head advances (space became writable)
        self._space = threading.Condition(self._lock)
        #: span -> [outstanding leases, ever_released]
        self._live: Dict[Tuple[int, int], list] = {}
        #: outstanding leases whose tensor aliases ring memory
        self._aliased = 0
        #: (start, end, event) of released spans, absolute bytes: the last
        #: reads of [start, end) are done once the CUDA event has completed
        self._reads: list = []
        _HBM_RINGS.track(self)

    # -- producer ------------------------------------------------------------

    def writable(self) -> int:
        return self.capacity - (self.tail - self.head)

    def _wait_space_locked(self, n: int, timeout: Optional[float]) -> None:
        """Block up to ``timeout`` for ``n`` writable bytes (caller holds the
        lock); ``timeout=None`` fails at once. Raises BufferError."""
        if n > self.writable() and timeout is not None:
            deadline = time.monotonic() + timeout
            while n > self.writable():
                remain = deadline - time.monotonic()
                if remain <= 0 or not self._space.wait(timeout=remain):
                    break
        if n > self.writable():
            raise BufferError(f"HBM ring full: {n} > {self.writable()}")

    def _land_locked(self, src: np.ndarray, off: int) -> None:
        """One host→device staging copy, then one landing write at absolute
        offset ``off`` (caller holds the lock). Before the landing write,
        its stream waits on the release events of every span whose bytes it
        covers, both segments of a wrapped write included."""
        n = src.nbytes
        p = off & self._mask
        staged = torch.empty(n, dtype=torch.uint8, device=self.device)
        staged.copy_(host_tensor(src))
        ledger.dma_h2d(n)
        if self._reads:
            # after the staging copy, which waits for the host: the wait is
            # the device's alone. The bytes at [off, off + n) last held
            # [off - cap, off + n - cap)
            lo, hi = off - self.capacity, off + n - self.capacity
            stream = torch.cuda.current_stream(self.device)
            for start, end, event in self._reads:
                if start < hi and end > lo:
                    stream.wait_event(event)
            # a span wholly written over is never covered again
            self._reads = [r for r in self._reads if r[1] > hi]
        if p + n <= self.capacity:
            self.buf[p:p + n].copy_(staged)
        else:
            ring_scatter(self.buf, staged, p)
        ledger.dma_d2d(n)
        self._assert_stable()

    def place(self, payload, timeout: Optional[float] = None) -> Tuple[int, int]:
        """Copy one payload into the ring; returns its (offset, nbytes) span.

        Blocks up to ``timeout`` seconds for lease releases to free space;
        with ``timeout=None`` a full ring raises :class:`BufferError` at
        once. A payload larger than the whole ring always raises."""
        src = as_u8(payload)
        n = src.nbytes
        if n == 0:
            # zero-size spans never enter _live: they would all share the
            # key (tail, 0) and corrupt each other's lease counts
            return self.tail, 0
        if n > self.capacity:
            raise BufferError(f"payload {n} exceeds ring capacity {self.capacity}")
        t0 = time.monotonic_ns()
        with self._lock:
            self._wait_space_locked(n, timeout)
            off = self.tail
            self.tail += n
            self._live[(off, n)] = [0, False]
            self._land_locked(src, off)
        _note_landing(1, n, time.monotonic_ns() - t0)
        return off, n

    def place_many(self, payloads,
                   timeout: Optional[float] = None) -> "list[Tuple[int, int]]":
        """Copy a BATCH of payloads into the ring with one staging copy and
        one landing write. The payloads pack host-side into one image;
        returns the per-payload ``(offset, nbytes)`` spans, each leased and
        credited on its own exactly as if placed by :meth:`place` back to
        back. Flow control treats the batch as one unit."""
        srcs = [as_u8(p) for p in payloads]
        lens = [s.nbytes for s in srcs]
        total = sum(lens)
        if total == 0:
            return [(self.tail, 0) for _ in srcs]
        if total > self.capacity:
            raise BufferError(
                f"batch of {total} bytes exceeds ring capacity {self.capacity}")
        t0 = time.monotonic_ns()
        with self._lock:
            self._wait_space_locked(total, timeout)
            off = self.tail
            self.tail += total
            spans = []
            for n in lens:
                if n:  # zero-size spans hold no credit (see place())
                    self._live[(off, n)] = [0, False]
                spans.append((off, n))
                off += n
            packed = np.concatenate(srcs) if len(srcs) > 1 else srcs[0]
            self._land_locked(packed, spans[0][0])
        _note_landing(len(spans), total, time.monotonic_ns() - t0)
        return spans

    def _assert_stable(self) -> None:
        """Views alias the ring's address: it must never move."""
        now = self.buf.data_ptr()
        if now != self._base_ptr:
            raise RuntimeError(f"device ring moved ({self._base_ptr:#x} -> "
                               f"{now:#x}) with {self._aliased} aliased "
                               "lease(s) outstanding")

    # -- consumer ------------------------------------------------------------

    def view(self, off: int, n: int, dtype=np.uint8,
             shape: Optional[tuple] = None) -> "HbmLease":
        """Device view of a placed span; pins it until the lease is released.

        ``dtype`` is a torch dtype or a numpy dtype-like. An unwrapped span
        whose offset suits the dtype is an alias of the ring (ledger
        ``zero_copy``); any other span is copied on the device
        (``dma_d2d``)."""
        dt = _torch_dtype(dtype)
        if n == 0:
            empty = torch.zeros(0, dtype=dt, device=self.device)
            return HbmLease(self, off, 0, empty.reshape(
                shape if shape is not None else (0,)))
        with self._lock:
            if (off, n) not in self._live:
                raise KeyError(f"span ({off}, {n}) not live")
            self._live[(off, n)][0] += 1
            # Everything between the count increment and the HbmLease
            # hand-off must UNDO the increment on failure, or a poison view
            # (bad dtype/shape vs nbytes — wire-reachable through the
            # decoder's header) pins the span's credit forever.
            try:
                p = off & self._mask
                if p + n > self.capacity:   # wrapped: one kernel gather
                    raw = ring_window(self.buf, p, n)
                elif p % dt.itemsize == 0:  # unwrapped: alias the ring
                    raw = self.buf[p:p + n]
                else:                       # misaligned for dt: copy
                    raw = self.buf[p:p + n].clone()
                aliased = raw.data_ptr() == self._base_ptr + p
                if aliased:
                    self._aliased += 1
            except BaseException:
                self._live[(off, n)][0] -= 1
                self._advance_locked()  # cnt may now be 0 on a consumed span
                raise
        try:
            arr = raw.view(dt) if dt != torch.uint8 else raw
            arr = arr.reshape(shape if shape is not None else (-1,))
        except BaseException:
            # failed shaping does NOT consume the span (another consumer may
            # still take a correct view of it)
            self._release(off, n, aliased, consumed=False)
            raise
        if aliased:
            ledger.zero_copy(n)
        else:
            ledger.dma_d2d(n)
        return HbmLease(self, off, n, arr, aliased=aliased)

    def _release(self, off: int, n: int, aliased: bool = False, *,
                 consumed: bool = True) -> None:
        """Return one lease's credit. ``consumed=False`` (error unwinding)
        decrements without marking the span consumed. On a card, records an
        event on the calling thread's current stream, which the next landing
        write over the span waits on."""
        if n == 0:
            return  # zero-size spans hold no credit (never entered _live)
        with self._lock:
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
                self._reads.append((off, off + n, event))
            if aliased:
                self._aliased -= 1
            entry = self._live[(off, n)]
            entry[0] -= 1
            if consumed:
                entry[1] = True
            if entry[0] > 0:
                return
            self._advance_locked()

    def _advance_locked(self) -> None:
        """Advance head over every consumed (leased-and-released) prefix.
        Caller holds ``self._lock``."""
        advanced = False
        while self._live:
            first_key = min(self._live)
            cnt, consumed = self._live[first_key]
            if first_key[0] != self.head or cnt > 0 or not consumed:
                break
            del self._live[first_key]
            self.head += first_key[1]
            advanced = True
        if advanced:
            self._space.notify_all()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"capacity": self.capacity, "head": self.head,
                    "tail": self.tail, "live_spans": len(self._live),
                    "writable": self.writable()}

    # -- rendezvous landing leases --------------------------------------------

    def lease_region(self, nbytes: int,
                     timeout: Optional[float] = None) -> "HbmRegionLease":
        """Reserve a ring span as a landing region: credit held, placement
        deferred to :meth:`HbmRegionLease.fill`. Release without fill returns
        the credit. Blocks up to ``timeout`` for credit like :meth:`place`."""
        if nbytes <= 0:
            raise ValueError("lease_region needs a positive size")
        if nbytes > self.capacity:
            raise BufferError(
                f"payload {nbytes} exceeds ring capacity {self.capacity}")
        with self._lock:
            self._wait_space_locked(nbytes, timeout)
            off = self.tail
            self.tail += nbytes
            self._live[(off, nbytes)] = [0, False]
        return HbmRegionLease(self, off, nbytes)

    def _fill_span(self, off: int, nbytes: int, payload) -> None:
        """Land ``payload`` into a reserved span: one staging copy + one
        landing write, the ledger accounting of :meth:`place`."""
        src = as_u8(payload)
        if src.nbytes != nbytes:
            raise ValueError(f"fill of {src.nbytes} bytes into a "
                             f"{nbytes}-byte lease")
        t0 = time.monotonic_ns()
        with self._lock:
            if (off, nbytes) not in self._live:
                raise KeyError(f"span ({off}, {nbytes}) not live")
            self._land_locked(src, off)
        _note_landing(1, nbytes, time.monotonic_ns() - t0)


def _note_landing(msgs: int, nbytes: int, dt: int) -> None:
    """The landing's counters and `hbm` hop: plain adds, no device wait."""
    _HBM_PLACE_MSGS.inc(msgs)
    _HBM_PLACE_BYTES.inc(nbytes)
    _LENS_HBM_BYTES.inc(nbytes)
    _LENS_HBM_NS.inc(dt)
    _LENS_HBM_COPY.inc(nbytes)


class HbmLease:
    """A device view pinning its ring span; release returns the credit.

    ``release()`` is idempotent; dropping the lease without releasing leaks
    the span (credits are explicit, never returned by the GC)."""

    __slots__ = ("_ring", "_off", "_n", "array", "_released", "aliased")

    def __init__(self, ring: HbmRing, off: int, n: int, array: torch.Tensor,
                 aliased: bool = False):
        self._ring = ring
        self._off = off
        self._n = n
        self.array = array
        #: True when ``array`` aliases ring memory: valid only until release,
        #: after which the span may be overwritten in place. Copied views
        #: (False) survive release.
        self.aliased = aliased
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._ring._release(self._off, self._n, self.aliased)

    def __enter__(self):
        return self.array

    def __exit__(self, *exc):
        self.release()
        return False


class HbmRegionLease:
    """A reserved-but-unfilled ring span (see :meth:`HbmRing.lease_region`):
    claim → :meth:`fill` → :meth:`view` → :meth:`release`; release without
    fill returns the credit."""

    __slots__ = ("ring", "offset", "nbytes", "filled", "_released")

    def __init__(self, ring: HbmRing, offset: int, nbytes: int):
        self.ring = ring
        self.offset = offset
        self.nbytes = nbytes
        self.filled = False
        self._released = False

    def fill(self, payload) -> None:
        """Land the payload: one dma_h2d + one in-ring landing write."""
        if self._released:
            raise RuntimeError("lease already released")
        self.ring._fill_span(self.offset, self.nbytes, payload)
        self.filled = True

    def view(self, dtype=np.uint8, shape: Optional[tuple] = None
             ) -> HbmLease:
        """Device view of the landed payload. Only valid after fill."""
        if not self.filled:
            raise RuntimeError("view before fill: the landing write has "
                               "not happened")
        return self.ring.view(self.offset, self.nbytes, dtype=dtype,
                              shape=shape)

    def release(self) -> None:
        """Return the span's credit (idempotent). An unfilled release marks
        the span consumed so the head can advance over it."""
        if self._released:
            return
        self._released = True
        with self.ring._lock:
            entry = self.ring._live.get((self.offset, self.nbytes))
            if entry is None:
                return
            entry[1] = True  # consumed (possibly without any fill/view)
            if entry[0] == 0:
                self.ring._advance_locked()
