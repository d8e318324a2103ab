"""Bounded MPMC handoff ring: the shard → device-merger boundary.

A copy of ``tpurpc/core/handoff.py``. Per-shard batchers publish ready
sub-batches toward the device without contending on a shared mutex. This is
the classic bounded MPMC queue in the Vyukov style, specialized to N
producers (one per batcher shard) and ONE consumer (the device merger):

* each slot carries a **sequence stamp** ``_seq[i]`` (initialized to ``i``);
* a producer **claims** a ticket ``t`` with one ``next()`` on an
  ``itertools.count`` — a single GIL-atomic step, the Python analog of
  ``fetch_add`` (the claim is the whole MPMC subtlety: two producers must
  never own one slot);
* the producer waits for ``_seq[slot] == t`` (the slot's previous lap has
  been consumed), stores the payload, then **commits** with
  ``_seq[slot] = t + 1`` — the commit stamp is the only publish gate, stored
  strictly after the payload;
* the single consumer takes slots in ticket order, gated on
  ``_seq[slot] == head + 1`` (reading without the gate would read an
  uncommitted payload), and frees the slot for lap N+1 with
  ``_seq[slot] = head + capacity``.

The reference's model checker (``check_handoff`` in its
``analysis/ringcheck.py``) interleaves two producers against the merger over
this exact protocol.

Events here are WAKEUPS only (a parked peer learns the state changed), never
guards: every ordering claim rests on the stamp protocol above. A full ring
blocks the producer — that is the backpressure path, deliberately cold.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

__all__ = ["HandoffRing"]


class HandoffRing:
    """N-producer / 1-consumer bounded handoff (see module docstring).

    ``publish`` is the shard-side hot path: one atomic ticket claim, one
    list store, one stamp store, one event set. ``take``/``take_ready`` are
    consumer-only — exactly one thread (the merger) may call them.
    """

    def __init__(self, capacity: int = 64):
        if capacity < 2:
            raise ValueError("handoff ring needs capacity >= 2")
        self._cap = capacity
        self._slots: List[object] = [None] * capacity
        #: per-slot sequence stamps — THE protocol (module docstring);
        #: plain-int list stores are GIL-atomic
        self._seq: List[int] = list(range(capacity))
        self._ticket = itertools.count()  # atomic claim: one next() bytecode
        self._head = 0  # consumer-private
        self._data_evt = threading.Event()
        self._space_evt = threading.Event()
        self._closed = False

    def __len__(self) -> int:
        """Approximate occupancy — committed, unconsumed slots in ticket
        order from the consumer head (racy snapshot; load reporting only)."""
        h = self._head
        n = 0
        for off in range(self._cap):
            if self._seq[(h + off) % self._cap] == h + off + 1:
                n += 1
            else:
                break
        return n

    # -- producer side (per-shard batcher threads) ---------------------------

    def publish(self, item, timeout: Optional[float] = None) -> bool:
        """Publish one item; False if the ring closed (or ``timeout`` passed
        while full — backpressure). Safe from any number of threads."""
        t = next(self._ticket)  # atomic claim
        slot = t % self._cap
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._seq[slot] != t:
            # the slot's previous lap is not consumed yet: ring full for
            # THIS producer — park until the merger frees it (cold path)
            if self._closed:
                return False
            if deadline is not None and time.monotonic() >= deadline:
                return False
            self._space_evt.wait(0.01)
            self._space_evt.clear()
        if self._closed:
            return False
        self._slots[slot] = item
        self._seq[slot] = t + 1  # COMMIT: stored strictly after the payload
        self._data_evt.set()
        return True

    # -- consumer side (the device merger thread, singular) ------------------

    def take(self, timeout: Optional[float] = None):
        """Next item in ticket order; None on close-and-drained or timeout."""
        h = self._head
        slot = h % self._cap
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._seq[slot] != h + 1:  # commit gate
            if self._closed:
                return None
            if deadline is not None and time.monotonic() >= deadline:
                return None
            self._data_evt.wait(0.05)
            self._data_evt.clear()
        item, self._slots[slot] = self._slots[slot], None
        self._seq[slot] = h + self._cap  # free the slot for lap N+1
        self._head = h + 1
        self._space_evt.set()
        return item

    def take_ready(self):
        """Non-blocking take: the merger's gather pass (drain whatever the
        other shards already committed). None when nothing is ready."""
        h = self._head
        slot = h % self._cap
        if self._seq[slot] != h + 1:
            return None
        item, self._slots[slot] = self._slots[slot], None
        self._seq[slot] = h + self._cap
        self._head = h + 1
        self._space_evt.set()
        return item

    def close(self) -> None:
        self._closed = True
        self._data_evt.set()
        self._space_evt.set()
