"""Background poller + pair pool — the hybrid (BPEV) wakeup machinery.

A trimmed copy of ``tpurpc/core/poller.py`` (no native spin: a slice
yields once, ROADMAP A7 (a)). Its observability hooks carry the
reference's names: the ``poller_registered_pairs`` fleet gauge, the
``poller_unpark_slotless``, ``poller_scan_hot``/``_idle``,
``wait_spin_*`` and ``wait_sleep`` counters, the ``poller_batch_wakeups``
histogram, the ``POLLER_EV``/``POLLER_BP`` flight edges of a hybrid
waiter's mode flips, and the ``poller-wait`` profiler stage:

* :class:`Poller` — background threads scan registered pairs and kick a
  pair's wakeup pipes on the false→true edge of a watched condition
  (message, resumable write, peer event), all the pairs one sweep finds in
  one burst. Its job is recovery from token loss; waiters are normally
  woken by notify tokens. Each sweep also starts park episodes of pairs
  idle for ``pair_park_s`` (at most 64 a sweep) and watches the notify
  sockets of parked pairs (the parked set), so that an ownerless parked
  pair still sees its peer's WAKE and REARM.
* :func:`batch_pressure` — the EWMA of ready pairs per sweep; above
  ``_BATCH_SPIN_SUPPRESS`` the hybrid waiters skip their spin fleet-wide.
* :func:`wait_readable` / :func:`wait_writable` — the three wakeup
  disciplines: ``busy`` spins, ``event`` blocks on the notify socket and the
  role's pipe, ``hybrid`` spins up to ``busy_polling_timeout_us`` then
  blocks (and skips the spin for pairs whose activity EWMA has decayed).
* :class:`PairPool` — keyed take/putback recycling of pairs.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from tpurpc_torch.core.pair import Pair, PairState, make_domain
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.utils import stats as _stats
from tpurpc_torch.utils.config import get_config
from tpurpc_torch.utils.trace import trace_ring

#: a thread parked or spinning under these functions is in poller-wait
_LENS_STAGES = {
    "_wait": "poller-wait",
    "wait_readable": "poller-wait",
    "wait_writable": "poller-wait",
    "_scan_edges": "poller-wait",
    "_run": "poller-wait",
}
_profiler.register_stages(__file__, _LENS_STAGES)

#: scrape-time gauge: pairs registered with live pollers
_POLLER_PAIRS = _metrics.fleet("poller_registered_pairs",
                               lambda p: p._pair_count)

#: adaptive-spin EWMA: a hit (spin fired / fast wake) pulls the pair's score
#: toward 1, a miss halves it; below the floor the hybrid waiter parks on
#: its fds at once instead of spinning first
_EWMA_HIT_ALPHA = 0.5
_EWMA_MISS_BETA = 0.5
_EWMA_SPIN_FLOOR = 0.1
#: an fd wake this soon after parking counts as "a spin would have caught
#: it" — in multiples of busy_polling_timeout
_HOT_WAKE_MULTIPLE = 4.0

#: batched wakeups: one sweep kicks every ready pair in a burst, and the
#: EWMA of that burst size is the fleet-wide load signal. When sweeps keep
#: finding many ready pairs at once, per-pair busy windows only steal
#: cycles from each other, so hybrid waiters skip them above the threshold
#: (a lost update of this float is one sweep of staleness in a smoothed
#: signal)
_BATCH_ALPHA = 0.3
_BATCH_SPIN_SUPPRESS = 8.0
_batch_ewma = 0.0


def _note_batch(n: int) -> None:
    global _batch_ewma
    _batch_ewma += _BATCH_ALPHA * (n - _batch_ewma)


def batch_pressure() -> float:
    """EWMA of ready pairs per poller sweep."""
    return _batch_ewma


def _ewma_hit(pair: Pair) -> None:
    pair.activity_ewma += _EWMA_HIT_ALPHA * (1.0 - pair.activity_ewma)


def _ewma_miss(pair: Pair) -> None:
    pair.activity_ewma *= _EWMA_MISS_BETA


class Poller:
    """Round-robin scanner kicking wakeup fds (the BPEV background engine)."""

    _instance: Optional["Poller"] = None
    _instance_lock = threading.Lock()

    @classmethod
    def get(cls) -> "Poller":
        """Lazy singleton, started on first use."""
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Poller()
                cls._instance.start()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._instance_lock:
            inst, cls._instance = cls._instance, None
        if inst is not None:
            inst.stop()

    def __init__(self, thread_num: Optional[int] = None):
        cfg = get_config()
        self.thread_num = thread_num or cfg.poller_thread_num
        self.capacity = cfg.poller_capacity
        self.sleep_timeout_s = cfg.poller_sleep_timeout_ms / 1000.0
        self._pairs: List[Optional[Pair]] = []
        self._cv = threading.Condition(threading.Lock())
        self._threads: List[threading.Thread] = []
        self._running = False
        self._pair_count = 0
        # the parked set: notify sockets of parked pairs, polled each sweep.
        # Lock order: _cv before _parked_mu where both are held
        self._parked_mu = threading.Lock()
        self._parked_map: Dict[int, Pair] = {}
        self._parked_sel = None  # a lazy selectors.DefaultSelector
        _POLLER_PAIRS.track(self)

    def add_pollable(self, pair: Pair) -> None:
        with self._cv:
            if self._pair_count >= self.capacity:
                raise RuntimeError(f"poller at capacity ({self.capacity} pairs)")
            for i, slot in enumerate(self._pairs):
                if slot is None:
                    self._pairs[i] = pair
                    break
            else:
                self._pairs.append(pair)
            self._pair_count += 1
            self._cv.notify_all()

    def remove_pollable(self, pair: Pair) -> bool:
        """True when the pair held a slot (a park remembers it, so that the
        unpark restores the registration)."""
        with self._cv:
            for i, slot in enumerate(self._pairs):
                if slot is pair:
                    self._pairs[i] = None
                    self._pair_count -= 1
                    return True
        return False

    # -- the parked set ------------------------------------------------------

    @classmethod
    def note_parked(cls, pair: Pair) -> None:
        """A pair completed its park: free its slot (its scan cost drops to
        zero) and watch its notify socket for the frames that end the
        episode."""
        inst = cls.get()
        pair._poller_was_registered = inst.remove_pollable(pair)
        inst.add_parked(pair)

    @classmethod
    def note_unparked(cls, pair: Pair) -> None:
        inst = cls.get()
        inst.remove_parked(pair)
        if getattr(pair, "_poller_was_registered", False):
            pair._poller_was_registered = False
            try:
                inst.add_pollable(pair)
            except RuntimeError:
                # refilled while parked: tokens and kicks still wake
                _stats.counter_inc("poller_unpark_slotless")

    @classmethod
    def forget_parked(cls, pair: Pair) -> None:
        """Teardown of a parked pair: drop its watcher slot, nothing else."""
        with cls._instance_lock:
            inst = cls._instance
        if inst is not None:
            inst.remove_parked(pair)

    def add_parked(self, pair: Pair) -> None:
        import selectors

        sock = pair.notify_sock
        if sock is None:
            return
        with self._parked_mu:
            if self._parked_sel is None:
                self._parked_sel = selectors.DefaultSelector()
            try:
                fd = sock.fileno()
                self._parked_sel.register(sock, selectors.EVENT_READ, pair)
                self._parked_map[fd] = pair
            except (KeyError, ValueError, OSError):
                return  # already watched, or the socket is closing
        with self._cv:
            self._cv.notify_all()  # leave the zero-pairs long sleep

    def remove_parked(self, pair: Pair) -> None:
        with self._parked_mu:
            sel = self._parked_sel
            if sel is None:
                return
            for fd in [f for f, p in self._parked_map.items() if p is pair]:
                del self._parked_map[fd]
                try:
                    sel.unregister(fd)
                except (KeyError, ValueError, OSError):
                    pass

    def parked_count(self) -> int:
        with self._parked_mu:
            return len(self._parked_map)

    def _scan_parked(self) -> bool:
        """Drain the notify streams of parked pairs (one zero-timeout
        select over all of them); a WAKE or REARM found here runs the
        unpark inline."""
        with self._parked_mu:
            sel = self._parked_sel
            if sel is None or not self._parked_map:
                return False
            try:
                events = sel.select(timeout=0)
            except (OSError, ValueError):
                events = []
            ready = [key.data for key, _ in events]
        hot = False
        for pair in ready:
            try:
                if pair.drain_notifications():
                    pair.kick()
                hot = True
                if (pair.state is not PairState.CONNECTED
                        or not (pair._parked or pair._park_pending)):
                    self.remove_parked(pair)
            except Exception:
                self.remove_parked(pair)
        return hot

    def _park_sweep(self, snapshot: List[Pair], now: float) -> None:
        """Start park episodes of idle registered pairs, at most 64 a
        sweep, so that a fleet gone idle parks over a few sweeps instead of
        one burst of handshakes."""
        park_s = get_config().pair_park_s
        if park_s <= 0:
            return
        budget = 64
        for pair in snapshot:
            if budget <= 0:
                return
            try:
                if pair.maybe_park(now, park_s):
                    budget -= 1
            except Exception:
                pass  # a dying pair; its owner observes the state

    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            self._running = True
        for i in range(self.thread_num):
            t = threading.Thread(target=self._run, name=f"tpurpc-poller-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        trace_ring.log("poller started (%d threads)", self.thread_num)

    def stop(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
        with self._parked_mu:
            sel, self._parked_sel = self._parked_sel, None
            self._parked_map.clear()
        if sel is not None:
            sel.close()  # its epoll fd; the sockets stay their pairs'

    def _run(self) -> None:
        # Adaptive cadence: scans that find work keep a 1 ms interval, idle
        # streaks back off exponentially to poller_sleep_timeout_ms.
        interval = 0.001
        while True:
            with self._cv:
                if not self._running:
                    return
                with self._parked_mu:
                    n_parked = len(self._parked_map)
                if self._pair_count == 0 and n_parked == 0:
                    self._cv.wait(timeout=self.sleep_timeout_s)
                    interval = 0.001
                    continue
                snapshot = [p for p in self._pairs if p is not None]
            # one sweep collects every pair whose watched condition edged,
            # then kicks them all in a burst
            woken: List[Pair] = []
            for pair in snapshot:
                try:
                    if self._scan_edges(pair):
                        woken.append(pair)
                except Exception:
                    pair.kick()  # a dying pair: its owner observes the state
            for pair in woken:
                pair.kick()
            hot = bool(woken)
            if snapshot:
                _note_batch(len(woken))
            if woken:
                _stats.batch_hist("poller_batch_wakeups").record(len(woken))
            if self._scan_parked():
                hot = True
            self._park_sweep(snapshot, time.monotonic())
            if hot:
                _stats.counter_inc("poller_scan_hot")
                interval = 0.001
            else:
                _stats.counter_inc("poller_scan_idle")
                interval = min(interval * 2, self.sleep_timeout_s)
            with self._cv:
                if not self._running:
                    return
                self._cv.wait(timeout=interval)

    @staticmethod
    def _needs_attention(pair: Pair) -> bool:
        """Level check of a pair's watched conditions (the non-consuming
        probe leaves notify tokens for whichever waiter owns them)."""
        if pair.state in (PairState.ERROR, PairState.HALF_CLOSED):
            return True
        if pair.has_message() or pair.has_pending_writes():
            return True
        if pair.peek_events():
            return True
        return pair.state in (PairState.ERROR, PairState.HALF_CLOSED)

    @staticmethod
    def _scan_edges(pair: Pair) -> bool:
        """Kick only on a false→true EDGE of each watched condition (kicks
        are lossless, so one per arrival suffices)."""
        state = (pair.has_message(), pair.has_pending_writes(),
                 pair.state in (PairState.ERROR, PairState.HALF_CLOSED)
                 or pair.peek_events())
        prev = getattr(pair, "_poller_edges", (False, False, False))
        pair._poller_edges = state
        return any(now and not was for now, was in zip(state, prev))


def wait_readable(pair: Pair, timeout: Optional[float] = None,
                  discipline: Optional[str] = None) -> bool:
    """Block until ``pair`` has something for its owner (message, resumable
    write, state change). Returns True if so, False on timeout."""
    return _wait(pair, timeout, discipline,
                 lambda: (pair.has_message() or pair.has_pending_writes()
                          or pair.state is not PairState.CONNECTED),
                 role="read")


def wait_writable(pair: Pair, timeout: Optional[float] = None,
                  discipline: Optional[str] = None) -> bool:
    """Block until a credit-stalled write can resume (or the pair dies). Not
    woken by unread inbound data, so a writer never spins on it."""
    return _wait(pair, timeout, discipline,
                 lambda: (pair.has_pending_writes()
                          or pair.state is not PairState.CONNECTED),
                 role="write")


def _effective_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def _wait(pair: Pair, timeout: Optional[float], discipline: Optional[str],
          predicate, role: str = "read") -> bool:
    cfg = get_config()
    if discipline is None:
        discipline = cfg.platform.discipline or "hybrid"

    def ready() -> bool:
        if pair.drain_notifications():
            # we may have consumed a token the other role waits on: kick
            # its pipe so it re-checks (it cannot steal our own wakeup)
            pair.kick(exclude=role)
        return predicate()

    deadline = None if timeout is None else time.monotonic() + timeout
    if ready():
        return True

    # A busy window presumes a core to burn while another produces; on one
    # hart hybrid degrades to pure event.
    if discipline == "hybrid" and _effective_cpus() < 2:
        discipline = "event"

    if discipline in ("busy", "hybrid"):
        # a hybrid pair whose activity EWMA decayed below the floor skips
        # the busy window; mode flips (BP and EV adoption) are flight edges
        suppressed = False
        if (discipline == "hybrid"
                and batch_pressure() >= _BATCH_SPIN_SUPPRESS):
            # fleet-wide pressure: sweeps keep finding many ready pairs at
            # once, so a hybrid waiter takes the event leg whatever its EWMA
            suppressed = True
            _stats.counter_inc("wait_spin_suppressed_batch")
        if discipline == "hybrid" and (suppressed
                                       or pair.activity_ewma
                                       < _EWMA_SPIN_FLOOR):
            _stats.counter_inc("wait_spin_skipped")
            if getattr(pair, "_flight_mode", "bp") != "ev":
                pair._flight_mode = "ev"
                _flight.emit(_flight.POLLER_EV, getattr(pair, "_ftag", 0))
        else:
            if (discipline == "hybrid"
                    and getattr(pair, "_flight_mode", "bp") != "bp"):
                pair._flight_mode = "bp"
                _flight.emit(_flight.POLLER_BP, getattr(pair, "_ftag", 0))
            if discipline == "busy":
                spin_deadline = (deadline if deadline is not None
                                 else float("inf"))
            else:
                spin_deadline = (time.monotonic()
                                 + cfg.busy_polling_timeout_us / 1e6)
            while time.monotonic() < spin_deadline:
                pair.spin(role, 500)
                if ready():
                    _ewma_hit(pair)
                    _stats.counter_inc("wait_spin_hit")
                    return True
            _ewma_miss(pair)
            _stats.counter_inc("wait_spin_miss")
        if discipline == "busy":
            return ready()

    # Block on the shared notify socket and this role's own wakeup pipe.
    # Every state transition is followed by a token or a kick, and the
    # role's pipe is consumed only by this waiter, so no cap is needed.
    sel = pair.waiter_selector(role)
    if not sel.get_map():
        return ready()  # channels released: never block on an empty selector
    _stats.counter_inc("wait_sleep")
    sleep_t0 = time.monotonic()
    hot_window_s = _HOT_WAKE_MULTIPLE * cfg.busy_polling_timeout_us / 1e6
    while True:
        if ready():
            if time.monotonic() - sleep_t0 <= hot_window_s:
                _ewma_hit(pair)
            else:
                _ewma_miss(pair)
            return True
        remain = None if deadline is None else deadline - time.monotonic()
        if remain is not None and remain <= 0:
            return ready()
        try:
            events = sel.select(timeout=remain)
        except (OSError, ValueError):
            return ready()  # a racing close invalidated a registered fd
        if events:
            pair.consume_wakeup(role)


class PairPool:
    """Keyed pair recycling: pairs return under the peer key and are revived
    by ``init()`` on the next take (ring regions are always fresh)."""

    _instance: Optional["PairPool"] = None
    _instance_lock = threading.Lock()

    @classmethod
    def get(cls) -> "PairPool":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = PairPool()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._instance_lock:
            inst, cls._instance = cls._instance, None
        if inst is not None:
            inst.drain()

    def __init__(self, pair_factory: Optional[Callable[[], Pair]] = None,
                 max_idle_total: Optional[int] = None,
                 max_idle_per_key: Optional[int] = None):
        cfg = get_config()
        if pair_factory is None:
            pair_factory = lambda: Pair(  # noqa: E731
                make_domain(get_config().ring_domain))
        self.pair_factory = pair_factory
        self.max_idle_total = (max_idle_total if max_idle_total is not None
                               else cfg.pair_pool_size)
        self.max_idle_per_key = (max_idle_per_key
                                 if max_idle_per_key is not None
                                 else max(1, self.max_idle_total // 4))
        self._idle: Dict[str, List[Pair]] = defaultdict(list)
        self._idle_total = 0
        self._lock = threading.Lock()

    def take(self, key: str) -> Pair:
        want_domain = get_config().ring_domain
        stale: List[Pair] = []
        pair = None
        with self._lock:
            bucket = self._idle.get(key)
            while bucket:
                cand = bucket.pop()
                self._idle_total -= 1
                # a pair is bound to its memory domain
                if cand.domain.kind == want_domain:
                    pair = cand
                    break
                stale.append(cand)
        for cand in stale:
            cand.destroy()
        if pair is None:
            pair = self.pair_factory()
        pair.init()
        return pair

    def putback(self, key: str, pair: Pair) -> None:
        """Release the pair's resources and shelve the object for reuse
        (beyond the bounds it is dropped)."""
        pair.destroy()
        with self._lock:
            bucket = self._idle[key]
            if (len(bucket) < self.max_idle_per_key
                    and self._idle_total < self.max_idle_total):
                bucket.append(pair)
                self._idle_total += 1

    def idle_count(self, key: str) -> int:
        with self._lock:
            return len(self._idle.get(key, []))

    def drain(self) -> None:
        """Destroy every idle pair."""
        with self._lock:
            pairs = [p for bucket in self._idle.values() for p in bucket]
            self._idle.clear()
            self._idle_total = 0
        for p in pairs:
            p.destroy()
