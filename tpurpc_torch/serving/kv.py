"""The paged KV-cache plane: block arena, block tables, prefix reuse, swap.

A copy of ``tpurpc/serving/kv.py`` (the same flight edges, metric names
and ``/healthz`` lines):

* :class:`KvBlockManager` — a block arena carved from ONE region allocated
  through the :class:`~tpurpc_torch.core.pair.MemoryDomain` seam (``local``
  or ``shm``; on ``shm`` the bytes are one-sided-writable from another
  process, which :mod:`tpurpc_torch.serving.disagg` ships KV over). Fixed
  block size, free-list allocation, per-block refcounts.
* per-sequence block tables (:class:`SeqKv`) of 16-byte ``<hash u64,
  token u32, flags u32>`` entries. Entry ``p`` depends only on the token
  stream up to ``p``: the invariant prefix sharing, swap and migration
  lean on.
* copy-on-write prefix reuse keyed by a hash of the block-aligned prompt
  prefix: retiring a sequence donates that span to a refcounted, LRU
  prefix cache; a later prompt with the same prefix shares its blocks and
  skips prefill for them. Shared blocks are never written in place
  (:meth:`SeqKv.writable_block` copies first).
* preempt-to-host swap (:meth:`KvBlockManager.swap_out` /
  :meth:`~KvBlockManager.swap_in`), byte-exact.
* quarantine: blocks a dead peer's straggling one-sided write might still
  reach never return to the free list.

Every alloc, free, prefix hit, swap and quarantine is a flight edge (tag
``kv:<name>``: ``KV_ALLOC``, ``KV_FREE``, ``KV_PREFIX_HIT``,
``KV_SWAP_BEGIN``/``END`` with the direction in ``a2``, ``KV_QUARANTINE``)
at sequence-lifetime boundaries, never per token; the fleet gauges
``kv_blocks_used``/``free``/``swapped``/``quarantined`` and the counters
``kv_prefix_hits``, ``kv_prefix_hit_tokens``, ``kv_swaps`` and
``kv_cow_copies`` read each arena. The stall watchdog reads an open
``KV_SWAP_BEGIN`` as its ``kv-swap`` stage; swap traffic is the profiler's
``kv_swap`` stage; :func:`health_lines` gives ``/healthz`` one ``kv`` line
per live arena.
"""

from __future__ import annotations

import hashlib
import os
import struct
import weakref
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tpurpc_torch.analysis.locks import make_lock
from tpurpc_torch.core import pair as _pair
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _profiler

__all__ = [
    "KvBlockManager", "SeqKv", "HostKv", "KvArenaFull",
    "ENTRY", "ENTRY_BYTES", "FLAG_POISONED", "health_lines",
]

#: swap traffic is the KV plane's CPU story: a preemption storm shows up as
#: `kv_swap` time, not as unattributed serving work
_LENS_STAGES = {
    "swap_out": "kv_swap",
    "swap_in": "kv_swap",
    "alloc_for_prompt": "decode_step",
    "free_blocks": "decode_step",
}
_profiler.register_stages(__file__, _LENS_STAGES)

#: one KV entry: the model-visible record per token position
ENTRY = struct.Struct("<QII")  # hash u64, token u32, flags u32
ENTRY_BYTES = ENTRY.size       # 16

FLAG_POISONED = 1

_ALIGN = 64
_NONCE_BYTES = 16

# -- gauges / counters (process-wide registry, weakly held fleet gauges) -----
_USED_G = _metrics.fleet("kv_blocks_used", lambda m: m.used_count())
_FREE_G = _metrics.fleet("kv_blocks_free", lambda m: m.free_count())
_SWAPPED_G = _metrics.fleet("kv_blocks_swapped", lambda m: m.swapped_count())
_QUAR_G = _metrics.fleet("kv_blocks_quarantined",
                         lambda m: m.quarantined_count())
_PREFIX_HITS = _metrics.counter("kv_prefix_hits")
_PREFIX_HIT_TOKENS = _metrics.counter("kv_prefix_hit_tokens")
_SWAPS = _metrics.counter("kv_swaps")
_COW_COPIES = _metrics.counter("kv_cow_copies")

#: live managers for the /healthz `kv` lines
_LIVE: "weakref.WeakSet[KvBlockManager]" = weakref.WeakSet()


class KvArenaFull(RuntimeError):
    """No free block in the arena (after prefix-cache eviction)."""


class SeqKv:
    """One sequence's block table over a :class:`KvBlockManager` arena.

    ``length`` counts entries present. The first ``shared_len`` entries may
    live in blocks shared with the prefix cache (refs > 1), read-only. A
    swapped-out table has ``host`` set (the byte image) and no blocks.
    """

    __slots__ = ("mgr", "key", "blocks", "length", "shared_len",
                 "prefix_key", "prefix_span", "host")

    def __init__(self, mgr: "KvBlockManager", key: int):
        self.mgr = mgr
        self.key = key
        self.blocks: List[int] = []
        self.length = 0
        self.shared_len = 0
        self.prefix_key: Optional[bytes] = None
        self.prefix_span = 0
        self.host: Optional[bytearray] = None

    @property
    def swapped(self) -> bool:
        return self.host is not None

    def capacity(self) -> int:
        return len(self.blocks) * self.mgr.block_tokens

    def reserve(self, n_entries: int) -> None:
        """Pre-allocate blocks so ``n_entries`` entries fit (a handoff's
        grant names every landing block up front)."""
        bt = self.mgr.block_tokens
        need = (n_entries + bt - 1) // bt - len(self.blocks)
        if need > 0:
            # ownership transfers to the table in the same statement
            self.blocks.extend(
                self.mgr.alloc_blocks(self.key, need))  # tpr: allow(kv)

    def _entry_site(self, pos: int) -> Tuple[memoryview, int]:
        bt = self.mgr.block_tokens
        block = self.blocks[pos // bt]
        off = self.mgr.block_offset(block) + (pos % bt) * ENTRY_BYTES
        return self.mgr.region_buf, off

    def entry(self, pos: int) -> Tuple[int, int, int]:
        """``(hash, token, flags)`` at entry position ``pos``."""
        if not 0 <= pos < self.length:
            raise IndexError(f"entry {pos} of {self.length}")
        if self.host is not None:
            return ENTRY.unpack_from(self.host, pos * ENTRY_BYTES)
        buf, off = self._entry_site(pos)
        return ENTRY.unpack_from(buf, off)

    def last(self) -> Tuple[int, int, int]:
        return self.entry(self.length - 1)

    def append(self, h: int, token: int, flags: int = 0) -> None:
        """Write the next entry; allocates a private block at block
        boundaries and never touches a shared one."""
        if self.host is not None:
            raise RuntimeError("append to a swapped-out table")
        if self.length >= self.capacity():
            # ownership transfers to the table in the same statement
            self.blocks.extend(
                self.mgr.alloc_blocks(self.key, 1))  # tpr: allow(kv)
        buf, off = self._entry_site(self.length)
        ENTRY.pack_into(buf, off, h & 0xFFFFFFFFFFFFFFFF,
                        token & 0xFFFFFFFF, flags & 0xFFFFFFFF)
        self.length += 1

    def truncate(self, n_entries: int) -> None:
        """Forget entries past ``n_entries`` (the isolation retry's undo);
        blocks are kept."""
        self.length = min(self.length, max(0, int(n_entries)))

    def set_length(self, n_entries: int) -> None:
        """Declare entries [0, n) present (they arrived one-sided)."""
        bt = self.mgr.block_tokens
        if n_entries > len(self.blocks) * bt:
            raise ValueError(f"{n_entries} entries exceed the "
                             f"{len(self.blocks)}-block table")
        self.length = int(n_entries)

    def writable_block(self, idx: int) -> int:
        """The COW door: block ``idx`` privately owned, copied into a fresh
        block first if shared. Returns the block id."""
        block = self.blocks[idx]
        if self.mgr.block_refs(block) <= 1:
            return block
        fresh = self.mgr.alloc_blocks(self.key, 1)
        try:
            src = self.mgr.block_view(block)
            self.mgr.block_view(fresh[0])[:] = src
        except BaseException:
            self.mgr.free_blocks_raw(fresh)
            raise
        self.blocks[idx] = fresh[0]
        self.mgr._decref(block)
        bt = self.mgr.block_tokens
        self.shared_len = min(self.shared_len, idx * bt)
        _COW_COPIES.inc()
        return fresh[0]

    def chunks(self, start_entry: int, end_entry: int
               ) -> Iterator[Tuple[int, memoryview]]:
        """Per-block byte views covering entries [start, end): the
        shipper's gather list. ``start_entry`` must be block-aligned."""
        bt = self.mgr.block_tokens
        if start_entry % bt:
            raise ValueError(f"start entry {start_entry} not block-aligned")
        for bi in range(start_entry // bt,
                        (max(start_entry, end_entry) + bt - 1) // bt):
            lo = bi * bt
            hi = min(end_entry, lo + bt)
            nb = (hi - lo) * ENTRY_BYTES
            if self.host is not None:
                view = memoryview(self.host)[lo * ENTRY_BYTES:
                                             lo * ENTRY_BYTES + nb]
            else:
                off = self.mgr.block_offset(self.blocks[bi])
                view = self.mgr.region_buf[off:off + nb]
            yield bi, view


class HostKv:
    """A host-memory table with the SeqKv entry interface: what a prefill
    server computes into before shipping. ``base_pos``/``base_hash`` seed
    a table that starts mid-sequence (a prefix-cache hit at the decode
    side)."""

    __slots__ = ("base_pos", "_base_hash", "_base_flags", "buf", "length")

    def __init__(self, base_pos: int = 0, base_hash: int = 0,
                 base_flags: int = 0):
        self.base_pos = int(base_pos)
        self._base_hash = int(base_hash)
        self._base_flags = int(base_flags)
        self.buf = bytearray()
        self.length = self.base_pos

    def entry(self, pos: int) -> Tuple[int, int, int]:
        if pos == self.base_pos - 1 and self.base_pos:
            return (self._base_hash, 0, self._base_flags)
        local = pos - self.base_pos
        if not 0 <= local < (self.length - self.base_pos):
            raise IndexError(f"entry {pos} (base {self.base_pos}, "
                             f"length {self.length})")
        return ENTRY.unpack_from(self.buf, local * ENTRY_BYTES)

    def last(self) -> Tuple[int, int, int]:
        return self.entry(self.length - 1)

    def append(self, h: int, token: int, flags: int = 0) -> None:
        self.buf += ENTRY.pack(h & 0xFFFFFFFFFFFFFFFF, token & 0xFFFFFFFF,
                               flags & 0xFFFFFFFF)
        self.length += 1

    def truncate(self, n_entries: int) -> None:
        n_entries = max(self.base_pos, int(n_entries))
        del self.buf[(n_entries - self.base_pos) * ENTRY_BYTES:]
        self.length = n_entries

    def payload(self) -> memoryview:
        """The computed entries [base_pos, length) as bytes: what ships."""
        return memoryview(self.buf)


class _PrefixEntry:
    __slots__ = ("blocks", "span", "last_hash", "last_flags")

    def __init__(self, blocks: Tuple[int, ...], span: int, last_hash: int,
                 last_flags: int):
        self.blocks = blocks
        self.span = span
        self.last_hash = last_hash
        self.last_flags = last_flags


class KvBlockManager:
    """The arena, block tables, prefix cache, swap and quarantine.

    ``kind`` names the memory domain backing the arena: ``"local"`` for
    in-process scheduling, ``"shm"`` when it is also a one-sided landing
    target for the disaggregated handoff plane.
    """

    def __init__(self, n_blocks: int = 256, block_bytes: int = 2048,
                 kind: str = "local", name: str = "kv"):
        if block_bytes % ENTRY_BYTES:
            raise ValueError(f"block_bytes {block_bytes} not a multiple of "
                             f"the {ENTRY_BYTES}-byte entry")
        self.name = name
        self.kind = kind
        self.n_blocks = int(n_blocks)
        self.block_bytes = int(block_bytes)
        self.block_tokens = block_bytes // ENTRY_BYTES
        self._domain = _pair.make_domain(kind)
        total = _ALIGN + self.n_blocks * self.block_bytes + _NONCE_BYTES
        self._region = self._domain.alloc(total)
        base = np.frombuffer(self._region.buf, np.uint8)
        self._base_off = int((-base.ctypes.data) % _ALIGN)
        del base
        self.nonce = os.urandom(_NONCE_BYTES)
        self.nonce_off = self._base_off + self.n_blocks * self.block_bytes
        self._region.buf[self.nonce_off:
                         self.nonce_off + _NONCE_BYTES] = self.nonce
        self._lock = make_lock("KvBlockManager._lock")
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self._quarantined: List[int] = []
        #: prompt-prefix hash -> _PrefixEntry (LRU: move_to_end on hit)
        self._prefix: "OrderedDict[bytes, _PrefixEntry]" = OrderedDict()
        self._swapped_blocks: Dict[int, int] = {}  # seq key -> block count
        self.prefix_hits = 0
        self.swaps_out = 0
        self.swaps_in = 0
        self._tag = _flight.tag_for(f"kv:{name}")
        self._closed = False
        _USED_G.track(self)
        _FREE_G.track(self)
        _SWAPPED_G.track(self)
        _QUAR_G.track(self)
        _LIVE.add(self)

    # -- raw arena geometry (the grant path reads these) ----------------------

    @property
    def region_handle(self) -> str:
        return self._region.handle

    @property
    def region_buf(self) -> memoryview:
        return self._region.buf

    @property
    def window_bytes(self) -> int:
        """Bytes a peer window must map to reach every block + the nonce."""
        return self.nonce_off + _NONCE_BYTES

    def block_offset(self, block: int) -> int:
        return self._base_off + block * self.block_bytes

    def block_view(self, block: int) -> memoryview:
        off = self.block_offset(block)
        return self._region.buf[off:off + self.block_bytes]

    def block_refs(self, block: int) -> int:
        with self._lock:
            return self._refs.get(block, 0)

    # -- allocation -----------------------------------------------------------

    def alloc_blocks(self, owner_key: int, n: int) -> List[int]:
        """``n`` fresh private blocks (refs=1); evicts prefix-cache entries
        LRU-first under pressure; :class:`KvArenaFull` when even eviction
        cannot cover it."""
        with self._lock:
            if self._closed:
                raise KvArenaFull("arena closed")
            while len(self._free) < n and self._prefix:
                self._evict_one_locked()
            if len(self._free) < n:
                raise KvArenaFull(
                    f"arena {self.name}: want {n} blocks, "
                    f"{len(self._free)} free (of {self.n_blocks})")
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._refs[b] = 1
        nb = len(out)
        _flight.emit(_flight.KV_ALLOC, self._tag, owner_key, nb)
        return out

    def alloc_for_prompt(self, seq_key: int, prompt,
                         reserve_entries: int = 0) -> Tuple[SeqKv, int]:
        """A fresh block table for ``prompt``, prefix cache consulted:
        ``(table, hit_entries)``, the first ``hit_entries`` entries present
        through shared blocks. ``reserve_entries`` pre-allocates."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        kv = SeqKv(self, seq_key)
        span = (int(prompt.shape[0]) // self.block_tokens) \
            * self.block_tokens
        key = self._prefix_key(prompt, span) if span else None
        kv.prefix_key = key
        kv.prefix_span = span
        hit = 0
        if key is not None:
            with self._lock:
                ent = self._prefix.get(key)
                if ent is not None:
                    self._prefix.move_to_end(key)
                    for b in ent.blocks:
                        self._refs[b] += 1
                    kv.blocks.extend(ent.blocks)
                    hit = ent.span
                    self.prefix_hits += 1
            if hit:
                kv.length = hit
                kv.shared_len = hit
                _PREFIX_HITS.inc()
                _PREFIX_HIT_TOKENS.inc(hit)
                _flight.emit(_flight.KV_PREFIX_HIT, self._tag, seq_key, hit)
        if reserve_entries:
            try:
                kv.reserve(reserve_entries)
            except KvArenaFull:
                self.free_blocks(kv)
                raise
        return kv, hit

    def _prefix_key(self, prompt: np.ndarray, span: int) -> bytes:
        """Content hash of the block-aligned prompt prefix (sha1 over the
        raw int32 bytes): the cache key."""
        return hashlib.sha1(prompt[:span].tobytes()).digest()

    # -- release / prefix donation --------------------------------------------

    def free_blocks(self, kv: SeqKv, cache_prefix: bool = False) -> None:
        """Release a table; with ``cache_prefix=True`` donate its
        block-aligned prompt span to the prefix cache first. A poisoned
        span is never cached."""
        if kv.host is not None:
            with self._lock:
                self._swapped_blocks.pop(kv.key, None)
            kv.host = None
        if not kv.blocks:
            kv.length = 0
            return
        donate: Optional[Tuple[bytes, _PrefixEntry]] = None
        if (cache_prefix and kv.prefix_key is not None
                and kv.length >= kv.prefix_span > 0):
            h, _tok, flags = kv.entry(kv.prefix_span - 1)
            if not flags & FLAG_POISONED:
                bt = self.block_tokens
                span_blocks = tuple(kv.blocks[:kv.prefix_span // bt])
                donate = (kv.prefix_key,
                          _PrefixEntry(span_blocks, kv.prefix_span, h,
                                       flags))
        blocks, kv.blocks = kv.blocks, []
        n = len(blocks)
        kv.length = 0
        kv.shared_len = 0
        with self._lock:
            if donate is not None and donate[0] not in self._prefix:
                self._prefix[donate[0]] = donate[1]
                for b in donate[1].blocks:
                    self._refs[b] += 1
            for b in blocks:
                self._decref_locked(b)
        _flight.emit(_flight.KV_FREE, self._tag, kv.key, n)

    def free_blocks_raw(self, blocks: Sequence[int]) -> None:
        """Release raw block ids that no table owns yet."""
        n = len(blocks)
        with self._lock:
            for b in blocks:
                self._decref_locked(b)
        if n:
            _flight.emit(_flight.KV_FREE, self._tag, 0, n)

    def _decref(self, block: int) -> None:
        with self._lock:
            self._decref_locked(block)

    def _decref_locked(self, block: int) -> None:
        r = self._refs.get(block, 0) - 1
        if r > 0:
            self._refs[block] = r
            return
        self._refs.pop(block, None)
        self._free.append(block)

    def _evict_one_locked(self) -> None:
        _key, ent = self._prefix.popitem(last=False)
        for b in ent.blocks:
            self._decref_locked(b)

    def lookup_prefix(self, prompt) -> Tuple[int, int, int]:
        """``(span, last_hash, last_flags)`` of the cached prefix of
        ``prompt`` ((0, 0, 0) on a miss), taking no reference."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        span = (int(prompt.shape[0]) // self.block_tokens) \
            * self.block_tokens
        if not span:
            return 0, 0, 0
        with self._lock:
            ent = self._prefix.get(self._prefix_key(prompt, span))
            if ent is None:
                return 0, 0, 0
            return ent.span, ent.last_hash, ent.last_flags

    # -- preempt-to-host swap -------------------------------------------------

    def swap_out(self, kv: SeqKv) -> None:
        """Copy the table's entries to a host image and return every block
        to the arena; :meth:`swap_in` restores it byte-exactly."""
        if kv.host is not None:
            return
        key = kv.key
        n = len(kv.blocks)
        _flight.emit(_flight.KV_SWAP_BEGIN, self._tag, key, 0)
        host = bytearray(kv.length * ENTRY_BYTES)
        for bi, view in kv.chunks(0, kv.length):
            lo = bi * self.block_bytes
            host[lo:lo + len(view)] = view
        blocks, kv.blocks = kv.blocks, []
        kv.host = host
        kv.shared_len = 0
        with self._lock:
            for b in blocks:
                self._decref_locked(b)
            self._swapped_blocks[key] = n
        self.swaps_out += 1
        _SWAPS.inc()
        _flight.emit(_flight.KV_SWAP_END, self._tag, key, 0)

    def swap_in(self, kv: SeqKv) -> None:
        """Restore a swapped table into fresh private blocks;
        :class:`KvArenaFull` when the arena cannot take it back."""
        if kv.host is None:
            return
        key = kv.key
        bt = self.block_tokens
        need = (kv.length + bt - 1) // bt
        _flight.emit(_flight.KV_SWAP_BEGIN, self._tag, key, 1)
        blocks = self.alloc_blocks(key, need)
        try:
            host = kv.host
            for i, b in enumerate(blocks):
                lo = i * self.block_bytes
                chunk = host[lo:lo + self.block_bytes]
                off = self.block_offset(b)
                self._region.buf[off:off + len(chunk)] = chunk
        except BaseException:
            self.free_blocks_raw(blocks)
            raise
        kv.blocks = blocks
        kv.host = None
        with self._lock:
            self._swapped_blocks.pop(key, None)
        self.swaps_in += 1
        _flight.emit(_flight.KV_SWAP_END, self._tag, key, 1)

    # -- quarantine (the death path) ------------------------------------------

    def quarantine(self, kv_or_blocks) -> int:
        """Remove blocks from circulation until the arena closes (a
        straggling one-sided writer may still land bytes in them). Takes a
        SeqKv or a block list; returns the count quarantined. A block the
        prefix cache still shares only loses this reference."""
        if isinstance(kv_or_blocks, SeqKv):
            blocks, kv_or_blocks.blocks = kv_or_blocks.blocks, []
            kv_or_blocks.length = 0
            kv_or_blocks.shared_len = 0
        else:
            blocks = list(kv_or_blocks)
        n = 0
        with self._lock:
            for b in blocks:
                r = self._refs.get(b, 0) - 1
                if r > 0:
                    self._refs[b] = r
                    continue
                self._refs.pop(b, None)
                self._quarantined.append(b)
                n += 1
        if n:
            _flight.emit(_flight.KV_QUARANTINE, self._tag, 0, n)
        return n

    # -- introspection --------------------------------------------------------

    def used_count(self) -> int:
        with self._lock:
            return self.n_blocks - len(self._free) - len(self._quarantined)

    def free_count(self) -> int:
        return len(self._free)

    def swapped_count(self) -> int:
        with self._lock:
            return sum(self._swapped_blocks.values())

    def quarantined_count(self) -> int:
        return len(self._quarantined)

    def prefix_entries(self) -> int:
        return len(self._prefix)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "blocks": self.n_blocks,
                "free": len(self._free),
                "used": self.n_blocks - len(self._free)
                - len(self._quarantined),
                "swapped_seqs": len(self._swapped_blocks),
                "swapped_blocks": sum(self._swapped_blocks.values()),
                "quarantined": len(self._quarantined),
                "prefix_entries": len(self._prefix),
                "prefix_hits": self.prefix_hits,
            }

    def close(self) -> None:
        self._closed = True
        _LIVE.discard(self)
        try:
            self._region.close()
        except Exception:
            pass


def health_lines() -> List[str]:
    """One ``kv`` line per live arena for /healthz: block occupancy and
    swap pressure at a glance, without the metrics plane."""
    out = []
    for m in list(_LIVE):
        try:
            s = m.stats()
            out.append(
                f"kv {m.name}: used={s['used']}/{s['blocks']} "
                f"free={s['free']} swapped={s['swapped_blocks']} "
                f"quarantined={s['quarantined']} "
                f"prefix_hits={s['prefix_hits']}")
        except Exception:
            continue
    return sorted(out)
