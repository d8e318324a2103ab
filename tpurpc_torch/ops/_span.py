"""The span plan of the device-ring kernels, and a numpy emulation of how
the kernel carries it out.

A ring span is at most two contiguous segments: the bytes before the ring's
end and the bytes after its start. :func:`scatter_plan` and
:func:`window_plan` split a span and cut each segment into what the copy
engine (``csrc/ring_copy.cuh``) takes:

- ``head``: the bytes before the destination reaches 16-byte alignment;
- ``words``: the 16-byte destination words of the body;
- ``tail``: the bytes after the body;
- ``skew``: where the body's first source byte sits in its aligned 16-byte
  source word;
- ``chunks``: the body cut into chunks of ``chunk_words`` words, the unit a
  block takes; the chunks of both segments form one flat index space.

A plan is the kernel's argument tuple; the wrappers pass it as it is. The CUDA
kernel cannot run without a card, so :func:`emulate` repeats its
decomposition (block, chunk, warp, lane, unroll step; the warp shuffles and
the funnel-shift realignment of a skewed body; the one warp that writes the
heads and tails) on a numpy byte array standing for device memory. The CPU
tests run it against the kernels' contract.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

WORD = 16
#: the kernel's block shape: THREADS threads, each with UNROLL 16-byte
#: loads in flight (``kThreads`` and ``kUnroll`` in csrc/ring_copy.cuh)
THREADS = 128
UNROLL = 8
#: bytes of body per chunk: one pass of a block (THREADS x UNROLL words),
#: chosen by measurement on the card (PERF.md)
CHUNK_BYTES = THREADS * UNROLL * WORD
#: resident blocks on an H100 (132 SMs x 8 blocks of 128 threads at 64
#: registers); the kernel asks the runtime, the emulation takes this
MAX_BLOCKS = 132 * 8
#: offsets inside a segment are 32-bit in the kernel
MAX_SEGMENT = 1 << 32


class Segment(NamedTuple):
    """One segment's fields in a plan."""
    dst: int      # address of the segment's first destination byte
    src: int      # address of its first source byte
    head: int
    words: int
    tail: int
    skew: int
    chunks: int


def segment(dst: int, src: int, n: int, chunk_words: int) -> tuple:
    """Cut one contiguous copy of ``n`` bytes from ``src`` to ``dst``: the
    fields of :class:`Segment`, as a plain tuple."""
    if n >= MAX_SEGMENT:
        raise ValueError(f"ring segment of {n} bytes exceeds the kernel's "
                         f"32-bit offsets")
    head = min(-dst % WORD, n)
    words = (n - head) // WORD
    return (dst, src, head, words, n - head - WORD * words,
            (src + head) % WORD, -(-words // chunk_words))


def scatter_plan(ring: int, cap: int, payload: int, start: int, n: int,
                 chunk_bytes: int = CHUNK_BYTES) -> tuple:
    """``ring[(start + i) mod cap] = payload[i]`` at these addresses, as the
    kernel's arguments before the stream: both segments' fields, then
    ``chunk_words`` (``_build.KERNELS``)."""
    p = start % cap
    first = min(n, cap - p)
    cw = chunk_bytes // WORD
    return (*segment(ring + p, payload, first, cw),
            *segment(ring, payload + first, n - first, cw), cw)


def window_plan(ring: int, cap: int, head: int, n: int, out: int,
                chunk_bytes: int = CHUNK_BYTES) -> tuple:
    """``out[i] = ring[(head + i) mod cap]`` at these addresses, as the
    kernel's arguments before the stream (see :func:`scatter_plan`)."""
    p = head % cap
    first = min(n, cap - p)
    cw = chunk_bytes // WORD
    return (*segment(out, ring + p, first, cw),
            *segment(out + first, ring, n - first, cw), cw)


def segments(plan: tuple) -> Tuple[Segment, Segment]:
    return Segment(*plan[:7]), Segment(*plan[7:14])


def grid(plan: tuple, max_blocks: int = MAX_BLOCKS) -> int:
    """Blocks launched: one per chunk up to the resident limit (blocks then
    stride over chunks), and at least one for the heads and tails."""
    s0, s1 = segments(plan)
    return max(1, min(s0.chunks + s1.chunks, max_blocks))


# -- emulation ---------------------------------------------------------------

def _words(mem: np.ndarray, addrs: np.ndarray) -> np.ndarray:
    """The 16-byte words at ``addrs`` as (len, 4) little-endian uint32."""
    rows = mem[addrs[:, None] + np.arange(WORD)]
    return rows.view("<u4").reshape(len(addrs), 4)


def _realign(lo: np.ndarray, hi: np.ndarray, skew: int) -> np.ndarray:
    """``realign`` of ring_copy.cuh: the 16 bytes ``skew`` bytes into
    lo:hi, by word select and ``__funnelshift_r``."""
    a = np.concatenate([lo, hi], axis=1).astype(np.uint64)
    q, sh = skew >> 2, (skew & 3) * 8
    b = a[:, q:q + 5]
    return (((b[:, 1:] << np.uint64(32)) | b[:, :4]) >> np.uint64(sh)
            ).astype(np.uint32)


def _load(mem, addrs, lo, hi) -> np.ndarray:
    """Aligned 16-byte loads at ``addrs``; each must lie in the source words
    ``[lo, hi)`` that hold the segment's bytes."""
    bad = (addrs % WORD != 0) | (addrs < lo) | (addrs >= hi)
    if bad.any():
        raise RuntimeError(f"load at {addrs[bad][0]} outside the source "
                           f"words [{lo}, {hi})")
    return _words(mem, addrs)


def _copy_words(mem, writes, dst, src, skew, begin, end, warp, lo, hi):
    """``copy_words`` of ring_copy.cuh for one warp, the 32 lanes as a
    vector: ``dst`` is the first destination word's address, ``src`` the
    aligned source word's address under it."""
    if dst % WORD:
        raise RuntimeError(f"body store at {dst}: not 16-byte aligned")
    lanes = np.arange(32)
    run_len = 32 * UNROLL
    for run in range(begin + warp * run_len, end, (THREADS // 32) * run_len):
        v = []
        for k in range(UNROLL):
            i = run + 32 * k + lanes
            live = (i < end) | ((skew != 0) & (i == end))
            w = np.zeros((32, 4), np.uint32)
            w[live] = _load(mem, src + WORD * i[live], lo, hi)
            v.append(w)
        extra = np.zeros(4, np.uint32)
        if skew and run + run_len - 1 < end:           # lane 31's extra load
            extra = _load(mem, np.array([src + WORD * (run + run_len)]),
                          lo, hi)[0]
        for k in range(UNROLL):
            i = run + 32 * k + lanes
            w = v[k]
            if skew:
                nxt = np.roll(v[k], -1, axis=0)        # __shfl_down_sync(.., 1)
                nxt[31] = v[k + 1][0] if k + 1 < UNROLL else extra
                w = _realign(v[k], nxt, skew)
            st = i < end
            rows = (dst + WORD * i[st])[:, None] + np.arange(WORD)
            mem[rows] = w[st].astype("<u4").view(np.uint8).reshape(-1, WORD)
            np.add.at(writes, rows.ravel(), 1)


def _copy_edges(mem, writes, segs):
    """``copy_edges``: lanes 0-15 the head, 16-31 the tail, of each
    segment in turn."""
    for s in segs:
        for lane in range(32):
            k, tail = lane & 15, bool(lane & 16)
            if k < (s.tail if tail else s.head):
                off = s.head + WORD * s.words + k if tail else k
                mem[s.dst + off] = mem[s.src + off]
                writes[s.dst + off] += 1


def emulate(plan: tuple, mem: np.ndarray, max_blocks: int = MAX_BLOCKS
            ) -> np.ndarray:
    """Carry out ``plan`` on ``mem`` (uint8; addresses index it) as the
    kernel does, block by block. Returns how many times each byte was
    written. Raises RuntimeError on a body store that is not 16-byte
    aligned, or a load outside the 16-byte words that hold the segment's
    source bytes: on the card either would fault or read memory that is
    not the source's."""
    s0, s1 = segments(plan)
    cw = plan[14]
    writes = np.zeros(mem.shape[0], np.int64)
    g = grid(plan, max_blocks)
    for block in range(g):
        if block == 0:
            _copy_edges(mem, writes, (s0, s1))
        for c in range(block, s0.chunks + s1.chunks, g):
            s, lc = (s1, c - s0.chunks) if c >= s0.chunks else (s0, c)
            begin = lc * cw
            end = min(begin + cw, s.words)
            lo = s.src - s.src % WORD
            hi = s.src + s.head + WORD * s.words + s.tail
            for warp in range(THREADS // 32):
                _copy_words(mem, writes, s.dst + s.head,
                            s.src + s.head - s.skew, s.skew, begin, end, warp,
                            lo, hi)
    return writes
