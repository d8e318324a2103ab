"""The span plan of the port's device-ring kernels (tpurpc_torch/ops/_span.py)
and its numpy emulation of the CUDA kernel's decomposition.

The wrappers pass the plan (``_span.scatter_plan`` / ``window_plan``) to the
CUDA kernels, which cannot run here; ``_span.emulate`` carries the plan out as the kernel
does (blocks striding over one flat chunk space, warp runs, unroll steps,
shuffles and the funnel-shift realignment of skewed bodies, the edge warp).
These tests hold the emulation to the kernels' contract on a numpy byte
array standing for device memory:

- every destination byte is written exactly once, from the right source
  byte (found by running the emulation on memory whose bytes are the low,
  then the high, byte of their own address), and nothing else is written;
- no load leaves the 16-byte words that hold the segment's source bytes;
- on seeded data the result is byte-equal to ``ring_scatter_reference`` /
  ``ring_window_reference``, and on 4-byte-aligned spans to the reference's
  Pallas kernels in interpret mode.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpurpc.ops.ring_scatter import ring_scatter as jax_ring_scatter
from tpurpc.ops.ring_window import ring_window as jax_ring_window
from tpurpc_torch.ops import _build, _span
from tpurpc_torch.ops.ring_scatter import ring_scatter_reference
from tpurpc_torch.ops.ring_window import ring_window_reference

CAPS = [64, 256, 4096, 16384]
KERNELS = ["ring_scatter", "ring_window"]
#: (source buffer base, destination buffer base) address offsets mod 512
BASES = [(0, 0), (256, 0), (7, 5)]


def _starts(cap):
    """Every residue mod 16 near the ring's end, the last byte, the first,
    and a logical offset three laps on."""
    return [cap - 32 + r for r in range(16)] + [cap - 1, 0, 3 * cap + cap // 2]


def _lengths(cap, start):
    """0, 1, 15, 16, 17, the whole ring, and the span that ends exactly at
    the wrap."""
    return sorted({0, 1, 15, 16, 17, cap, cap - start % cap})


def _layout(kernel, cap, n, bases):
    """Addresses of the ring and of the other buffer (payload or output) in
    an emulated memory, with margins around both; returns (ring, other,
    memory size)."""
    src_base, dst_base = bases
    ring_base, other_base = ((dst_base, src_base) if kernel == "ring_scatter"
                             else (src_base, dst_base))
    ring = 512 + ring_base
    other = 512 * (2 + (ring + cap) // 512) + other_base
    return ring, other, other + n + 512


def _plan(kernel, ring, cap, other, start, n, **kw):
    if kernel == "ring_scatter":
        return _span.scatter_plan(ring, cap, other, start, n, **kw)
    return _span.window_plan(ring, cap, start, n, other, **kw)


def _expected(kernel, ring, cap, other, start, n):
    """(destination addresses, their source addresses) by the contract."""
    i = np.arange(n)
    wrapped = ring + (start + i) % cap
    if kernel == "ring_scatter":
        return wrapped, other + i
    return other + i, wrapped


def _check_provenance(kernel, cap, start, n, bases, **kw):
    max_blocks = kw.pop("max_blocks", _span.MAX_BLOCKS)
    ring, other, size = _layout(kernel, cap, n, bases)
    pl = _plan(kernel, ring, cap, other, start, n, **kw)
    addr = np.arange(size)
    got = np.zeros(size, np.int64)
    for shift in (0, 8):
        mem = ((addr >> shift) & 0xFF).astype(np.uint8)
        writes = _span.emulate(pl, mem, max_blocks=max_blocks)
        got |= mem.astype(np.int64) << shift
    dst, src = _expected(kernel, ring, cap, other, start, n)
    want = np.zeros(size, np.int64)
    want[dst] = 1
    np.testing.assert_array_equal(writes, want,
                                  err_msg=f"start={start} n={n}: writers")
    np.testing.assert_array_equal(got[dst], src,
                                  err_msg=f"start={start} n={n}: sources")


@pytest.mark.parametrize("bases", BASES)
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_each_destination_byte_written_once_from_its_source(kernel, cap,
                                                            bases):
    for start in _starts(cap):
        for n in _lengths(cap, start):
            _check_provenance(kernel, cap, start, n, bases)


@pytest.mark.parametrize("chunk_bytes,max_blocks",
                         [(16, 1), (64, 3), (2048, 2)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_flat_chunk_space_and_grid_stride(kernel, chunk_bytes, max_blocks):
    """Small chunks and few blocks: blocks stride over the chunks of both
    segments, and chunk edges fall inside warp runs."""
    cap = 4096
    for start, n in [(cap - 1000 + 3, 3000), (cap - 2048, 4096),
                     (cap - 7, 13), (5, 4000), (cap - 17, cap)]:
        _check_provenance(kernel, cap, start, n, (7, 5),
                          chunk_bytes=chunk_bytes, max_blocks=max_blocks)


def _emulate_on_data(kernel, ring0, payload, start, n, bases=(0, 0)):
    """Run the emulation on seeded bytes; returns the ring (scatter) or the
    gathered window."""
    cap = ring0.shape[0]
    ring, other, size = _layout(kernel, cap, n, bases)
    mem = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8)
    mem[ring:ring + cap] = ring0
    if kernel == "ring_scatter":
        mem[other:other + n] = payload
    _span.emulate(_plan(kernel, ring, cap, other, start, n), mem)
    if kernel == "ring_scatter":
        return mem[ring:ring + cap]
    return mem[other:other + n]


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_emulation_matches_the_numpy_reference(kernel, cap):
    rng = np.random.default_rng(cap)
    for bases in BASES:
        for start in _starts(cap):
            for n in _lengths(cap, start):
                ring0 = rng.integers(0, 256, cap, dtype=np.uint8)
                payload = rng.integers(0, 256, n, dtype=np.uint8)
                got = _emulate_on_data(kernel, ring0, payload, start, n,
                                       bases)
                if kernel == "ring_scatter":
                    want = ring_scatter_reference(ring0, payload, start)
                else:
                    want = ring_window_reference(ring0, start, n)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{start=} {n=}")


#: 4-byte-aligned spans the Pallas kernels take (16 KiB ring)
PALLAS_SPANS = [(16384 - 2048, 8192), (16384 - 400 + 4, 4096),
                (4 * 77, 16384), (16384 - 12, 16 + 4)]


@pytest.mark.parametrize("start,n", PALLAS_SPANS)
def test_emulated_scatter_matches_pallas_kernel(start, n):
    r = np.random.default_rng(start + n)
    ring0 = r.integers(0, 256, 16384, dtype=np.uint8)
    payload = r.integers(0, 256, n, dtype=np.uint8)
    want = np.asarray(jax_ring_scatter(jnp.asarray(ring0), jnp.asarray(payload),
                                       start, interpret=True))
    got = _emulate_on_data("ring_scatter", ring0, payload, start, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start,n", PALLAS_SPANS)
def test_emulated_window_matches_pallas_kernel(start, n):
    ring0 = np.random.default_rng(start * 7 + n).integers(0, 256, 16384,
                                                          dtype=np.uint8)
    want = np.asarray(jax_ring_window(jnp.asarray(ring0), start, n,
                                      interpret=True))
    got = _emulate_on_data("ring_window", ring0, None, start, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dst,src,n", [(0, 0, 4096), (3, 0, 4096),
                                       (0, 13, 100), (9, 2, 15), (1, 1, 0),
                                       (16, 31, 17)])
def test_segment_fields(dst, src, n):
    s = _span.Segment(*_span.segment(dst, src, n, chunk_words=8))
    assert s.head + 16 * s.words + s.tail == n
    assert 0 <= s.head < 16 and 0 <= s.tail < 16
    assert s.words == 0 or (dst + s.head) % 16 == 0
    assert s.skew == (src + s.head) % 16
    assert s.chunks == -(-s.words // 8)


def test_plan_fits_the_c_entries():
    plan = _span.scatter_plan(1 << 40, 16 << 20, (1 << 40) + (32 << 20) + 3,
                              (16 << 20) - 100, 4816901)
    for name in KERNELS:
        assert len(plan) + 1 == len(_build.KERNELS[name][1])  # + stream
    ints = [a for k, a in enumerate(plan) if k % 7 >= 2]
    assert all(0 <= a < 1 << 32 for a in ints)
    s0, s1 = _span.segments(plan)
    assert _span.grid(plan) == s0.chunks + s1.chunks


def test_segment_beyond_32_bit_offsets_raises():
    with pytest.raises(ValueError):
        _span.segment(0, 0, 1 << 32, chunk_words=512)
