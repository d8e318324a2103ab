// Copy engine shared by the two device-ring kernels (ring_scatter.cu,
// ring_window.cu).
//
// A span of a ring may cross the wrap point, so a kernel copies at most two
// contiguous segments. The host plans them (tpurpc_torch/ops/_span.py): each
// segment is a head of fewer than 16 bytes that brings the destination to
// 16-byte alignment, a body of 16-byte destination words, and a tail of
// fewer than 16 bytes; the body is cut into chunks of `chunk_words` words.
// Every destination byte has exactly one writer, so blocks run in any order
// and nothing is read back.
//
// Bound on an H100: pure data movement, 2*n bytes (n read, n written) at
// 3.35 TB/s, 0.002876 ms for one 4,816,896-byte request span. The design:
//
// - One flat work space. The chunks of both segments are numbered in one
//   index space; block b takes chunks b, b + grid, ... The grid is
//   min(chunks, resident blocks on the card), so no launched block is idle
//   and no segment restarts its indices at 0.
// - Bytes in flight. A warp copies runs of 32 * kUnroll consecutive words:
//   each lane issues its kUnroll 16-byte loads (a warp's load covers 512
//   contiguous bytes) before its first store, with 32-bit index math inside
//   a segment. At a request's span the whole span is in flight at once.
// - Skew in registers. The body is stored with aligned 16-byte stores in
//   every case. When the source is not 16-byte aligned against the
//   destination, the lanes load ALIGNED source words; a destination word is
//   built from a lane's word and the next one (taken from the neighbouring
//   lane with __shfl_down_sync; lane 31 takes lane 0's word of the next
//   step, and one extra load at the end of each run), shifted by the skew
//   with __funnelshift_r. A skewed span then moves as many bytes per
//   instruction as an aligned one. An aligned source word that holds a byte
//   of the segment lies in the same 16-byte granule as that byte, so these
//   loads never leave the source allocation's pages.
// - Heads and tails: fewer than 16 bytes at each end of each segment,
//   written byte by byte by warp 0 of block 0.
// - Cache policy: loads are streaming (__ldcs): the kernel reads each
//   source byte once. Stores keep the default policy: the ring's bytes
//   (ring_scatter) are read next by HbmRing.view, and the gathered window
//   (ring_window) by the model.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpr {

constexpr int kThreads = 128;           // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;              // 16-byte loads in flight per lane
constexpr uint32_t kRun = 32 * kUnroll; // words of one warp run
// A block's pass covers kThreads * kUnroll * 16 = 16 KiB, the chunk size
// the host plans (ops/_span.py CHUNK_BYTES): every warp of a block has one
// run per chunk. Measured on an H100 (PERF.md): 8 loads in flight
// beat 4 by about 2 %; chunks of one pass beat chunks of several.

// One contiguous segment, as planned on the host (ops/_span.py Segment).
struct Seg {
  uint8_t* dst;         // first destination byte
  const uint8_t* src;   // first source byte
  uint32_t head;        // bytes before dst + head is 16-byte aligned
  uint32_t words;       // 16-byte destination words of the body
  uint32_t tail;        // bytes after the body
  uint32_t skew;        // (src + head) mod 16
  uint32_t chunks;      // ceil(words / chunk_words)
};

__device__ __forceinline__ uint4 shfl_down1(uint4 v) {
  return make_uint4(__shfl_down_sync(0xffffffffu, v.x, 1),
                    __shfl_down_sync(0xffffffffu, v.y, 1),
                    __shfl_down_sync(0xffffffffu, v.z, 1),
                    __shfl_down_sync(0xffffffffu, v.w, 1));
}

__device__ __forceinline__ uint4 shfl_lane0(uint4 v) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, 0),
                    __shfl_sync(0xffffffffu, v.y, 0),
                    __shfl_sync(0xffffffffu, v.z, 0),
                    __shfl_sync(0xffffffffu, v.w, 0));
}

// The 16 bytes that start `skew` bytes into lo:hi (two aligned source
// words, little-endian): a select by whole 32-bit words, then a funnel
// shift by the remaining bytes.
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, uint32_t skew) {
  const uint32_t q = skew >> 2;
  const uint32_t sh = (skew & 3) * 8;
  const uint32_t a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t b[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    b[j] = q == 0 ? a[j] : q == 1 ? a[j + 1] : q == 2 ? a[j + 2] : a[j + 3];
  }
  return make_uint4(__funnelshift_r(b[0], b[1], sh),
                    __funnelshift_r(b[1], b[2], sh),
                    __funnelshift_r(b[2], b[3], sh),
                    __funnelshift_r(b[3], b[4], sh));
}

// Words [begin, end) of one body, by one warp: dst is the body's first
// (aligned) destination word, src the aligned source word under it. A
// skewed word i needs source words i and i + 1; source word `end` holds a
// byte of the segment whenever skew > 0, so it may be read.
template <bool kSkew>
__device__ __forceinline__ void copy_words(uint4* dst, const uint4* src,
                                           uint32_t skew, uint32_t begin,
                                           uint32_t end, uint32_t lane,
                                           uint32_t warp) {
  for (uint32_t run = begin + warp * kRun; run < end; run += kWarps * kRun) {
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint32_t i = run + 32 * k + lane;
      v[k] = (i < end || (kSkew && i == end)) ? __ldcs(src + i)
                                              : make_uint4(0, 0, 0, 0);
    }
    uint4 extra = make_uint4(0, 0, 0, 0);
    if (kSkew && lane == 31 && run + kRun - 1 < end) {
      extra = __ldcs(src + run + kRun);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint32_t i = run + 32 * k + lane;
      uint4 w = v[k];
      if (kSkew) {
        uint4 next = shfl_down1(v[k]);
        const uint4 carry =
            k + 1 < kUnroll ? shfl_lane0(v[k + 1 < kUnroll ? k + 1 : 0])
                            : extra;
        if (lane == 31) next = carry;
        w = realign(v[k], next, skew);
      }
      if (i < end) dst[i] = w;
    }
  }
}

// Heads and tails of both segments, by one warp: lanes 0-15 copy a head's
// bytes, lanes 16-31 a tail's, first of segment 0, then of segment 1.
__device__ __forceinline__ void copy_edges(const Seg& s0, const Seg& s1,
                                           uint32_t lane) {
  const uint32_t k = lane & 15;
  const bool tail = lane & 16;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Seg& s = half ? s1 : s0;
    if (k < (tail ? s.tail : s.head)) {
      const uint32_t off = tail ? s.head + 16 * s.words + k : k;
      s.dst[off] = s.src[off];
    }
  }
}

__device__ __forceinline__ void copy_span(const Seg& s0, const Seg& s1,
                                          uint32_t chunk_words) {
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t warp = threadIdx.x >> 5;
  if (blockIdx.x == 0 && warp == 0) copy_edges(s0, s1, lane);
  const uint32_t chunks = s0.chunks + s1.chunks;
  for (uint32_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const bool second = c >= s0.chunks;
    const uint32_t begin = (second ? c - s0.chunks : c) * chunk_words;
    const uint32_t words = second ? s1.words : s0.words;
    const uint32_t end = min(begin + chunk_words, words);
    const uint32_t head = second ? s1.head : s0.head;
    const uint32_t skew = second ? s1.skew : s0.skew;
    uint4* dst = reinterpret_cast<uint4*>((second ? s1.dst : s0.dst) + head);
    const uint4* src = reinterpret_cast<const uint4*>(
        (second ? s1.src : s0.src) + head - skew);
    if (skew == 0) {
      copy_words<false>(dst, src, 0, begin, end, lane, warp);
    } else {
      copy_words<true>(dst, src, skew, begin, end, lane, warp);
    }
  }
}

// Resident blocks of `kernel` across the card (kThreads a block).
template <typename Kernel>
inline int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// One block per chunk up to the resident limit, at least one for the
// heads and tails (ops/_span.py grid).
inline unsigned grid_blocks(const Seg& s0, const Seg& s1, int max_blocks) {
  const uint32_t chunks = s0.chunks + s1.chunks;
  const uint32_t g = chunks < (uint32_t)max_blocks ? chunks : max_blocks;
  return g > 0 ? g : 1;
}

inline Seg make_seg(void* dst, const void* src, uint32_t head, uint32_t words,
                    uint32_t tail, uint32_t skew, uint32_t chunks) {
  return Seg{(uint8_t*)dst, (const uint8_t*)src, head, words, tail, skew,
             chunks};
}

}  // namespace tpr
