// ring_window: gather a contiguous copy of a span of a device byte ring.
//
//   out[i] = ring[(head + i) mod cap]      for i < n
//
// Replaces the Pallas kernel of tpurpc/ops/ring_window.py (_kernel,
// _ring_window_impl, pallas_call at line 138), which HbmRing.view uses for a
// span that crosses the ring's end. Any byte offset and length are taken.
// The host (ops/_span.py window_plan) splits the span into [out, ring + p,
// first) and [out + first, ring, n - first) and cuts each segment; the copy
// engine is ring_copy.cuh.
//
// Bound on an H100: 2*n bytes of memory traffic at 3.35 TB/s, 0.002876 ms
// for a 4,816,896-byte request span. What the design does about it (see
// ring_copy.cuh): one flat chunk space over both segments and a grid of at
// most the resident blocks, so no block idles; eight 16-byte loads in
// flight per lane; a ring offset that is not a multiple of 16 is realigned
// in registers and the output still written with aligned 16-byte stores.
// The ring is read with streaming loads (each byte once); the output keeps
// the default store policy: the model reads it next.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC ring_window.cu

#include "ring_copy.cuh"

namespace {

__global__ void __launch_bounds__(tpr::kThreads)
    ring_window_kernel(tpr::Seg s0, tpr::Seg s1, uint32_t chunk_words) {
  tpr::copy_span(s0, s1, chunk_words);
}

}  // namespace

// Both segments' plan (ops/_span.py kernel_args), then the stream. Launches
// on `stream` and returns cudaGetLastError(). The caller checks that the
// segments lie inside the ring and the output.
extern "C" int tpr_ring_window(void* dst0, const void* src0, uint32_t head0,
                               uint32_t words0, uint32_t tail0,
                               uint32_t skew0, uint32_t chunks0, void* dst1,
                               const void* src1, uint32_t head1,
                               uint32_t words1, uint32_t tail1,
                               uint32_t skew1, uint32_t chunks1,
                               uint32_t chunk_words, void* stream) {
  static const int max_blocks = tpr::resident_blocks(ring_window_kernel);
  const tpr::Seg s0 =
      tpr::make_seg(dst0, src0, head0, words0, tail0, skew0, chunks0);
  const tpr::Seg s1 =
      tpr::make_seg(dst1, src1, head1, words1, tail1, skew1, chunks1);
  ring_window_kernel<<<tpr::grid_blocks(s0, s1, max_blocks), tpr::kThreads,
                       0, (cudaStream_t)stream>>>(s0, s1, chunk_words);
  return (int)cudaGetLastError();
}
