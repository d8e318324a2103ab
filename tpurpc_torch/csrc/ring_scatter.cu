// ring_scatter: land a payload in a device byte ring, across the wrap point.
//
//   ring[(start + i) mod cap] = payload[i]      for i < n
//
// Replaces the Pallas kernel of tpurpc/ops/ring_scatter.py (_kernel,
// _ring_scatter_impl, pallas_call at line 133), which HbmRing.place /
// place_many / fill use for a span that crosses the ring's end. Any byte
// offset and length are taken. The host (ops/_span.py scatter_plan) splits
// the span into [ring + p, payload, first) and [ring, payload + first,
// n - first) and cuts each segment; the copy engine is ring_copy.cuh.
//
// Bound on an H100: 2*n bytes of memory traffic at 3.35 TB/s, 0.002876 ms
// for a 4,816,896-byte request span. What the design does about it (see
// ring_copy.cuh): one flat chunk space over both segments and a grid of at
// most the resident blocks, so no block idles; eight 16-byte loads in
// flight per lane; a destination skewed against the payload (every landing
// after a leaf whose size is not a multiple of 16) is realigned in
// registers and still written with aligned 16-byte stores. The ring's
// bytes are stored with the default cache policy: HbmRing.view reads them
// next.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC ring_scatter.cu

#include "ring_copy.cuh"

namespace {

__global__ void __launch_bounds__(tpr::kThreads)
    ring_scatter_kernel(tpr::Seg s0, tpr::Seg s1, uint32_t chunk_words) {
  tpr::copy_span(s0, s1, chunk_words);
}

}  // namespace

// Both segments' plan (ops/_span.py kernel_args), then the stream. Launches
// on `stream` and returns cudaGetLastError(). The caller checks that the
// segments lie inside the ring and the payload.
extern "C" int tpr_ring_scatter(void* dst0, const void* src0, uint32_t head0,
                                uint32_t words0, uint32_t tail0,
                                uint32_t skew0, uint32_t chunks0, void* dst1,
                                const void* src1, uint32_t head1,
                                uint32_t words1, uint32_t tail1,
                                uint32_t skew1, uint32_t chunks1,
                                uint32_t chunk_words, void* stream) {
  static const int max_blocks = tpr::resident_blocks(ring_scatter_kernel);
  const tpr::Seg s0 =
      tpr::make_seg(dst0, src0, head0, words0, tail0, skew0, chunks0);
  const tpr::Seg s1 =
      tpr::make_seg(dst1, src1, head1, words1, tail1, skew1, chunks1);
  ring_scatter_kernel<<<tpr::grid_blocks(s0, s1, max_blocks), tpr::kThreads,
                        0, (cudaStream_t)stream>>>(s0, s1, chunk_words);
  return (int)cudaGetLastError();
}
