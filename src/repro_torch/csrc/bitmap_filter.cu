// Block-bitmap conjunction on Hopper: AND of d term bitmaps, then popcount.
//
// Replaces repro/kernels/bitmap_filter/kernel.py::bitmap_and_popcount_planar
// (Pallas TPU):  anded[w] = AND_i bitmaps[i, w],  counts[w] = popcount(anded[w]).
// The TPU kernel read [d, rows, 128] planes padded to its 8×128 tiles and
// popcounted with a SWAR bit trick on its vector lanes; here a grid-stride
// loop gives each thread one word at a time, read from each of the d rows
// where the index keeps them (neighbouring threads on neighbouring words),
// and the hardware's __popc counts it.
//
// Bound: bytes — d·W·4 read and W·8 written for d−1 ANDs and one popcount
// per word, far below the card's operation rate.
#include "common.cuh"

namespace geo {

__global__ void __launch_bounds__(256) bitmap_and_popcount_kernel(
    const unsigned* __restrict__ bitmaps,  // [d, W]
    unsigned* __restrict__ anded,          // [W]
    int* __restrict__ counts,              // [W]
    int d, int64_t W) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; w < W;
       w += stride) {
    unsigned acc = __ldg(bitmaps + w);
    for (int i = 1; i < d; ++i) acc &= __ldg(bitmaps + i * W + w);
    anded[w] = acc;
    counts[w] = __popc(acc);
  }
}

}  // namespace geo

extern "C" int bitmap_and_popcount_launch(
    const void* bitmaps, void* anded, void* counts, int d, long long W, void* stream) {
  if (W <= 0 || d <= 0) return 0;
  const int threads = 256;
  const long long want = (W + threads - 1) / threads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  geo::bitmap_and_popcount_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(bitmaps), static_cast<unsigned*>(anded),
      static_cast<int*>(counts), d, static_cast<int64_t>(W));
  return static_cast<int>(cudaGetLastError());
}
