// Block-bitmap conjunction on Hopper: AND of d term bitmaps, then popcount.
//
// Replaces repro/kernels/bitmap_filter/kernel.py::bitmap_and_popcount_planar
// (Pallas TPU):  anded[w] = AND_i bitmaps[i, w],  counts[w] = popcount(anded[w]).
// The TPU kernel read [d, rows, 128] planes padded to its 8×128 tiles and
// popcounted with a SWAR bit trick on its vector lanes; here the [d, W]
// rows are read where the index keeps them and the hardware's __popc
// counts each word.
//
// Bound: bytes — d·W·4 read and W·8 written for d−1 ANDs and one popcount
// per word.  At the main path's size (d = 8, W = 32,768: 1 MB) the bytes
// take ~0.3 µs, below one launch, so what a launch costs beyond the launch
// itself is latency: a thread that ANDs row after row in a loop with a
// run-time trip count waits one memory latency per row.  Design:
//  - the kernel is templated on D = 1…8 rows and unrolled, so a thread
//    issues all D loads before its first AND (d > 8 runs as chunks of 8
//    then a last chunk of D, ANDing into the running words);
//  - a thread owns one 16-byte group of 4 words: one uint4 load from every
//    row, and the grid holds every group at once (W / 4 threads: the whole
//    input in flight, no grid-stride loop);
//  - rows whose starts are not all 16-byte aligned (W % 4 ≠ 0, or a row
//    block at an odd word offset) load the same 4 words as scalars, and
//    the group past W's last multiple of 4 is bounds-checked word by word;
//  - COUNT_ONLY (the conjunction prefilter) writes neither output: each
//    block sums its popcounts (warp shuffles, then the block's warps) and
//    adds it, with a ticket of 1 in the bits above SUM_BITS, to one 64-bit
//    word in one atomic; the block whose ticket completes the grid holds
//    every other block's sum in the old value, writes the total and zeroes
//    the word for the next launch.  Integer addition is exact and
//    order-free, so the result equals counts.sum() bit for bit, in one
//    launch and one atomic round trip per block.
#include "common.cuh"

namespace geo {

constexpr int BM_THREADS = 128;
constexpr int BM_WORDS = 4;  // words a thread owns: one uint4 per row
constexpr int BM_CHUNK = 8;  // rows loaded together
// COUNT_ONLY's word: the running sum below SUM_BITS (≤ 32·W < 2^38 set
// bits), the blocks' tickets above (< 2^24 blocks)
constexpr int SUM_BITS = 40;
constexpr unsigned long long SUM_MASK = (1ull << SUM_BITS) - 1;
constexpr long long MAX_COUNT_BLOCKS = 1ll << (64 - SUM_BITS);

template <bool VEC>
__device__ __forceinline__ uint4 load_group(const unsigned* __restrict__ p) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
}

// acc & rows[0..D) at words w … w+3: every load issued before any AND
template <int D, bool VEC>
__device__ __forceinline__ uint4 and_rows(
    uint4 acc, const unsigned* __restrict__ rows, int64_t W, int64_t w) {
  uint4 v[D];
#pragma unroll
  for (int i = 0; i < D; ++i) v[i] = load_group<VEC>(rows + i * W + w);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    acc.x &= v[i].x, acc.y &= v[i].y, acc.z &= v[i].z, acc.w &= v[i].w;
  }
  return acc;
}

// VEC: every row starts 16-byte aligned (base aligned, W % 4 == 0)
template <int D, bool VEC, bool COUNT_ONLY>
__global__ void __launch_bounds__(BM_THREADS) bitmap_and_popcount_kernel(
    const unsigned* __restrict__ bitmaps,  // [d, W], d ≡ D (mod 8), d ≥ D
    int d, int64_t W,
    unsigned* __restrict__ anded,          // [W]  (not COUNT_ONLY)
    int* __restrict__ counts,              // [W]  (not COUNT_ONLY)
    unsigned long long* __restrict__ scratch,  // [1]: tickets | running sum (COUNT_ONLY)
    long long* __restrict__ total) {       // [] (COUNT_ONLY)
  const int tid = threadIdx.x;
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * BM_THREADS + tid) * BM_WORDS;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  if (w + BM_WORDS <= W) {
    acc = make_uint4(~0u, ~0u, ~0u, ~0u);
    const unsigned* rows = bitmaps;
    for (int i = D; i < d; i += BM_CHUNK, rows += BM_CHUNK * W)
      acc = and_rows<BM_CHUNK, VEC>(acc, rows, W, w);
    acc = and_rows<D, VEC>(acc, rows, W, w);
    if constexpr (!COUNT_ONLY) {
      *reinterpret_cast<uint4*>(anded + w) = acc;
      *reinterpret_cast<int4*>(counts + w) =
          make_int4(__popc(acc.x), __popc(acc.y), __popc(acc.z), __popc(acc.w));
    }
  } else if (w < W) {  // the last, partial group: words past W stay 0
    unsigned a[BM_WORDS];
#pragma unroll
    for (int k = 0; k < BM_WORDS; ++k) a[k] = w + k < W ? ~0u : 0u;
    for (int i = 0; i < d; ++i) {
#pragma unroll
      for (int k = 0; k < BM_WORDS; ++k)
        if (w + k < W) a[k] &= __ldg(bitmaps + i * W + w + k);
    }
#pragma unroll
    for (int k = 0; k < BM_WORDS; ++k) {
      if constexpr (!COUNT_ONLY) {
        if (w + k < W) anded[w + k] = a[k], counts[w + k] = __popc(a[k]);
      }
    }
    acc = make_uint4(a[0], a[1], a[2], a[3]);
  }
  if constexpr (COUNT_ONLY) {
    __shared__ unsigned warp_sum[BM_THREADS / 32];
    unsigned c = __popc(acc.x) + __popc(acc.y) + __popc(acc.z) + __popc(acc.w);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (tid % 32 == 0) warp_sum[tid / 32] = c;
    __syncthreads();
    if (tid == 0) {
      unsigned long long s = 0;
#pragma unroll
      for (int i = 0; i < BM_THREADS / 32; ++i) s += warp_sum[i];
      const unsigned long long old = atomicAdd(scratch, (1ull << SUM_BITS) | s);
      if ((old >> SUM_BITS) == gridDim.x - 1) {  // the last block: old holds the others'
        *total = static_cast<long long>((old & SUM_MASK) + s);
        *scratch = 0ull;
      }
    }
  }
}

template <int D>
int launch_d(const unsigned* bm, int d, int64_t W, unsigned* anded, int* counts,
             unsigned long long* scratch, long long* total, bool vec, cudaStream_t s) {
  const int64_t groups = (W + BM_WORDS - 1) / BM_WORDS;
  const int64_t blocks = (groups + BM_THREADS - 1) / BM_THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const bool count_only = total != nullptr;
  if (count_only && blocks >= MAX_COUNT_BLOCKS) return static_cast<int>(cudaErrorInvalidValue);
  if (vec && count_only)
    bitmap_and_popcount_kernel<D, true, true><<<grid, BM_THREADS, 0, s>>>(bm, d, W, anded, counts, scratch, total);
  else if (vec)
    bitmap_and_popcount_kernel<D, true, false><<<grid, BM_THREADS, 0, s>>>(bm, d, W, anded, counts, scratch, total);
  else if (count_only)
    bitmap_and_popcount_kernel<D, false, true><<<grid, BM_THREADS, 0, s>>>(bm, d, W, anded, counts, scratch, total);
  else
    bitmap_and_popcount_kernel<D, false, false><<<grid, BM_THREADS, 0, s>>>(bm, d, W, anded, counts, scratch, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace geo

// Writes anded and counts; or, with total non-null, only *total = Σ counts
// (scratch: one zeroed u64 word, zero again after each launch).  W ≥ 1.
extern "C" int bitmap_and_popcount_launch(
    const void* bitmaps, void* anded, void* counts, void* scratch, void* total,
    int d, long long W, void* stream) {
  using namespace geo;
  if (d <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* tot = static_cast<long long*>(total);
  const auto* bm = static_cast<const unsigned*>(bitmaps);
  const bool vec = reinterpret_cast<uintptr_t>(bm) % 16 == 0 && W % BM_WORDS == 0;
  auto* a = static_cast<unsigned*>(anded);
  auto* c = static_cast<int*>(counts);
  auto* sc = static_cast<unsigned long long*>(scratch);
  switch ((d - 1) % BM_CHUNK + 1) {  // the last chunk's rows
    case 1: return launch_d<1>(bm, d, W, a, c, sc, tot, vec, s);
    case 2: return launch_d<2>(bm, d, W, a, c, sc, tot, vec, s);
    case 3: return launch_d<3>(bm, d, W, a, c, sc, tot, vec, s);
    case 4: return launch_d<4>(bm, d, W, a, c, sc, tot, vec, s);
    case 5: return launch_d<5>(bm, d, W, a, c, sc, tot, vec, s);
    case 6: return launch_d<6>(bm, d, W, a, c, sc, tot, vec, s);
    case 7: return launch_d<7>(bm, d, W, a, c, sc, tot, vec, s);
    default: return launch_d<8>(bm, d, W, a, c, sc, tot, vec, s);
  }
}
