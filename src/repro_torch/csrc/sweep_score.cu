// Fused K-SWEEP fetch + geo scoring on Hopper, plain and block-max pruned.
//
// sweep_score_kernel replaces repro/kernels/sweep_score/kernel.py::
// sweep_score_planar.  Sweep i of query b reads the toe-print store from the
// TILE-aligned window origin block_starts[b, i] (a device i32 tensor: each
// block reads its own offset where the TPU scalar-prefetched it) and scores
// every position in registers, decoding the stored dtype: astype f32, then
// × the int8 store's per-128-row amp scale.  The store is read where the
// index keeps it — packed [T, 4] rects (one 16-byte f32 or 8-byte f16 load
// per position, neighbours on neighbouring addresses) and a [T] amp column —
// so no per-batch planar copy exists; the TPU's planar [rows, 128] layout
// served its vector lanes.  Positions past the store's end issue no loads
// and score 0, as the reference's empty-rect padding does.  One thread per
// position.
//
// sweep_score_pruned_kernel replaces sweep_score_pruned_planar.  Its θ
// buffer carries state from tile to tile in order, so one CTA walks one
// query's (sweep, tile) lattice sequentially, as the TPU grid did:
//   * the cb·1024-float partial top-C buffer sits in shared memory; thread
//     `tid` owns column tid of every slot (the tile position it scores), so
//     folding a tile into its slot needs no synchronisation;
//   * θ = block-wide min of the buffer, taken before each tile's decisions;
//   * a metadata block whose bound does not beat θ issues no loads at all,
//     and its outputs are zero.
// The per-tile min adds two barriers.
#include "common.cuh"

namespace geo {

__device__ __forceinline__ float4 load_rect(const float* rects, int64_t p) {
  return __ldg(reinterpret_cast<const float4*>(rects) + p);
}

__device__ __forceinline__ float4 load_rect(const __half* rects, int64_t p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(rects) + p);
  const __half2 lo = *reinterpret_cast<const __half2*>(&u.x);
  const __half2 hi = *reinterpret_cast<const __half2*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// score of store position p; past the end (p >= T) no loads, score 0
template <typename CT, typename AT>
__device__ __forceinline__ float score_at(
    const CT* __restrict__ rects, const AT* __restrict__ amp,
    const float* __restrict__ scale, int64_t p, int64_t T,
    const float4* q, const float* qa) {
  if (p >= T) return 0.0f;
  float a = to_f32(amp[p]);
  if (scale != nullptr) a = a * scale[p / LANES];
  const float4 r = load_rect(rects, p);
  return score_rect(r.x, r.y, r.z, r.w, q, qa) * a;
}

template <typename CT, typename AT>
__global__ void __launch_bounds__(256) sweep_score_kernel(
    const int* __restrict__ block_starts,  // [B, k] window origins, TILE units
    const float4* __restrict__ q_rects,    // [B, Q_MAX]
    const float* __restrict__ q_amps,      // [B, Q_MAX]
    const CT* __restrict__ rects,          // [T, 4] packed (x0, y0, x1, y1)
    const AT* __restrict__ amp,            // [T]
    const float* __restrict__ scale,       // [ceil(T / LANES)] or null
    float* __restrict__ out,               // [B, k, pad_budget]
    int k, int pad_budget, int64_t T) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pad_budget) return;
  const int i = blockIdx.y, b = blockIdx.z;
  const int64_t p = static_cast<int64_t>(block_starts[b * k + i]) * TILE + e;
  out[(static_cast<int64_t>(b) * k + i) * pad_budget + e] =
      score_at(rects, amp, scale, p, T, q_rects + b * Q_MAX, q_amps + b * Q_MAX);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename CT, typename AT>
__global__ void __launch_bounds__(TILE) sweep_score_pruned_kernel(
    const int* __restrict__ block_starts,  // [B, k] window origins, TILE units
    const int* __restrict__ bounds,        // [B, k, 2] exact [start, end)
    const float* __restrict__ floor_,      // [B] select floor (≥ 0)
    const float* __restrict__ ub,          // [B, k, n_tiles * bpt] block bounds
    const float4* __restrict__ q_rects,    // [B, Q_MAX]
    const float* __restrict__ q_amps,      // [B, Q_MAX]
    const CT* __restrict__ rects,          // [T, 4]
    const AT* __restrict__ amp,            // [T]
    const float* __restrict__ scale,       // [ceil(T / LANES)] or null
    float* __restrict__ out,               // [B, k, n_tiles * TILE]
    int* __restrict__ scored,              // [B, k, n_tiles * bpt]
    int k, int n_tiles, int cb, int bpt, int64_t T) {
  extern __shared__ float buf[];  // [cb, TILE], column tid owned by thread tid
  __shared__ float warp_mins[TILE / 32];
  __shared__ float theta_s;
  __shared__ float4 sq[Q_MAX];
  __shared__ float sa[Q_MAX];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  if (tid < Q_MAX) {
    sq[tid] = q_rects[b * Q_MAX + tid];
    sa[tid] = q_amps[b * Q_MAX + tid];
  }
  // seed every slot with the selection floor: θ never drops below it
  const float fl = floor_[b];
  for (int s = 0; s < cb; ++s) buf[s * TILE + tid] = fl;
  const int block_size = TILE / bpt;
  const int my_blk = tid / block_size;
  const int n_ub = n_tiles * bpt;
  for (int i = 0; i < k; ++i) {
    const int64_t row = static_cast<int64_t>(b) * k + i;
    const int64_t base = static_cast<int64_t>(block_starts[row]) * TILE;
    const int lo = bounds[row * 2], hi = bounds[row * 2 + 1];
    for (int j = 0; j < n_tiles; ++j) {
      // θ = min over the whole buffer, before this tile's decisions
      float m = buf[tid];
      for (int s = 1; s < cb; ++s) m = fminf(m, buf[s * TILE + tid]);
      m = warp_min(m);
      if (lane == 0) warp_mins[warp] = m;
      __syncthreads();
      if (warp == 0) {
        const float v = warp_min(warp_mins[lane]);
        if (lane == 0) theta_s = v;
      }
      __syncthreads();
      const float theta = theta_s;
      const bool sb = ub[row * n_ub + j * bpt + my_blk] > theta;
      if (tid % block_size == 0) scored[row * n_ub + j * bpt + my_blk] = sb ? 1 : 0;
      const int64_t p = base + static_cast<int64_t>(j) * TILE + tid;
      float sc = 0.0f;
      if (sb) {  // a skipped block issues no loads
        sc = score_at(rects, amp, scale, p, T, sq, sa);
        // only genuine [start, end) candidates feed the θ buffer
        const float masked = (p >= lo && p < hi) ? sc : 0.0f;
        float* slot = buf + ((i * n_tiles + j) % cb) * TILE + tid;
        *slot = fmaxf(*slot, masked);
      }
      out[(row * n_tiles + j) * TILE + tid] = sc;
    }
  }
}

// p: block_starts, [bounds, floor, ub,] q_rects, q_amps, rects, amp, scale,
// out[, scored] — in the C entry points' order
template <typename CT, typename AT>
struct Plain {
  static int run(const void* const* p, int B, int k, int pad_budget, int64_t T,
                 cudaStream_t st) {
    const dim3 grid((pad_budget + 255) / 256, k, B);
    sweep_score_kernel<CT, AT><<<grid, 256, 0, st>>>(
        static_cast<const int*>(p[0]), static_cast<const float4*>(p[1]),
        static_cast<const float*>(p[2]), static_cast<const CT*>(p[3]),
        static_cast<const AT*>(p[4]), static_cast<const float*>(p[5]),
        static_cast<float*>(const_cast<void*>(p[6])), k, pad_budget, T);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename CT, typename AT>
struct Pruned {
  static int run(const void* const* p, int B, int k, int n_tiles, int cb, int bpt,
                 int64_t T, cudaStream_t st) {
    const size_t smem = static_cast<size_t>(cb) * TILE * sizeof(float);
    auto kern = sweep_score_pruned_kernel<CT, AT>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<B, TILE, smem, st>>>(
        static_cast<const int*>(p[0]), static_cast<const int*>(p[1]),
        static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
        static_cast<const float4*>(p[4]), static_cast<const float*>(p[5]),
        static_cast<const CT*>(p[6]), static_cast<const AT*>(p[7]),
        static_cast<const float*>(p[8]), static_cast<float*>(const_cast<void*>(p[9])),
        static_cast<int*>(const_cast<void*>(p[10])), k, n_tiles, cb, bpt, T);
    return static_cast<int>(cudaGetLastError());
  }
};

// the three stores the index's compress modes produce: none = f32/f32,
// f16 = f16/f16, int8 = f16 coordinates with int8 amplitudes
template <template <typename, typename> class F, typename... Args>
int dispatch(int coord_kind, int amp_kind, Args... args) {
  if (coord_kind == F32 && amp_kind == F32) return F<float, float>::run(args...);
  if (coord_kind == F16 && amp_kind == F16) return F<__half, __half>::run(args...);
  if (coord_kind == F16 && amp_kind == I8) return F<__half, int8_t>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace geo

extern "C" int sweep_score_launch(
    const void* block_starts, const void* q_rects, const void* q_amps,
    const void* rects, const void* amp, const void* scale, void* out,
    int B, int k, int pad_budget, long long T, int coord_kind, int amp_kind,
    void* stream) {
  if (B <= 0 || k <= 0 || pad_budget <= 0) return 0;
  const void* p[] = {block_starts, q_rects, q_amps, rects, amp, scale, out};
  return geo::dispatch<geo::Plain>(coord_kind, amp_kind, static_cast<const void* const*>(p),
                                   B, k, pad_budget, static_cast<int64_t>(T),
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int sweep_score_pruned_launch(
    const void* block_starts, const void* bounds, const void* floor_, const void* ub,
    const void* q_rects, const void* q_amps,
    const void* rects, const void* amp, const void* scale, void* out, void* scored,
    int B, int k, int n_tiles, int cb, int bpt, long long T, int coord_kind,
    int amp_kind, void* stream) {
  if (B <= 0 || k <= 0 || n_tiles <= 0) return 0;
  const void* p[] = {block_starts, bounds, floor_, ub, q_rects, q_amps,
                     rects, amp, scale, out, scored};
  return geo::dispatch<geo::Pruned>(coord_kind, amp_kind, static_cast<const void* const*>(p),
                                    B, k, n_tiles, cb, bpt, static_cast<int64_t>(T),
                                    static_cast<cudaStream_t>(stream));
}
