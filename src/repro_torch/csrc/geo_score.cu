// Per-toe-print geographic scores on Hopper.
//
// Replaces repro/kernels/geo_score/kernel.py::geo_score_planar (Pallas TPU):
//     out[b, t] = amp[b, t] * Σ_j area(rect[b, t] ∩ q[b, j]) · q_amp[b, j],  j < Q_MAX
// with an explicit batch axis: row b of the [B, T] positions is scored
// against query b's Q_MAX zero-padded slots.
//
// Bound: bytes.  Each position reads 20 B (a float4 rect and an amp) and
// writes 4 B for 11 f32 operations per live slot, below the H100's
// flop/byte ridge.  A thread per position that divides its index by T
// (64-bit, emulated in software) and sums all 8 slots issues ~150
// instructions a position, which puts it near the card's issue rate, not
// its bytes.  The design takes that issue work out:
//  - a 2-D grid: blockIdx.y is the query row (looping when B > 65,535),
//    blockIdx.x a run of GEO_SPAN of its positions, so no thread divides;
//  - the row's slots and live mask are staged once per block in shared
//    memory; all threads of a block share one row, so the slot loop does
//    not diverge, and it visits the live slots only, in slot order
//    (live_slot, common.cuh: the all-slot sum's bit patterns); the query
//    is read as the caller holds it ([B, Q] slots, Q ≤ Q_MAX) and the
//    slots past Q are the zero padding, dead, so nothing pads it first;
//  - GEO_PER_THREAD positions a thread, loads first: four float4 rects
//    and one float4 of amps are issued before the block waits for the
//    query, and the scores are written as one float4.
// Rows are cut into 16-byte groups of the [B, T] frame (row b starts at
// word b·T), so a row whose start is not 16-byte aligned begins and ends
// with a partial group, scored position by position with bounds checks.
// Inputs whose base is not 16-byte aligned (a view at an odd storage
// offset) take the same scalar path for every group.
//
// NaN: torch.minimum, torch.maximum and torch.clamp propagate a NaN, and
// the plain version is held to them, so min/max here are PTX's min.NaN /
// max.NaN, not fminf/fmaxf (which drop it).  For a store rect without a
// NaN coordinate the two agree, and common.cuh's proof that a dead slot
// adds exactly ±0 holds.  A store rect with a NaN coordinate makes every
// slot's term NaN, dead ones included: the all-slot sum is NaN, and so is
// the live-slot sum unless the row has no live slot.  Such a row sums
// slot 0 alone, which gives NaN there and +0 everywhere else: the
// all-slot result in every case.
#include "common.cuh"

namespace geo {

constexpr int GEO_THREADS = 256;
constexpr int GEO_PER_THREAD = 4;  // one 16-byte group of amps / scores
constexpr int GEO_SPAN = GEO_THREADS * GEO_PER_THREAD;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// add_slot's step with the plain version's NaN-propagating min and max
__device__ __forceinline__ float add_slot_nan(float acc, float4 r, float4 q, float qa) {
  const float w = max_nan(min_nan(r.z, q.z) - max_nan(r.x, q.x), 0.0f);
  const float h = max_nan(min_nan(r.w, q.w) - max_nan(r.y, q.y), 0.0f);
  return acc + (w * h) * qa;
}

template <bool VEC>
__device__ __forceinline__ float4 load_rect(const float* __restrict__ rects, int64_t p) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const float4*>(rects) + p);
  } else {
    const float* r = rects + p * 4;
    return make_float4(__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3));
  }
}

// VEC: rects and amps start 16-byte aligned (out always does: the wrapper
// allocates it), so every full group is read and written with 16-byte
// accesses; else every group takes the scalar path.
template <bool VEC>
__global__ void __launch_bounds__(GEO_THREADS) geo_score_kernel(
    const float* __restrict__ rects,     // [B, T, 4] packed (x0, y0, x1, y1)
    const float* __restrict__ amps,      // [B, T]
    const float* __restrict__ q_rects,   // [B, Q, 4], Q ≤ Q_MAX
    const float* __restrict__ q_amps,    // [B, Q]
    float* __restrict__ out,             // [B, T]
    int B, int64_t T, int Q) {
  __shared__ float4 s_q[Q_MAX];
  __shared__ float s_qa[Q_MAX];
  __shared__ unsigned s_mask;
  const int tid = threadIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const int64_t row = static_cast<int64_t>(b) * T;
    // group g of the row holds positions 4g − off … 4g − off + 3
    const int off = VEC ? static_cast<int>(row & 3) : 0;
    const int64_t n_groups = (off + T + GEO_PER_THREAD - 1) / GEO_PER_THREAD;
    if (static_cast<int64_t>(blockIdx.x) * GEO_THREADS >= n_groups) continue;  // whole block
    const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * GEO_THREADS + tid) * GEO_PER_THREAD - off;
    const bool full = VEC && p0 >= 0 && p0 + GEO_PER_THREAD <= T;
    // loads first: this thread's rects and amps, then the row's query
    float4 r[GEO_PER_THREAD];
    float a[GEO_PER_THREAD];
    if (full) {
#pragma unroll
      for (int k = 0; k < GEO_PER_THREAD; ++k) r[k] = load_rect<VEC>(rects, row + p0 + k);
      const float4 av = __ldg(reinterpret_cast<const float4*>(amps + row + p0));
      a[0] = av.x, a[1] = av.y, a[2] = av.z, a[3] = av.w;
    } else {
#pragma unroll
      for (int k = 0; k < GEO_PER_THREAD; ++k) {
        const int64_t p = p0 + k;
        const bool in = p >= 0 && p < T;
        r[k] = in ? load_rect<VEC>(rects, row + p) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        a[k] = in ? __ldg(amps + row + p) : 0.0f;
      }
    }
    if (tid < 32) {
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float qa = 0.0f;
      if (tid < Q_MAX) {  // slots past Q: the zero padding (dead)
        if (tid < Q) {
          const float* qp = q_rects + (static_cast<int64_t>(b) * Q + tid) * 4;
          q = make_float4(__ldg(qp), __ldg(qp + 1), __ldg(qp + 2), __ldg(qp + 3));
          qa = __ldg(q_amps + static_cast<int64_t>(b) * Q + tid);
        }
        s_q[tid] = q;
        s_qa[tid] = qa;
      }
      const unsigned m = __ballot_sync(0xffffffffu, tid < Q_MAX && live_slot(q, qa));
      if (tid == 0) s_mask = m ? m : 1u;  // no live slot: slot 0 alone (see above)
    }
    __syncthreads();
    const unsigned mask = s_mask;
    float acc[GEO_PER_THREAD];
#pragma unroll
    for (int k = 0; k < GEO_PER_THREAD; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < Q_MAX; ++j) {
      if (mask >> j & 1u) {
        const float4 q = s_q[j];
        const float qa = s_qa[j];
#pragma unroll
        for (int k = 0; k < GEO_PER_THREAD; ++k) acc[k] = add_slot_nan(acc[k], r[k], q, qa);
      }
    }
    if (full) {
      *reinterpret_cast<float4*>(out + row + p0) =
          make_float4(acc[0] * a[0], acc[1] * a[1], acc[2] * a[2], acc[3] * a[3]);
    } else {
#pragma unroll
      for (int k = 0; k < GEO_PER_THREAD; ++k) {
        const int64_t p = p0 + k;
        if (p >= 0 && p < T) out[row + p] = acc[k] * a[k];
      }
    }
    __syncthreads();  // the next row restages the query
  }
}

}  // namespace geo

// q_rects [B, Q, 4] and q_amps [B, Q] as the caller holds them: the slots
// past Q are read as the zero padding, so the wrapper pads nothing.
extern "C" int geo_score_launch(
    const void* rects, const void* amps, const void* q_rects, const void* q_amps,
    void* out, long long B, long long T, int Q, void* stream) {
  using namespace geo;
  if (B <= 0 || T <= 0) return 0;
  if (B > 0x7fffffffLL || Q < 0 || Q > Q_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(rects) | reinterpret_cast<uintptr_t>(amps) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  // a row's groups span at most T + 3 positions (a start off 16 bytes)
  const long long bx = (T + 3 + GEO_SPAN - 1) / GEO_SPAN;
  if (bx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(B < MAX_GRID_Y ? B : MAX_GRID_Y));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qr = static_cast<const float*>(q_rects);
  const auto* qa = static_cast<const float*>(q_amps);
  if (vec) {
    geo_score_kernel<true><<<grid, GEO_THREADS, 0, s>>>(
        static_cast<const float*>(rects), static_cast<const float*>(amps), qr, qa,
        static_cast<float*>(out), static_cast<int>(B), static_cast<int64_t>(T), Q);
  } else {
    geo_score_kernel<false><<<grid, GEO_THREADS, 0, s>>>(
        static_cast<const float*>(rects), static_cast<const float*>(amps), qr, qa,
        static_cast<float*>(out), static_cast<int>(B), static_cast<int64_t>(T), Q);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
