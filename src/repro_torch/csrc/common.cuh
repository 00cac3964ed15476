// Shared pieces of the port's hand-written Hopper kernels.
//
// Build rule: every source is compiled with -fmad=false.  The plain PyTorch
// versions run each multiply and add as its own rounded op, so the kernels
// must not contract `acc + (w*h)*qa` into an FMA; without contraction they
// are bitwise equal to the plain versions, which keeps the pruned sweep's
// θ trajectory and skip flags identical on both paths.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace geo {

constexpr int Q_MAX = 8;      // query rects per pass (zero-padded)
constexpr int LANES = 128;    // toe prints per int8 amp-scale block
constexpr int TILE = 1024;    // toe prints per sweep tile

// stored-dtype codes shared with the Python wrappers
enum Kind : int { F32 = 0, F16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// amp[t] * Σ_j area(rect ∩ q_j) · q_amp_j accumulated in slot order — the
// Pallas kernels' arithmetic: acc + (w*h)*qa, then × amp.
__device__ __forceinline__ float score_rect(
    float x0, float y0, float x1, float y1, const float4* q, const float* qa) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < Q_MAX; ++j) {
    const float w = fmaxf(fminf(x1, q[j].z) - fmaxf(x0, q[j].x), 0.0f);
    const float h = fmaxf(fminf(y1, q[j].w) - fmaxf(y0, q[j].y), 0.0f);
    acc = acc + (w * h) * qa[j];
  }
  return acc;
}

// One slot's step of score_rect's sum, for a scorer that visits only the
// slots live_slot() keeps.
__device__ __forceinline__ float add_slot(
    float acc, float x0, float y0, float x1, float y1, float4 q, float qa) {
  const float w = fmaxf(fminf(x1, q.z) - fmaxf(x0, q.x), 0.0f);
  const float h = fmaxf(fminf(y1, q.w) - fmaxf(y0, q.y), 0.0f);
  return acc + (w * h) * qa;
}

// Whether query slot (q, qa) can change score_rect's sum.  A slot with
// qa == ±0 whose extent area A = fl(fl(q.z − q.x) · fl(q.w − q.y)) is
// finite adds exactly nothing, whatever the store rect (±inf included):
//  1. A finite means all four coordinates and both extents Dx, Dy are
//     finite (inf − finite and inf − inf are not).
//  2. fminf(x1, q.z) ≤ q.z and fmaxf(x0, q.x) ≥ q.x (fminf/fmaxf drop a
//     NaN store coordinate), so the real difference is at most q.z − q.x,
//     and rounding is monotone: 0 ≤ w ≤ max(Dx, 0), 0 ≤ h ≤ max(Dy, 0),
//     hence 0 ≤ fl(w·h) ≤ max(A, 0), finite.
//  3. finite × ±0 is ±0, so the slot adds ±0.
//  4. acc starts at +0 and is never −0 (x + y == 0 for nonzero x, y rounds
//     to +0, and +0 + −0 == +0), so acc + ±0 == acc bit for bit — a NaN
//     or inf acc included.
// A zero-amp slot whose area overflows stays live: w·h may be inf and
// (w·h)·0 NaN, as in the all-slot sum.
__device__ __forceinline__ bool live_slot(float4 q, float qa) {
  return qa != 0.0f || !isfinite((q.z - q.x) * (q.w - q.y));
}

}  // namespace geo
