// Per-toe-print geographic scores on Hopper.
//
// Replaces repro/kernels/geo_score/kernel.py::geo_score_planar (Pallas TPU):
//     out[t] = amp[t] * Σ_j area(rect[t] ∩ q_j) · q_amp_j,   j < Q_MAX
// with an explicit batch axis: toe print t belongs to query t / n_per_row.
//
// Bound: bytes.  Each toe print reads 20 B (a float4 rect + an amp) and
// writes 4 B for ~90 flops over the 8 query slots, far below the H100's
// flop/byte ridge.  Design: one thread per toe print; the packed [T, 4]
// rect layout gives every thread one 16-byte load, neighbours on neighbouring
// addresses (the TPU's planar [rows, 128] layout existed for its vector
// lanes and is not needed here).  The query's 8 rects are read through the
// read-only cache; a warp's threads share one query, so the reads broadcast.
#include "common.cuh"

namespace geo {

__global__ void __launch_bounds__(256) geo_score_kernel(
    const float4* __restrict__ rects,   // [N] packed (x0, y0, x1, y1)
    const float* __restrict__ amps,     // [N]
    const float4* __restrict__ q_rects, // [B, Q_MAX]
    const float* __restrict__ q_amps,   // [B, Q_MAX]
    float* __restrict__ out,            // [N]
    int64_t n_per_row, int64_t total) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t b = t / n_per_row;
  const float4 v = rects[t];
  out[t] = score_rect(v.x, v.y, v.z, v.w, q_rects + b * Q_MAX, q_amps + b * Q_MAX)
      * amps[t];
}

}  // namespace geo

extern "C" int geo_score_launch(
    const void* rects, const void* amps, const void* q_rects, const void* q_amps,
    void* out, long long n_per_row, long long total, void* stream) {
  if (total <= 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  geo::geo_score_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rects), static_cast<const float*>(amps),
      static_cast<const float4*>(q_rects), static_cast<const float*>(q_amps),
      static_cast<float*>(out), n_per_row, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
