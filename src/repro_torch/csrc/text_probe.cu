// Block-max pruned TEXT-FIRST driver walk on Hopper.
//
// Replaces repro/kernels/text_probe/kernel.py::text_probe_pruned_planar (the
// Pallas TPU kernel _pruned_kernel and its slot_theta).  For query b the
// driver term owns blocks [b0, b0 + nb) of the CSR posting store, each at
// most 128 postings.  Tile t covers window blocks 8t .. 8t+7; per tile:
//   1. θ = the c_sel-th largest value of the cb·1024-float partial top-C
//      buffer, exactly, then max(θ, floor);
//   2. block w is scored iff ub[w] = w_text·blk_max_impact + rest_ub > θ
//      (and, under `monotone` — the impact layout's non-increasing bounds —
//      no earlier tile had a failing bound: the cut flag);
//   3. a scored block reads its impacts where the index keeps them,
//      impacts[blk_pos[b0 + w] + lane] for lane < len, and scores
//      opt = float(imp)·w_text + rest_ub as two rounded operations (the
//      sources build with -fmad=false); a skipped block issues no loads;
//   4. opt (0 where masked) is written out and folded by max into buffer
//      slot (t mod cb).
// The TPU kernel copied an [NB, 128] impact plane of the whole store per
// batch to feed its DMA engine; here the CSR column is read in place.
//
// Design.  θ carries state from tile to tile, so one CTA of 1024 threads
// walks one query's tiles in order (thread = one (block row, lane) of the
// 8×128 tile), as csrc/sweep_score.cu's pruned kernel does.  The buffer
// sits in shared memory and thread tid owns column tid of every slot, so
// the fold needs no barrier.  θ is exact: when c_sel equals the buffer size
// (the main path: max_candidates a multiple of 1024) it is the buffer's
// minimum, a two-level block reduction; otherwise a 4-pass 8-bit radix
// select over the buffer (every value is ≥ 0, so the f32 bit patterns order
// as unsigned integers), with a warp-parallel scan of each 256-bin
// histogram.  A query stops walking once it passes its driver's nb blocks
// or once the cut flag is set: no later block can be scored, so the
// zero-filled outputs are already right.
//
// Bound.  Bytes: the scored blocks' impact rows, the ub/lens inputs and the
// opt/scored outputs.  Operations: 2 f32 per scored position plus the
// select.  The kernel is far from either: one CTA per query keeps only as
// many SMs busy as the batch has queries (32 of the H100's 132 at a batch
// of 32), and each tile pays two barriers (twelve on the radix path).
#include "common.cuh"

namespace geo {

constexpr int ROWS = 8;  // posting blocks per tile; TILE = ROWS * LANES

__device__ __forceinline__ unsigned order_key(float v) {
  // buffer values are ≥ 0; -0.0 folds onto +0.0
  return v == 0.0f ? 0u : __float_as_uint(v);
}

__device__ __forceinline__ float warp_min_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename IT>
__global__ void __launch_bounds__(TILE) text_probe_kernel(
    const IT* __restrict__ impacts,      // [P] stored dtype, CSR order
    const int* __restrict__ blk_pos,     // [NB] CSR position of each block
    const int* __restrict__ b0_,         // [B] driver's first block
    const int* __restrict__ nb_,         // [B] driver's block count
    const float* __restrict__ ub,        // [B, n_win] per-block bounds
    const int* __restrict__ lens,        // [B, n_win] valid postings per block
    const float* __restrict__ rest_ub_,  // [B]
    const float* __restrict__ floor_,    // [B] select floor (≥ 0)
    float w_text,
    float* __restrict__ out,             // [B, n_tiles, ROWS, LANES], zeroed
    int* __restrict__ scored,            // [B, n_tiles, ROWS], zeroed
    int n_tiles, int cb, int c_sel, int monotone) {
  extern __shared__ float buf[];  // [cb, TILE], column tid owned by thread tid
  __shared__ float warp_red[TILE / 32];
  __shared__ unsigned hist[256];
  __shared__ unsigned sel_digit, sel_k;
  __shared__ float theta_s;
  __shared__ int cut_s, fail_s;
  const int tid = threadIdx.x, b = blockIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int row = tid / LANES, col = tid % LANES;
  const int n_win = n_tiles * ROWS;
  const float fl = floor_[b], rest = rest_ub_[b];
  const int b0 = b0_[b], nb = nb_[b];
  // seed every slot with the select floor: θ never drops below it
  for (int s = 0; s < cb; ++s) buf[s * TILE + tid] = fl;
  if (tid == 0) fail_s = 0;
  __syncthreads();
  for (int t = 0; t < n_tiles && t * ROWS < nb; ++t) {
    // ---- θ before this tile's decisions; warp 0 also latches the cut
    // flag that earlier tiles set (fail_s is written only after this
    // phase's last barrier, so the latch sees exactly tiles < t)
    float theta;
    if (c_sel == cb * TILE) {
      float m = buf[tid];
      for (int s = 1; s < cb; ++s) m = fminf(m, buf[s * TILE + tid]);
      m = warp_min_f(m);
      if (lane == 0) warp_red[warp] = m;
      __syncthreads();
      if (warp == 0) {
        const float v = warp_min_f(warp_red[lane]);
        if (lane == 0) {
          theta_s = v;
          cut_s = fail_s;
        }
      }
      __syncthreads();
      theta = theta_s;
    } else {
      unsigned prefix = 0u, mask = 0u, k = static_cast<unsigned>(c_sel);
      for (int pass = 0; pass < 4; ++pass) {
        const int shift = 24 - 8 * pass;
        if (tid < 256) hist[tid] = 0u;
        __syncthreads();
        for (int s = 0; s < cb; ++s) {
          const unsigned key = order_key(buf[s * TILE + tid]);
          if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
        }
        __syncthreads();
        if (warp == 0) {
          // lane l holds bins 8l .. 8l+7; suffix sums over lanes find the
          // bin where the k-th largest key falls
          unsigned local = 0u;
#pragma unroll
          for (int i = 0; i < 8; ++i) local += hist[lane * 8 + i];
          unsigned incl = local;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const unsigned n = __shfl_down_sync(0xffffffffu, incl, o);
            if (lane + o < 32) incl += n;
          }
          const unsigned above = incl - local;
          if (above < k && k <= incl) {
            unsigned cnt = above;
            for (int i = 7; i >= 0; --i) {
              const unsigned c = hist[lane * 8 + i];
              if (cnt + c >= k) {
                sel_digit = static_cast<unsigned>(lane * 8 + i);
                sel_k = k - cnt;
                break;
              }
              cnt += c;
            }
          }
          if (pass == 3 && lane == 0) cut_s = fail_s;
        }
        __syncthreads();
        prefix |= sel_digit << shift;
        mask |= 0xFFu << shift;
        k = sel_k;
      }
      theta = __uint_as_float(prefix);
    }
    theta = fmaxf(theta, fl);
    if (monotone && cut_s) break;  // uniform: every later block is cut
    // ---- decisions, loads, scores, fold
    const int w = t * ROWS + row;
    const int64_t wi = static_cast<int64_t>(b) * n_win + w;
    const bool sb = ub[wi] > theta;  // -inf past the driver's blocks
    const int64_t o = (static_cast<int64_t>(b) * n_tiles + t) * ROWS + row;
    if (col == 0) {
      scored[o] = sb ? 1 : 0;
      if (!sb) fail_s = 1;  // read only under monotone, from the next tile on
    }
    float sc = 0.0f;
    if (sb && col < lens[wi]) {  // a skipped block issues no loads
      sc = to_f32(impacts[static_cast<int64_t>(blk_pos[b0 + w]) + col]) * w_text + rest;
    }
    out[o * LANES + col] = sc;
    float* slot = buf + (t % cb) * TILE + tid;
    *slot = fmaxf(*slot, sc);
  }
}

template <typename IT>
int launch_text_probe(const void* const* p, float w_text, int B, int n_tiles, int cb,
                      int c_sel, int monotone, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(cb) * TILE * sizeof(float);
  auto kern = text_probe_kernel<IT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<B, TILE, smem, st>>>(
      static_cast<const IT*>(p[0]), static_cast<const int*>(p[1]),
      static_cast<const int*>(p[2]), static_cast<const int*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const int*>(p[5]),
      static_cast<const float*>(p[6]), static_cast<const float*>(p[7]), w_text,
      static_cast<float*>(const_cast<void*>(p[8])), static_cast<int*>(const_cast<void*>(p[9])),
      n_tiles, cb, c_sel, monotone);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace geo

extern "C" int text_probe_launch(
    const void* impacts, int imp_kind, const void* blk_pos, const void* b0,
    const void* nb, const void* ub, const void* lens, const void* rest_ub,
    const void* floor_, float w_text, void* out, void* scored,
    int B, int n_tiles, int cb, int c_sel, int monotone, void* stream) {
  if (B <= 0 || n_tiles <= 0) return 0;
  const void* p[] = {impacts, blk_pos, b0, nb, ub, lens, rest_ub, floor_, out, scored};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (imp_kind == geo::F32)
    return geo::launch_text_probe<float>(p, w_text, B, n_tiles, cb, c_sel, monotone, st);
  if (imp_kind == geo::F16)
    return geo::launch_text_probe<__half>(p, w_text, B, n_tiles, cb, c_sel, monotone, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
