// Fused K-SWEEP fetch + geo scoring on Hopper, plain and block-max pruned.
//
// sweep_score_kernel replaces repro/kernels/sweep_score/kernel.py::
// sweep_score_planar: the score of every position of every window, where
// sweep i of query b reads the toe-print store from the TILE-aligned window
// origin block_starts[b, i] (a device i32 tensor, read by the kernel where
// the TPU scalar-prefetched it), decoding the stored dtype: astype f32, then
// × the int8 store's per-128-row amp scale.  The store is read where the
// index keeps it — packed [T, 4] rects and a [T] amp column — so no
// per-batch planar copy exists; the TPU's planar [rows, 128] layout served
// its vector lanes.  Positions past the store's end score 0.
//
// What bounds the scorer on the card is bytes: 4 per window position
// written, and the store rows the windows cover.  A batch's windows overlap
// (32 queries sweep one Morton-ordered store): at the main path's shapes
// they request each row ~13.5 times, and the f32 store (52 MB) is larger
// than L2, so a thread per window position re-read ~676 MB from HBM for
// ~50 MB of distinct rows.  So the scorer is store-tile-major: a CTA owns
// one store tile (TILE rows — the windows' own alignment, so a window
// covers a whole tile or none of it), loads and decodes its rows once into
// registers, finds the windows that cover the tile from the B·k origins
// (a ballot per 256 windows), and scores the tile for each of them, 4 KB
// of contiguous output per window.  Positions past the store's last tile
// belong to no store tile, and one CTA per window writes their zeros.
// Each query sums only its live slots (live_slot in common.cuh: the slots
// that pad a query to Q_MAX add exactly nothing), in slot order, so the
// scores stay bitwise those of the all-slot sum; a CTA works out each
// query's live slots once, in its prologue.  The main path's queries have 1-2 live slots of 8, and
// a thread-per-position scorer spent its time on the other 6-7 more than
// on re-reading the store (PERF.md's sweep_score diagnosis); with both
// fixed, the output writes are what is left.
//
// The pruned sweep replaces sweep_score_pruned_planar.  What bounds it is
// the θ buffer: each tile's skip decisions read θ = min of a cyclic
// cb·1024-float partial top-C buffer that every earlier tile of the query
// may have raised, so a query's (sweep, tile) lattice is walked in order,
// and the walk is a chain of dependent steps, not bytes or operations.
// Walking it in one CTA that also loads and scores each tile left 100 of 132
// SMs idle at a batch of 32 and put a global load, a score and two barriers
// on the chain of every tile.  Here one wrapper call makes two launches,
// with no signalling between CTAs:
//   1. the gated score pass: sweep_score_kernel<GATED>, the unpruned
//      scorer.  A metadata block whose bound does not beat the select floor
//      is not scored and writes 0: θ is seeded with the floor and only ever
//      raised, so the walk skips it whatever θ does.  Every other block
//      writes the unpruned scores.
//   2. the θ walk (sweep_walk_kernel): one CTA per query over scores that
//      already exist; its design is written above the kernel.  Only tiles
//      in which a block beats θ cost a step: one barrier, two when θ moves.
// The only extra work is the blocks with floor < bound ≤ θ: scored in pass 1
// and zeroed in pass 2.  A step of the walk is a chain of dependent
// shared-memory round trips and barriers, each far dearer on the card than
// the step's arithmetic, so the walk keeps its per-step state in registers.
#include "common.cuh"

namespace geo {

constexpr int RING = 16;  // tiles of pass-1 scores in the θ walk's ring

__device__ __forceinline__ float4 load_rect(const float* rects, int64_t p) {
  return __ldg(reinterpret_cast<const float4*>(rects) + p);
}

__device__ __forceinline__ float4 load_rect(const __half* rects, int64_t p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(rects) + p);
  const __half2 lo = *reinterpret_cast<const __half2*>(&u.x);
  const __half2 hi = *reinterpret_cast<const __half2*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

constexpr int SCORE_THREADS = 256;
constexpr int SCORE_WARPS = SCORE_THREADS / 32;
constexpr int ROWS = TILE / SCORE_THREADS;  // consecutive store rows per thread
static_assert(ROWS == 4, "a thread's rows are written as one float4");

// One CTA per store tile, then one per window for the window's positions
// past the store's last tile; dynamic shared memory holds a byte per query.
// GATED (the pruned sweep's pass 1): a metadata block whose bound ub does
// not beat the floor is never scored by the walk, so it is written as 0
// unscored.
template <typename CT, typename AT, bool GATED>
__global__ void __launch_bounds__(SCORE_THREADS) sweep_score_kernel(
    const int* __restrict__ block_starts,  // [B·k] window origins, TILE units (≥ 0)
    const float4* __restrict__ q_rects,    // [B, Q_MAX]
    const float* __restrict__ q_amps,      // [B, Q_MAX]
    const CT* __restrict__ rects,          // [T, 4] packed (x0, y0, x1, y1)
    const AT* __restrict__ amp,            // [T]
    const float* __restrict__ scale,       // [ceil(T / LANES)] or null
    float* __restrict__ out,               // [B·k, n_tiles·TILE]
    int n_windows, int k, int n_tiles, int64_t T, int n_store_tiles,
    const float* __restrict__ ub,          // GATED: [B·k, n_tiles·bpt]
    const float* __restrict__ floor_,      // GATED: [B]
    int bpt) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t = blockIdx.x;
  const int64_t wlen = static_cast<int64_t>(n_tiles) * TILE;
  if (t >= n_store_tiles) {  // window w's tiles past the store: zeros
    const int w = t - n_store_tiles;
    const int64_t past = n_store_tiles - static_cast<int64_t>(block_starts[w]);
    const int64_t j0 = past < 0 ? 0 : past > n_tiles ? n_tiles : past;
    float4* dst = reinterpret_cast<float4*>(out + w * wlen);
    for (int64_t x = j0 * (TILE / 4) + tid; x < wlen / 4; x += SCORE_THREADS)
      dst[x] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  // each query's live slots (bit j: slot j), one thread per (query, slot)
  extern __shared__ unsigned char live_bits[];  // [n_windows / k]
  static_assert(32 % Q_MAX == 0, "a warp holds whole queries");
  const int n_slots = n_windows / k * Q_MAX;
  for (int s0 = 0; s0 < n_slots; s0 += SCORE_THREADS) {
    const int x = s0 + tid;
    const bool lv = x < n_slots && live_slot(q_rects[x], q_amps[x]);
    const uint32_t m = __ballot_sync(0xffffffffu, lv);
    if (x < n_slots && x % Q_MAX == 0)
      live_bits[x / Q_MAX] = static_cast<unsigned char>(m >> (lane / Q_MAX * Q_MAX));
  }
  __syncthreads();
  // the tile's rows, decoded once: this thread's ROWS neighbours
  float x0[ROWS], y0[ROWS], x1[ROWS], y1[ROWS], a[ROWS];
  bool in[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t p = static_cast<int64_t>(t) * TILE + tid * ROWS + r;
    in[r] = p < T;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float av = 0.0f;
    if (in[r]) {
      av = to_f32(amp[p]);
      if (scale != nullptr) av = av * scale[p / LANES];
      c = load_rect(rects, p);
    }
    x0[r] = c.x, y0[r] = c.y, x1[r] = c.z, y1[r] = c.w, a[r] = av;
  }
  // the covering windows of each 256-window chunk, compacted: output
  // offset, query, live slots (bits 0-7) and, GATED, the tile's blocks
  // that beat the floor (bits 8-15)
  __shared__ int64_t e_dst[SCORE_THREADS];
  __shared__ int e_b[SCORE_THREADS];
  __shared__ uint32_t e_bits[SCORE_THREADS];
  __shared__ int warp_n[SCORE_WARPS];
  const int my_blk = GATED ? tid * ROWS / (TILE / bpt) : 0;  // a warp's rows lie in one block
  for (int c0 = 0; c0 < n_windows; c0 += SCORE_THREADS) {
    const int w = c0 + tid;
    int64_t o = 0;
    bool cov = false;
    if (w < n_windows) {
      o = block_starts[w];
      cov = o <= t && t < o + n_tiles;
    }
    const uint32_t m = __ballot_sync(0xffffffffu, cov);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int n = 0, before = 0;
#pragma unroll
    for (int q = 0; q < SCORE_WARPS; ++q) {
      const int c = warp_n[q];
      before += q < warp ? c : 0;
      n += c;
    }
    if (cov) {
      const int e = before + __popc(m & ((1u << lane) - 1u));
      const int b = w / k;
      uint32_t bits = live_bits[b];
      if (GATED) {
        const float* u = ub + w * static_cast<int64_t>(n_tiles) * bpt + (t - o) * bpt;
        const float fl = floor_[b];
        for (int q = 0; q < bpt; ++q)
          if (u[q] > fl) bits |= 1u << (8 + q);
      }
      e_dst[e] = w * wlen + (t - o) * TILE;
      e_b[e] = b;
      e_bits[e] = bits;
    }
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      const uint32_t bits = e_bits[e];
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (!GATED || ((bits >> (8 + my_blk)) & 1u)) {
        const float4* q = q_rects + e_b[e] * Q_MAX;
        const float* qa = q_amps + e_b[e] * Q_MAX;
        float acc[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
        for (uint32_t lm = bits & 0xffu; lm; lm &= lm - 1u) {
          const int j = __ffs(lm) - 1;
          const float4 qj = q[j];
          const float qaj = qa[j];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r] = add_slot(acc[r], x0[r], y0[r], x1[r], y1[r], qj, qaj);
        }
        v = make_float4(in[0] ? acc[0] * a[0] : 0.0f, in[1] ? acc[1] * a[1] : 0.0f,
                        in[2] ? acc[2] * a[2] : 0.0f, in[3] ? acc[3] * a[3] : 0.0f);
      }
      reinterpret_cast<float4*>(out + e_dst[e])[tid] = v;
    }
    __syncthreads();  // the chunk's entries are read before the next overwrites them
  }
}

// The scorer's launch: one CTA per store tile, then one per window for its
// positions past the store.
template <typename CT, typename AT, bool GATED>
int score(const void* const* p, float* out, int B, int k, int n_tiles, int64_t T,
          const float* ub, const float* floor_, int bpt, cudaStream_t st) {
  const int64_t n_store_tiles = (T + TILE - 1) / TILE;
  const int n_windows = B * k;
  const int64_t grid = n_store_tiles + n_windows;
  // the live-slot bytes beside the ~4 KB of static shared memory
  if (grid > 0x7fffffff || B > 32 * 1024)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  sweep_score_kernel<CT, AT, GATED><<<static_cast<unsigned>(grid), SCORE_THREADS, B, st>>>(
      static_cast<const int*>(p[0]), static_cast<const float4*>(p[1]),
      static_cast<const float*>(p[2]), static_cast<const CT*>(p[3]),
      static_cast<const AT*>(p[4]), static_cast<const float*>(p[5]), out, n_windows, k,
      n_tiles, T, static_cast<int>(n_store_tiles), ub, floor_, bpt);
  return static_cast<int>(cudaGetLastError());
}

// ---- the θ walk: a ring of pass-1 scores in shared memory ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// buffer values are ≥ 0, so their f32 bit patterns order as unsigned
// integers once −0 is folded onto +0 (a negative amplitude with zero
// overlap scores −0)
__device__ __forceinline__ uint32_t order_bits(float v) {
  return v == 0.0f ? 0u : __float_as_uint(v);
}

__device__ __forceinline__ float4 fmax4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

__device__ __forceinline__ float4 fmin4(float4 a, float4 b) {
  return make_float4(fminf(a.x, b.x), fminf(a.y, b.y), fminf(a.z, b.z), fminf(a.w, b.w));
}

// The walk's CTA: WALK_WARPS warps walk the lattice, each thread owning
// COLS neighbouring columns of every tile (its slice of the θ buffer and of
// each ring slot, read and written as one float4); one more warp keeps the
// ring full, GROUP tiles per bulk copy.  Between two tiles that fold, θ is
// constant, so the walkers find the next one with a ballot over the
// per-tile largest bounds, 32 tiles at a time; what a fold needs of its
// tile (candidate columns, buffer slot) is computed for every tile up
// front; the skip flags and the zeroing of skipped blocks wait for an
// epilogue in which every walker works on its own blocks.  (One column per
// thread, a copy per tile and a step per tile left the walk bound by
// instruction issue and by the producer's serial issue of copies.)
constexpr int WALK_WARPS = 8;
constexpr int WALK_THREADS = WALK_WARPS * 32;
constexpr int COLS = TILE / WALK_THREADS;
constexpr int GROUP = 4;                 // tiles per bulk copy
constexpr int N_GROUPS = RING / GROUP;   // copies in flight

// A walker's COLS columns of every θ-buffer slot: in registers when the
// buffer has at most 4 slots (CB, the main path's 2 among them), else in
// shared memory (CB = 0, slot q at s[q · TILE / COLS]).
template <int CB>
struct Columns {
  float4 r[CB > 0 ? CB : 1];
  float4* s;
  int cb;
  __device__ __forceinline__ Columns(float4* s_, int cb_, float fl) : s(s_), cb(cb_) {
#pragma unroll
    for (int q = 0; q < (CB > 0 ? CB : 1); ++q) r[q] = make_float4(fl, fl, fl, fl);
  }
  // slot `slot`'s values, and the minimum over the other slots
  __device__ __forceinline__ void read(int slot, float4& cur, float4& others) const {
    others = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    if constexpr (CB > 0) {
#pragma unroll
      for (int q = 0; q < CB; ++q) {
        if (q == slot) cur = r[q];
        else others = fmin4(others, r[q]);
      }
    } else {
      for (int q = 0; q < cb; ++q) {
        const float4 v = s[q * (TILE / COLS)];
        if (q == slot) cur = v;
        else others = fmin4(others, v);
      }
    }
  }
  __device__ __forceinline__ void write(int slot, float4 v) {
    if constexpr (CB > 0) {
#pragma unroll
      for (int q = 0; q < CB; ++q)
        if (q == slot) r[q] = v;
    } else {
      s[slot * (TILE / COLS)] = v;
    }
  }
};

template <int CB>
__global__ void __launch_bounds__(WALK_THREADS + 32, 1) sweep_walk_kernel(
    const int* __restrict__ block_starts,  // [B, k] window origins, TILE units
    const int* __restrict__ bounds,        // [B, k, 2] exact [start, end)
    const float* __restrict__ floor_,      // [B] select floor (≥ 0)
    const float* __restrict__ ub,          // [B, k, n_tiles * bpt] block bounds
    float* __restrict__ out,               // [B, k, n_tiles * TILE] pass-1 scores
    int* __restrict__ scored,              // [B, k, n_tiles * bpt]
    int k, int n_tiles, int cb, int bpt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_all = k * n_tiles, n_ub = n_all * bpt;
  float* ring = reinterpret_cast<float*>(smem);  // [RING, TILE]
  float* buf = ring + RING * TILE;               // [cb, TILE] θ buffer
  float* sub = buf + cb * TILE;                  // [n_all, bpt] block bounds
  float* tmax = sub + n_ub;                      // [n_all] largest bound per tile
  // [n_all] per tile: its [start, end) candidate columns (11 bits each) and
  // its buffer slot t % cb (10 bits)
  uint32_t* tinfo = reinterpret_cast<uint32_t*>(tmax + n_all);
  int64_t* rel = reinterpret_cast<int64_t*>(     // [k, 2] [start, end) in the window
      sub + (n_ub + 2 * n_all + 1) / 2 * 2);
  unsigned char* flag = reinterpret_cast<unsigned char*>(rel + 2 * k);  // [n_ub]
  __shared__ uint64_t bar[N_GROUPS];
  __shared__ volatile int armed[N_GROUPS];  // group each barrier was last armed with
  __shared__ volatile int progress;         // tiles the walkers are done reading
  __shared__ uint32_t warp_mins[2][WALK_WARPS];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const float fl = floor_[b];
  const float* ub_b = ub + static_cast<int64_t>(b) * n_ub;
  float* out_b = out + static_cast<int64_t>(b) * n_all * TILE;
  // stage the query's bounds and window offsets; seed the buffer with the
  // floor: θ never drops below it
  for (int x = tid; x < n_ub; x += blockDim.x) {
    sub[x] = ub_b[x];
    flag[x] = 0;
  }
  if (tid < k) {
    const int64_t base = static_cast<int64_t>(block_starts[b * k + tid]) * TILE;
    rel[2 * tid] = bounds[(b * k + tid) * 2] - base;
    rel[2 * tid + 1] = bounds[(b * k + tid) * 2 + 1] - base;
  }
  for (int x = tid; x < cb * TILE; x += blockDim.x) buf[x] = fl;
  if (tid < N_GROUPS) armed[tid] = -1;
  if (tid == 0) {
    progress = 0;
    for (int g = 0; g < N_GROUPS; ++g)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[g])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // a tile folds iff its largest bound beats θ (fmaxf drops a NaN bound,
  // which beats nothing)
  for (int t = tid; t < n_all; t += blockDim.x) {
    float m = sub[t * bpt];
    for (int q = 1; q < bpt; ++q) m = fmaxf(m, sub[t * bpt + q]);
    tmax[t] = m;
    const int i = t / n_tiles;
    const int64_t base = static_cast<int64_t>(t - i * n_tiles) * TILE;
    auto clip = [](int64_t x) { return static_cast<uint32_t>(x < 0 ? 0 : x > TILE ? TILE : x); };
    tinfo[t] = clip(rel[2 * i] - base) | clip(rel[2 * i + 1] - base) << 11 |
               static_cast<uint32_t>(t % cb) << 22;
  }
  __syncthreads();
  const int bs = TILE / bpt;

  if (warp == WALK_WARPS) {
    // producer: copy group g's live blocks (bound above the floor: the
    // only ones the walk can score; the span from the first to the last)
    // into its GROUP ring slots, once the walkers are done with the group
    // those slots held and its copy has landed — so a walker that sees
    // armed[g % N_GROUPS] == g waits on group g's own phase
    if (lane == 0) {
      const int n_groups = (n_all + GROUP - 1) / GROUP;
      for (int g = 0, gb = 0; g < n_groups; ++g, gb = gb + 1 == N_GROUPS ? 0 : gb + 1) {
        if (g >= N_GROUPS) {
          while (progress < (g - N_GROUPS + 1) * GROUP) __nanosleep(64);
          mbar_wait(&bar[gb], ((g - N_GROUPS) / N_GROUPS) & 1);
        }
        const int x0 = g * GROUP * bpt, x1 = min(g * GROUP + GROUP, n_all) * bpt;
        int first = -1, last = -1;
        for (int x = x0; x < x1; ++x)
          if (sub[x] > fl) {
            if (first < 0) first = x;
            last = x;
          }
        const uint32_t bytes = first < 0 ? 0 : (last - first + 1) * bs * 4;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     ::"r"(smem_addr(&bar[gb])), "r"(bytes) : "memory");
        if (bytes)  // block x of the query sits at x·bs in out and in the ring
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
              "[%0], [%1], %2, [%3];"
              ::"r"(smem_addr(ring + (gb * GROUP * bpt + first - x0) * bs)),
                "l"(out_b + static_cast<int64_t>(first) * bs), "r"(bytes),
                "r"(smem_addr(&bar[gb])) : "memory");
        armed[gb] = g;
      }
      // no bulk copy may outlive the CTA's shared memory
      for (int g = max(0, n_groups - N_GROUPS); g < n_groups; ++g)
        mbar_wait(&bar[g % N_GROUPS], (g / N_GROUPS) & 1);
    }
    return;
  }

  // walkers: the tiles that fold, in order.  Each warp holds 32 tiles at
  // a time in registers — lane l the largest bound of tile wb + l, the
  // bound of the warp's own block in it (a warp's columns lie in one block)
  // and its info word — with the next 32 loaded ahead; a ballot against θ
  // gives the tiles that fold and the ones in which the warp's block is
  // scored, and θ only changes after a fold.
  const int c0 = tid * COLS;
  const int my_blk = c0 / bs;
  const bool leader = c0 % bs == 0;
  Columns<CB> cols(reinterpret_cast<float4*>(buf + c0), cb, fl);
  auto tile_max = [&](int x) { return x < n_all ? tmax[x] : -INFINITY; };
  auto blk_ub = [&](int x) { return x < n_all ? sub[x * bpt + my_blk] : -INFINITY; };
  auto info_at = [&](int x) { return x < n_all ? tinfo[x] : 0u; };
  float theta = fl;
  int wb = 0;
  float tw = tile_max(lane), uw = blk_ub(lane);
  uint32_t iw = info_at(lane);
  float tw_next = tile_max(32 + lane), uw_next = blk_ub(32 + lane);
  uint32_t iw_next = info_at(32 + lane);
  uint32_t fold_mask = __ballot_sync(0xffffffffu, tw > theta);
  uint32_t blk_mask = __ballot_sync(0xffffffffu, uw > theta);
  int par = 0, ready = -1;  // ready: the last ring group seen to have landed
  for (int t = -1;;) {
    const int sh = t + 1 - wb;
    uint32_t cand = sh >= 32 ? 0u : fold_mask >> sh << sh;
    while (!cand && wb + 32 < n_all) {
      wb += 32;
      tw = tw_next;
      uw = uw_next;
      iw = iw_next;
      tw_next = tile_max(wb + 32 + lane);
      uw_next = blk_ub(wb + 32 + lane);
      iw_next = info_at(wb + 32 + lane);
      fold_mask = __ballot_sync(0xffffffffu, tw > theta);
      blk_mask = __ballot_sync(0xffffffffu, uw > theta);
      cand = fold_mask;
    }
    if (!cand) break;
    t = wb + __ffs(cand) - 1;
    if (tid == 0) progress = t;  // ring slots of earlier tiles are free
    const uint32_t info = __shfl_sync(0xffffffffu, iw, t - wb);
    const int slot = info >> 22;
    float4 cur, m;
    cols.read(slot, cur, m);
    if ((blk_mask >> (t - wb)) & 1) {
      if (leader) flag[t * bpt + my_blk] = 1;
      const int g = t / GROUP;
      if (g != ready) {
        const int gb = g % N_GROUPS;
        while (armed[gb] != g) {
        }
        mbar_wait(&bar[gb], (g / N_GROUPS) & 1);
        ready = g;
      }
      const float4 v = *reinterpret_cast<const float4*>(ring + (t % RING) * TILE + c0);
      // only genuine [start, end) candidates feed the θ buffer
      const int lo = info & 0x7ff, hi = (info >> 11) & 0x7ff;
      cur = fmax4(cur, make_float4(
          c0 >= lo && c0 < hi ? v.x : 0.0f, c0 + 1 >= lo && c0 + 1 < hi ? v.y : 0.0f,
          c0 + 2 >= lo && c0 + 2 < hi ? v.z : 0.0f, c0 + 3 >= lo && c0 + 3 < hi ? v.w : 0.0f));
      cols.write(slot, cur);
    }
    // θ for the next decisions.  Buffer entries only rise, so θ stays put
    // while any entry still equals it: one barrier that ORs that across the
    // walkers.  Only when none does is θ the new minimum, taken with a
    // second barrier.
    m = fmin4(m, cur);
    const float mine = fminf(fminf(m.x, m.y), fminf(m.z, m.w));
    uint32_t held;
    asm volatile(
        "{\n.reg .pred p, q;\nsetp.eq.f32 p, %1, %2;\n"
        "bar.red.or.pred q, 1, %3, p;\nselp.u32 %0, 1, 0, q;\n}\n"
        : "=r"(held) : "f"(mine), "f"(theta), "n"(WALK_THREADS) : "memory");
    if (!held) {
      const uint32_t mb = min(min(order_bits(m.x), order_bits(m.y)),
                              min(order_bits(m.z), order_bits(m.w)));
      const uint32_t wm = __reduce_min_sync(0xffffffffu, mb);
      if (lane == 0) warp_mins[par][warp] = wm;
      asm volatile("bar.sync 2, %0;" ::"n"(WALK_THREADS) : "memory");
      theta = __uint_as_float(__reduce_min_sync(
          0xffffffffu, lane < WALK_WARPS ? warp_mins[par][lane] : 0xffffffffu));
      par ^= 1;
      fold_mask = __ballot_sync(0xffffffffu, tw > theta);
      blk_mask = __ballot_sync(0xffffffffu, uw > theta);
    }
  }
  if (tid == 0) progress = n_all;
  asm volatile("bar.sync 2, %0;" ::"n"(WALK_THREADS) : "memory");
  // epilogue: every block's flag; a block the floor let through but θ
  // skipped was scored by pass 1 and is zeroed
  int* scored_b = scored + static_cast<int64_t>(b) * n_ub;
  for (int x = tid; x < n_ub; x += WALK_THREADS) {
    const int f = flag[x];
    scored_b[x] = f;
    if (!f && sub[x] > fl) {
      float4* o = reinterpret_cast<float4*>(out_b + static_cast<int64_t>(x) * bs);
      for (int c = 0; c < bs / 4; ++c) o[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// dynamic shared memory of the walk: the ring, the θ buffer, the bounds,
// per-tile maxima and per-tile info (padded to 8 bytes), the [start, end)
// offsets and the flags; kernel.py mirrors it
size_t walk_smem_bytes(int k, int n_tiles, int cb, int bpt) {
  const int n_all = k * n_tiles;
  return static_cast<size_t>(RING + cb) * TILE * sizeof(float) +
         static_cast<size_t>((n_all * (bpt + 2) + 1) / 2 * 2) * sizeof(float) +
         static_cast<size_t>(k) * 2 * sizeof(int64_t) + static_cast<size_t>(n_all) * bpt;
}

// Plain: p = block_starts, q_rects, q_amps, rects, amp, scale, out
template <typename CT, typename AT>
struct Plain {
  static int run(const void* const* p, int B, int k, int pad_budget, int64_t T,
                 cudaStream_t st) {
    return score<CT, AT, false>(p, static_cast<float*>(const_cast<void*>(p[6])), B, k,
                                pad_budget / TILE, T, nullptr, nullptr, 1, st);
  }
};

template <int CB>
int walk(const void* const* p, int B, int k, int n_tiles, int cb, int bpt, cudaStream_t st) {
  const size_t smem = walk_smem_bytes(k, n_tiles, cb, bpt);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_walk_kernel<CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sweep_walk_kernel<CB><<<B, WALK_THREADS + 32, smem, st>>>(
      static_cast<const int*>(p[0]), static_cast<const int*>(p[1]),
      static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
      static_cast<float*>(const_cast<void*>(p[9])),
      static_cast<int*>(const_cast<void*>(p[10])), k, n_tiles, cb, bpt);
  return static_cast<int>(cudaGetLastError());
}

// Pruned: p = block_starts, bounds, floor, ub, q_rects, q_amps, rects, amp,
// scale, out, scored.  passes: bit 0 the gated score pass, bit 1 the θ walk
// (3 on every call but the timing of one pass alone)
template <typename CT, typename AT>
struct Pruned {
  static int run(const void* const* p, int B, int k, int n_tiles, int cb, int bpt,
                 int64_t T, int passes, cudaStream_t st) {
    float* out = static_cast<float*>(const_cast<void*>(p[9]));
    if (passes & 1) {
      const void* q[] = {p[0], p[4], p[5], p[6], p[7], p[8]};
      const int err = score<CT, AT, true>(q, out, B, k, n_tiles, T,
                                          static_cast<const float*>(p[3]),
                                          static_cast<const float*>(p[2]), bpt, st);
      if (err) return err;
    }
    if (passes & 2) {
      switch (cb) {
        case 1: return walk<1>(p, B, k, n_tiles, cb, bpt, st);
        case 2: return walk<2>(p, B, k, n_tiles, cb, bpt, st);
        case 3: return walk<3>(p, B, k, n_tiles, cb, bpt, st);
        case 4: return walk<4>(p, B, k, n_tiles, cb, bpt, st);
        default: return walk<0>(p, B, k, n_tiles, cb, bpt, st);
      }
    }
    return 0;
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
    int amp_kind, int passes, void* stream) {
  if (B <= 0 || k <= 0 || n_tiles <= 0) return 0;
  const void* p[] = {block_starts, bounds, floor_, ub, q_rects, q_amps,
                     rects, amp, scale, out, scored};
  return geo::dispatch<geo::Pruned>(coord_kind, amp_kind, static_cast<const void* const*>(p),
                                    B, k, n_tiles, cb, bpt, static_cast<int64_t>(T),
                                    passes, static_cast<cudaStream_t>(stream));
}
