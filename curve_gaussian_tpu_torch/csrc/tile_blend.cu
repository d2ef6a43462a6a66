// Tile blend for Hopper (sm_90a): the training forward and moment backward
// (K1, K2), the forward of every channel set (K3), the per-slot backward of
// every field (K4), the moment backward of the training channel set written
// per slot (K5, K2's kernel) or through a tile-local basis (K6b), and the
// fixed-order slot -> Gaussian reduction of every backward's slot rows.
// Plain C interface, loaded with ctypes by curve_gaussian_tpu_torch/ops/
// rasterize_cuda.py (K1, K2, K6b, the reduction) and tile_blend_cuda.py
// (K3, K4, K5).
//
// Replaces the Pallas kernels of curve_gaussian_tpu/ops/rasterize_pallas.py:
//   K1  _make_fwd_train_paired (and its unpaired odd-width form
//       _make_fwd_kernel(False, False, True)): front-to-back compositing of
//       the training channel set, here blend_train_fwd_kernel
//   K2  _make_bwd_moment_rmw_paired (and the unpaired
//       _make_bwd_moment_rmw_kernel): six moments per (Gaussian, tile)
//       reduced into a [P1, 8] accumulator, here blend_train_bwd_kernel<F>
//       into slot rows [T, K, 8], then slot_reduce_kernel
//   K3  _make_fwd_kernel(geo, invd, ones, indirect): compositing of the
//       colour channel (ones or a per-splat colour), the inverse depth and
//       the four allmap channels
//   K4  _make_bwd_kernel(geo, invd, ones, indirect): the gradient of every
//       field of every instance slot, written into a [T, K, NF] table
//   K5  _make_bwd_moment_kernel(indirect=True): K2's six moments per slot
//       into a [T, K, 8] table: K2's kernel, blend_train_bwd_kernel<F>
//   K6b _make_bwd_moment_rmw_basis_kernel (USE_BASIS_BWD): K2's six moments
//       through six raw tile-local sums of D' per slot and a binomial
//       recombination per (instance, tile), blend_train_bwd_kernel<T>
// The slot -> Gaussian reduction, which the JAX package leaves to an XLA
// scatter-add, is slot_reduce_kernel: it replaces no Pallas kernel.
// The TPU layout is not copied: no tile pairing, no (8,128) register tiles,
// no tiled outputs, no sub-group pipelining, no parking buffers or one-hot
// MXU combiners, no [T, K, NF] payload table (the fields are read through
// gather_idx).
//
// One layout.  Every blend kernel splits each 32x32 tile over four
// 256-thread blocks, one per 16x16 quarter, one pixel per thread, and each
// warp skips the staged instances whose support box misses its 8x4 pixel
// rectangle (the K1/K2 section says why; K3/K4 take the same helpers for
// every channel set <GEO, INVD, ONES>).  Instances come from
// gather_idx[tile, :counts[tile]] (depth order), fields are staged in
// shared memory from fields[P1, NF] through gather_idx, one row per
// thread, as float4 loads, and a block's loop ends at the first chunk
// boundary where all its pixels are done (__syncthreads_or).  The kernels
// are templated on the channel set or the moments' basis, so every loop
// over channels unrolls and every choice folds at compile time.
//
// What bounds them: one expf per evaluated (instance, pixel) pair and each
// pixel's serial chain, so instruction latency and throughput, not bytes
// (a tile's fields are a few KB).
//
// Every sum is taken in a fixed order, so the same inputs give the same
// bits on every launch, as the TPU kernels' in-order grid does (the JAX
// backward accumulates into an output slab that its grid revisits in order
// on one core).  No float is added atomically.  A backward kernel sums a
// value of an instance over its pixels in three fixed steps: over a warp's
// 32 pixels by a shuffle tree (warp_sum), over the block's eight warps in
// warp order (Partials), and over the tile's four quarter blocks in quarter
// order, by the block that finishes last (last_quarter: each quarter
// writes its rows to a scratch, an integer ticket per tile elects the
// last).  slot_reduce_kernel then sums each Gaussian's slot rows in (tile,
// slot) order, read from the binning's table of its slots.
//
// Built with -fmad=false so that the arithmetic rounds like the plain
// PyTorch versions' separate elementwise operations; expf (not __expf).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int TILE = 32;

constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float ALPHA_MAX = 0.99f;

// The channel set: channel 0 is the colour, then [inverse depth], then
// [am0..am3].  Its fields follow the six geometry fields in channel order,
// the colour only when it is a per-splat colour (C0 = 0).
template <bool GEO, bool INVD, bool ONES>
struct Chan {
  static constexpr int NCH = 1 + (INVD ? 1 : 0) + (GEO ? 4 : 0);
  static constexpr int C0 = ONES ? 1 : 0;  // first channel with a field
  static constexpr int NFIELD = 6 + NCH - C0;
  static constexpr int NF = NFIELD <= 8 ? 8 : 16;
  static constexpr int NACC = NCH - C0 > 0 ? NCH - C0 : 1;  // array size
  // channel indices of the inverse depth and of am0 (functions, so that a
  // set without the channel never instantiates them)
  __host__ __device__ static constexpr int invd_ch() { return 1; }
  __host__ __device__ static constexpr int am_ch() { return INVD ? 2 : 1; }
};

__device__ __forceinline__ float power_of(float ca, float cb, float cc, float dx, float dy) {
  return -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
}

// ---------------------------------------------------------------------------
// K1, K2, K5 and K6b: the training channel set, culled per warp
// ---------------------------------------------------------------------------
//
// What bounded the first design on an H100 (one 256-thread block per 32x32
// tile, every staged instance evaluated at every live pixel; PERF.md): one
// block per tile put the longest lists (up to ~760 instances at the bench
// shape, three times the mean) on single SMs with too few warps to hide
// the latency of expf and of each pixel's serial chain, while 96% of the
// (instance, pixel) pairs it visited failed the alpha gate yet paid the
// power and expf.  The pairs' arithmetic stays as
// it was (power_of, expf, fminf(ALPHA_MAX, .), the two gates, the T test,
// K2's prefix identity and moments, -fmad=false); the design removes work
// that cannot contribute and spreads the rest:
//
// - A conservative box per staged instance (support_box, one thread per
//   instance): the axis-aligned box of its alpha >= 1/255 ellipse
//   (half-widths sqrt(2 t cc / det), sqrt(2 t ca / det), t = ln(255 op)),
//   grown so that no pair outside it can pass the gate in float32: det is
//   lowered by BOX_DET_SLACK times |ca cc| + cb^2, which covers its own
//   rounding and that of the power at a pixel (at most ~40 ulp of
//   ca dx^2 + cc dy^2 + 2 |cb dx dy|), t gains BOX_T_SLACK for the ulps of
//   logf and expf, and the half-widths grow by BOX_GROW and BOX_PX pixels.
//   op < 1/255 (less BOX_T_EMPTY) gives an empty box, a conic that is not
//   positive definite after the lowering or a box that is not finite the
//   whole plane.  A pair that fails the gate changes neither T, nor
//   liveness, nor any sum, so skipping it keeps every result exact: K1
//   stays bitwise equal to its plain version and to K3 at <F, F, T>.
//   rasterize_cuda.py::support_box is its float32 mirror.
// - Each warp owns a compact 8 x 4 pixel rectangle, one pixel per thread
//   (8 x 8 rectangles with two pixels per thread ran 13-16% slower on an
//   NVIDIA H100 80GB HBM3 at 700 W: PERF.md).
//   It tests 32 staged instances at a time, one per lane, against its
//   rectangle, and walks the ballot's set bits from low to high (__ffs),
//   which keeps the depth order of gather_idx.  A warp whose pixels are
//   all done skips the rest of the chunk; the block stops at the first
//   chunk boundary where all its pixels are done.
// - Four blocks share a tile's list, one per 16x16 quarter, each culling
//   against its own warps' rectangles: 1,024 blocks at 512^2, so a heavy
//   list is walked by four SMs with more warps each.  K1 needs no step
//   across blocks.  The moment backward reduces a visited instance's six
//   moments across the warp only when some lane contributed (9 shuffles:
//   the sums transpose across the lanes) and writes them into the warp's
//   shared row of the instance; at the end of a chunk one thread per
//   instance sums the rows of the warps that hit it in warp order, and the
//   tile's last quarter block sums the four quarters' rows in order.  Its
//   chunks stage 128 instances, not 256, so that the eight warps' rows of a
//   chunk fit in static shared memory beside the staged fields.
//
// What bounds them now: they evaluate 14% of the live pairs and run 4-6
// times faster than the first design, yet stay ~40 times above the bytes
// their inputs must move (PERF.md): the latency of each chunk's dependent
// loads on the longest lists and the serial chains of the pixels that
// remain, in shares not yet measured.

constexpr int CULL_SUB = 16;  // a block covers one 16x16 quarter of a tile
constexpr int CULL_NT = CULL_SUB * CULL_SUB;  // threads per block, one pixel each
constexpr int CULL_WW = 8;  // a warp's rectangle: CULL_WW columns, CULL_WH rows
constexpr int CULL_WH = 32 / CULL_WW;
constexpr int CULL_CHUNK = CULL_NT;  // instances staged per chunk, one per thread
constexpr int NWARP = CULL_NT / 32;
static_assert((CULL_SUB / CULL_WW) * (CULL_SUB / CULL_WH) * 32 == CULL_NT,
              "the warps' rectangles tile the quarter");

// Instances a backward kernel stages per chunk with NV values per instance:
// its warps' rows (Partials) take NWARP x chunk x NV floats of shared memory.
__host__ __device__ constexpr int bwd_chunk(int nv) { return nv <= 8 ? 128 : 64; }

constexpr float BOX_GROW = 1.001f;  // relative growth of the half-widths
constexpr float BOX_PX = 1.0f;      // and absolute, in pixels
constexpr float BOX_T_SLACK = 1e-5f;
constexpr float BOX_DET_SLACK = 4e-6f;
constexpr float BOX_T_EMPTY = 2e-5f;

// The box [x0, x1] x [y0, y1] (pixel coordinates) outside which no pixel
// passes the gate power <= 0, min(0.99, op e^power) >= 1/255.
__device__ __forceinline__ void support_box(float mx, float my, float ca, float cb, float cc,
                                            float op, float& x0, float& x1, float& y0,
                                            float& y1) {
  const float t = logf(255.0f * op);
  const float cacc = ca * cc;
  const float cb2 = cb * cb;
  const float dlo = (cacc - cb2) - BOX_DET_SLACK * (fabsf(cacc) + cb2);
  const float t2 = 2.0f * (fmaxf(t, 0.0f) + BOX_T_SLACK);
  const float hx = sqrtf(t2 * cc / dlo) * BOX_GROW + BOX_PX;
  const float hy = sqrtf(t2 * ca / dlo) * BOX_GROW + BOX_PX;
  x0 = mx - hx;
  x1 = mx + hx;
  y0 = my - hy;
  y1 = my + hy;
  if (t < -BOX_T_EMPTY) {
    x0 = y0 = INFINITY;
    x1 = y1 = -INFINITY;
  } else if (isnan(t) || !(dlo > 0.0f) || !(isfinite(x0) && isfinite(x1) && isfinite(y0) &&
                                             isfinite(y1))) {
    x0 = y0 = -INFINITY;
    x1 = y1 = INFINITY;
  }
}

// A chunk of CH entries of a tile's list in shared memory: the six fields
// and the box.
template <int CH = CULL_CHUNK>
struct Staged {
  static constexpr int N = CH;
  float mx[CH], my[CH], ca[CH], cb[CH], cc[CH], op[CH];
  float x0[CH], x1[CH], y0[CH], y1[CH];
};

// Stages list entry base + threadIdx.x when the thread is below the chunk
// and the entry below n, from field rows of NF floats; returns its Gaussian.
template <int NF = 8, int CH>
__device__ __forceinline__ int stage(Staged<CH>& s, const float* __restrict__ fields,
                                     const int* __restrict__ ids, int base, int n) {
  const int i = threadIdx.x;
  const int j = base + i;
  if (i >= CH || j >= n) return -1;
  const int id = ids[j];
  const float4* row = reinterpret_cast<const float4*>(fields) + (size_t)id * (NF / 4);
  const float4 a = row[0];
  const float4 b = row[1];
  s.mx[i] = a.x;
  s.my[i] = a.y;
  s.ca[i] = a.z;
  s.cb[i] = a.w;
  s.cc[i] = b.x;
  s.op[i] = b.y;
  support_box(a.x, a.y, a.z, a.w, b.x, b.y, s.x0[i], s.x1[i], s.y0[i], s.y1[i]);
  return id;
}

// The thread's pixel (gx, gy) and its warp's rectangle, in the quarter
// blockIdx.x % 4 of tile blockIdx.x / 4.
struct Pixels {
  int tile, gx, gy;
  float rx0, rx1, ry0, ry1;
};

__device__ __forceinline__ Pixels pixels_of(int ntx) {
  const int tile = blockIdx.x >> 2;
  const int q = blockIdx.x & 3;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wx =
      (tile % ntx) * TILE + (q & 1) * CULL_SUB + (warp % (CULL_SUB / CULL_WW)) * CULL_WW;
  const int wy =
      (tile / ntx) * TILE + (q >> 1) * CULL_SUB + (warp / (CULL_SUB / CULL_WW)) * CULL_WH;
  return Pixels{tile,      wx + lane % CULL_WW,          wy + lane / CULL_WW,
                (float)wx, (float)(wx + CULL_WW - 1),    (float)wy,
                (float)(wy + CULL_WH - 1)};
}

// Calls visit(i) for each staged instance i < cnt whose box meets the
// warp's rectangle, in list order, while some lane's pixel is live (visit
// updates act).
template <class S, class Visit>
__device__ __forceinline__ void walk(const S& s, int cnt, const Pixels& p, const bool& act,
                                     Visit visit) {
  const int lane = threadIdx.x & 31;
  for (int g = 0; g < cnt; g += 32) {
    if (!__any_sync(0xffffffffu, act)) return;
    const int i = g + lane;
    const bool meets = i < cnt && s.x0[i] <= p.rx1 && s.x1[i] >= p.rx0 && s.y0[i] <= p.ry1 &&
                       s.y1[i] >= p.ry0;
    for (unsigned m = __ballot_sync(0xffffffffu, meets); m != 0u; m &= m - 1u) {
      visit(g + __ffs(m) - 1);
    }
  }
}

// Sums v[0..5] over the warp: lane l < 24 returns the sum of v[l / 4].
// Each exchange halves the values a lane carries (9 shuffles, not 30).
__device__ __forceinline__ float warp_sum6(const float (&m)[6]) {
  const int lane = threadIdx.x & 31;
  float v[8] = {m[0], m[1], m[2], m[3], m[4], m[5], 0.0f, 0.0f};
#pragma unroll
  for (int half = 4, off = 16; half >= 1; half >>= 1, off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  return v[0];
}

// warp_sum<N> pads its N values to sum_pad(N) of them; lane l returns the
// sum of value l / (32 / sum_pad(N)), zero past N.
__host__ __device__ constexpr int sum_pad(int n) { return n <= 8 ? 8 : 16; }

// warp_sum6 for up to 16 values (K4: 6 to 12 gradients), 16 shuffles for
// twelve, not 60.  K2 keeps warp_sum6: through this template its compiled
// kernel is scheduled differently.
template <int N>
__device__ __forceinline__ float warp_sum(const float (&m)[N]) {
  static_assert(N <= 16, "at most 16 values");
  constexpr int NP = sum_pad(N);
  const int lane = threadIdx.x & 31;
  float v[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) v[i] = i < N ? m[i] : 0.0f;
#pragma unroll
  for (int half = NP / 2, off = 16; half >= 1; half >>= 1, off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (int off = 16 / NP; off >= 1; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return v[0];
}

__global__ void __launch_bounds__(CULL_NT)
blend_train_fwd_kernel(const float* __restrict__ fields, const int* __restrict__ gidx,
                       const int* __restrict__ counts, const float* __restrict__ bg,
                       float* __restrict__ col, float* __restrict__ finT, int H, int W, int ntx,
                       int K) {
  __shared__ Staged<> s;
  const Pixels p = pixels_of(ntx);
  const float px = (float)p.gx, py = (float)p.gy;
  float T = 1.0f;
  bool act = (p.gx < W) && (p.gy < H);

  const int n = counts[p.tile];
  const int* ids = gidx + (size_t)p.tile * K;
  for (int base = 0; base < n; base += CULL_CHUNK) {
    if (!__syncthreads_or(act)) break;  // also the barrier before restaging
    stage(s, fields, ids, base, n);
    __syncthreads();
    walk(s, min(CULL_CHUNK, n - base), p, act, [&](int i) {
      if (!act) return;
      const float dx = s.mx[i] - px;
      const float dy = s.my[i] - py;
      const float power = power_of(s.ca[i], s.cb[i], s.cc[i], dx, dy);
      const float alpha = fminf(ALPHA_MAX, s.op[i] * expf(power));
      if (power <= 0.0f && alpha >= ALPHA_EPS) {
        const float rem = T - alpha * T;
        if (rem >= T_EPS) {
          T = rem;
        } else {
          act = false;  // the instance that fails the T test is excluded
        }
      }
    });
  }

  if (p.gx < W && p.gy < H) {
    const size_t o = (size_t)p.gy * W + p.gx;
    col[o] = 1.0f - T * (1.0f - bg[0]);  // the conservation form of ones colour
    finT[o] = T;
  }
}

// The fixed-order sums of the backward kernels.  A value of an instance
// (one of NV per instance) is summed over a tile's pixels in three steps,
// each in an order that no scheduling changes:
// 1. over a warp's 32 pixels, by warp_sum6 / warp_sum (a shuffle tree);
// 2. over the block's eight warps: each warp that hit the instance writes
//    its sums into its own row of Partials, and at the end of the chunk one
//    thread per instance adds the rows of the warps that hit it in warp
//    order (end_chunk), into the quarter's column of a scratch
//    qrows[T, 4, NV, K] (slot-minor, so that a warp's stores and loads of
//    it are contiguous);
// 3. over the tile's four quarter blocks: the block that finishes last,
//    elected by an integer ticket per tile (last_quarter), adds the four
//    quarters' rows in quarter order and writes the slot's row.
// A quarter block that stops early writes zeros into its rows past the
// chunk where it stopped (zero_rest), so every row below counts[tile] of
// every quarter is written before the ticket.
template <int NV, int CH>
struct Partials {
  float v[NWARP][CH][NV];
  unsigned hit[CH];  // bit w: warp w wrote its row of the instance
};

// Before a chunk's walk (and its barrier): no warp has hit the instance yet.
template <int NV, int CH>
__device__ __forceinline__ void begin_chunk(Partials<NV, CH>& pt, int cnt) {
  if (threadIdx.x < cnt) pt.hit[threadIdx.x] = 0u;
}

// In a warp's visit of instance i: lane l holds the warp's sum of value
// l / spread (warp_sum's layout); the lanes l % spread == 0 write them.
template <int NV, int CH>
__device__ __forceinline__ void warp_row(Partials<NV, CH>& pt, int i, float r, int spread) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane % spread == 0 && lane / spread < NV) pt.v[warp][i][lane / spread] = r;
  if (lane == 0) atomicOr(&pt.hit[i], 1u << warp);  // an integer OR: any order gives the same bits
}

// After a chunk's walk and a barrier: one thread per staged instance sums
// the warps' rows in warp order into the quarter's row of the scratch.
template <int NV, int CH>
__device__ __forceinline__ void end_chunk(const Partials<NV, CH>& pt, float* __restrict__ qrows,
                                          int tile, int K, int base, int cnt) {
  const int i = threadIdx.x;
  if (i >= cnt) return;
  const unsigned h = pt.hit[i];
  float* q = qrows + ((size_t)tile * 4 + (blockIdx.x & 3)) * NV * K + base + i;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      if (h >> w & 1u) v = v + pt.v[w][i][c];
    }
    q[(size_t)c * K] = v;
  }
}

// Zeros in the quarter's rows of list entries [from, n), which the block
// did not reach.
template <int NV>
__device__ __forceinline__ void zero_rest(float* __restrict__ qrows, int tile, int K, int from,
                                          int n) {
  float* q = qrows + ((size_t)tile * 4 + (blockIdx.x & 3)) * NV * K;
  for (int j = from + threadIdx.x; j < n; j += CULL_NT) {
#pragma unroll
    for (int c = 0; c < NV; ++c) q[(size_t)c * K + j] = 0.0f;
  }
}

// Called by every thread of a quarter block once its rows are written:
// true in the tile's last block to get here, which then reads the other
// quarters' rows (their stores fenced before the ticket, its loads after).
// tickets[T] is zeroed by the caller.
__device__ __forceinline__ bool last_quarter(int* __restrict__ tickets, int tile) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(tickets + tile, 1) == 3;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// In the last quarter block: the sum of list entry j's NV values over the
// four quarters, in quarter order (loads through L2: other SMs wrote them).
template <int NV>
__device__ __forceinline__ void quarter_sum(const float* __restrict__ qrows, int tile, int K,
                                            int j, float (&v)[NV]) {
  const float* q = qrows + (size_t)tile * 4 * NV * K + j;
  const size_t quarter = (size_t)NV * K;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const float* qc = q + (size_t)c * K;
    v[c] = ((__ldcg(qc) + __ldcg(qc + quarter)) + __ldcg(qc + 2 * quarter)) +
           __ldcg(qc + 3 * quarter);
  }
}

// The moment backward of the training channel set: K2 and K5 (<false>) and
// K6b (<true>).  One front-to-back pass carries T and the prefix
// pr += gc w, which gives
// g_alpha = gc Ti + (base_inv + pr) / (1 - alpha), base_inv = -gtt finT - gc col,
// and D' = g_alpha G.  Each instance's six moments (D', D'wx, D'wy, D'wx^2,
// D'wx wy, D'wy^2) are summed over the tile's pixels in the fixed order
// above into the slot's row tile * K + j of rows[T, K, 8] (columns 6-7 and
// the rows past counts[tile] zero):
// - K2 and K5: wx, wy = dx, dy, K2's moments;
// - K6b: wx, wy = the pixel's tile-local coordinates x' = x - 32 tx,
//   y' = y - 32 ty (small integers, exact in float32, weights below
//   31^2 = 961), so the four quarters sum to the raw sums S0, Sx, Sy, Sxx,
//   Sxy, Syy, which the last quarter block recombines around the
//   instance's local centre (cx, cy) = mean - tile origin, since
//   dx = cx - x' and dy = cy - y':
//     M0 = S0, M1 = cx S0 - Sx, M2 = cy S0 - Sy,
//     M3 = cx (cx S0 - 2 Sx) + Sxx, M4 = cx cy S0 - cx Sy - cy Sx + Sxy,
//     M5 = cy (cy S0 - 2 Sy) + Syy.
//   The recombination cancels terms up to ~31^2 times its result in
//   float32, so it runs once per (instance, tile) on the whole tile's sums,
//   as the plain version does, and not per quarter block; in global
//   coordinates the weights would reach 511^2 and it would cancel the
//   gradient away.  The TPU kernel's lane basis and sublane combiner
//   matrices (two MXU dots) are layout: a thread here knows its pixel's
//   (x', y').
// qrows[T, 4, 6, K] is scratch, tickets[T] zeroed by the caller.
template <bool BASIS>
__global__ void __launch_bounds__(CULL_NT)
blend_train_bwd_kernel(const float* __restrict__ fields, const int* __restrict__ gidx,
                       const int* __restrict__ counts, const float* __restrict__ col,
                       const float* __restrict__ finT, const float* __restrict__ gc,
                       const float* __restrict__ gtt, float* __restrict__ qrows,
                       int* __restrict__ tickets, float* __restrict__ rows, int H, int W,
                       int ntx, int K) {
  constexpr int CH = bwd_chunk(6);
  __shared__ Staged<CH> s;
  __shared__ Partials<6, CH> pt;
  const Pixels p = pixels_of(ntx);
  const float px = (float)p.gx, py = (float)p.gy;
  const float lx = (float)(p.gx % TILE), ly = (float)(p.gy % TILE);  // BASIS: x', y'
  float T = 1.0f, pr = 0.0f, gcv = 0.0f, binv = 0.0f;
  bool act = (p.gx < W) && (p.gy < H);
  if (act) {
    const size_t o = (size_t)p.gy * W + p.gx;
    gcv = gc[o];
    binv = -gtt[o] * finT[o] - gc[o] * col[o];
  }

  const int n = counts[p.tile];
  const int* ids = gidx + (size_t)p.tile * K;
  int base = 0;
  for (; base < n; base += CH) {
    if (!__syncthreads_or(act)) break;  // also the barrier before restaging
    const int cnt = min(CH, n - base);
    stage(s, fields, ids, base, n);
    begin_chunk(pt, cnt);
    __syncthreads();
    walk(s, cnt, p, act, [&](int i) {
      const float dx = s.mx[i] - px;
      const float dy = s.my[i] - py;
      const float wx = BASIS ? lx : dx;
      const float wy = BASIS ? ly : dy;
      float m[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      bool hit = false;
      if (act) {
        const float power = power_of(s.ca[i], s.cb[i], s.cc[i], dx, dy);
        const float G = expf(power);
        const float alpha = fminf(ALPHA_MAX, s.op[i] * G);
        if (power <= 0.0f && alpha >= ALPHA_EPS) {
          const float aT = alpha * T;
          const float rem = T - aT;
          if (rem >= T_EPS) {
            const float Ti = T;
            T = rem;
            pr = pr + gcv * aT;  // gc times the inclusive prefix
            const float inv1a = 1.0f / (1.0f - alpha);
            const float gal = gcv * Ti + inv1a * (binv + pr);
            const float Dp = gal * G;
            const float e1 = Dp * wx;
            const float e2 = Dp * wy;
            m[0] = Dp;
            m[1] = e1;
            m[2] = e2;
            m[3] = e1 * wx;
            m[4] = e1 * wy;
            m[5] = e2 * wy;
            hit = true;
          } else {
            act = false;
          }
        }
      }
      if (__any_sync(0xffffffffu, hit)) warp_row(pt, i, warp_sum6(m), 4);
    });
    __syncthreads();
    end_chunk(pt, qrows, p.tile, K, base, cnt);
  }
  zero_rest<6>(qrows, p.tile, K, base, n);
  if (!last_quarter(tickets, p.tile)) return;

  const float tx0 = (float)((p.tile % ntx) * TILE), ty0 = (float)((p.tile / ntx) * TILE);
  for (int j = threadIdx.x; j < K; j += CULL_NT) {
    float M[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j < n) {
      quarter_sum(qrows, p.tile, K, j, M);
      if (BASIS) {
        const float S[6] = {M[0], M[1], M[2], M[3], M[4], M[5]};
        const int id = ids[j];
        const float cx = fields[8 * (size_t)id] - tx0;
        const float cy = fields[8 * (size_t)id + 1] - ty0;
        M[1] = cx * S[0] - S[1];
        M[2] = cy * S[0] - S[2];
        M[3] = cx * (cx * S[0] - 2.0f * S[1]) + S[3];
        M[4] = cx * cy * S[0] - cx * S[2] - cy * S[1] + S[4];
        M[5] = cy * (cy * S[0] - 2.0f * S[2]) + S[5];
      }
    }
    float4* row = reinterpret_cast<float4*>(rows) + 2 * ((size_t)p.tile * K + j);
    row[0] = make_float4(M[0], M[1], M[2], M[3]);
    row[1] = make_float4(M[4], M[5], 0.0f, 0.0f);
  }
}

// The slot -> Gaussian reduction of every backward's slot rows
// rows[T * K, NF] (K2, K5 and K6b's moments, K4's field gradients), one
// thread per Gaussian row of out[P1, NF]: Gaussian p < P adds the rows
// slots[r, p] >= 0 for r = 0, 1, ..., R - 1, which the binning lists in
// (tile, slot) order (a Gaussian holds at most one slot of a tile); rows
// P .. P1 - 1 are zeros.  It replaces the index_add_ (an XLA scatter-add in
// the JAX package) whose atomics add in no fixed order.  Bound by bytes:
// the slot rows, the table and out, each touched once, at a few adds per
// float; the rows a Gaussian reads are scattered, 32 or 64 bytes each.
constexpr int REDUCE_NT = 256;

template <int NF>
__global__ void __launch_bounds__(REDUCE_NT)
slot_reduce_kernel(const float* __restrict__ rows, const int* __restrict__ slots,
                   float* __restrict__ out, int R, int P, int P1) {
  const int g = blockIdx.x * REDUCE_NT + threadIdx.x;
  if (g >= P1) return;
  float acc[NF];
#pragma unroll
  for (int c = 0; c < NF; ++c) acc[c] = 0.0f;
  if (g < P) {
    for (int r = 0; r < R; ++r) {
      const int sl = slots[(size_t)r * P + g];
      if (sl < 0) continue;
      const float4* row = reinterpret_cast<const float4*>(rows) + (size_t)sl * (NF / 4);
#pragma unroll
      for (int k = 0; k < NF / 4; ++k) {
        const float4 a = row[k];
        acc[4 * k] = acc[4 * k] + a.x;
        acc[4 * k + 1] = acc[4 * k + 1] + a.y;
        acc[4 * k + 2] = acc[4 * k + 2] + a.z;
        acc[4 * k + 3] = acc[4 * k + 3] + a.w;
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(out) + (size_t)g * (NF / 4);
#pragma unroll
  for (int k = 0; k < NF / 4; ++k) {
    o[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  }
}

// ---------------------------------------------------------------------------
// K3 and K4: every channel set, culled per warp
// ---------------------------------------------------------------------------
//
// K1's and K2's layout and helpers for every channel set <GEO, INVD, ONES>:
// four blocks per tile, one pixel per thread, each warp walking the staged
// instances whose support box meets its 8 x 4 rectangle.  The box depends
// only on the six geometry fields, so it is the same for every set; the
// channel fields (columns 6 .. NFIELD - 1 of the NF-float row) are staged
// beside it by stage_channels.  A pair outside the box fails the gate and
// changes nothing, so the cull is exact for every channel as for K1's T.
//
// K3 keeps the first design's operations and their order per pair, so it
// stays bitwise equal to its plain version, and at <F, F, T> to K1 (whose
// code it repeats there, so that pair checks no second implementation).
// It writes the zeros of a channel its set lacks, so its wrapper allocates
// no zeroed image.
//
// K4 carries, per pixel, T, liveness and the inclusive prefix A_c with the
// output O_c and cotangent g_c of each channel.  For a contributing
// instance i (Ti its incoming transmittance, w = alpha Ti, gt the
// cotangent of T_final = finT):
//   g_alpha = gt (-finT / (1 - alpha)) + sum_c g_c (ch_c Ti - (O_c - A_c) / (1 - alpha))
// (the colour's output includes bg T_final, so its tail term is right as
// it stands), and d power = g_alpha opa G gives the conic and mean terms.
// The derivative of alpha ignores the 0.99 clamp (d alpha / d opa = G).
// A visited instance's NFIELD gradients are summed over the warp only when
// some lane contributed (warp_sum), then over the block's warps and the
// tile's quarters in the fixed order of K2 (Partials, last_quarter) into
// its slot's row of dpay.  Its chunks stage bwd_chunk(NFIELD) instances:
// 128 up to eight gradients, 64 above, so that the warps' rows fit in
// static shared memory.

// Stages the channel fields of Gaussian id (none when id < 0) into
// s_ch[a][threadIdx.x].
template <class C, int CH>
__device__ __forceinline__ void stage_channels(float (*s_ch)[CH],
                                               const float* __restrict__ fields, int id) {
  if (id < 0) return;
  const float* row = fields + (size_t)id * C::NF + 6;
#pragma unroll
  for (int a = 0; a < C::NFIELD - 6; ++a) s_ch[a][threadIdx.x] = row[a];
}

template <bool GEO, bool INVD, bool ONES>
__global__ void __launch_bounds__(CULL_NT)
tile_blend_fwd_kernel(const float* __restrict__ fields, const int* __restrict__ gidx,
                      const int* __restrict__ counts, const float* __restrict__ bg,
                      float* __restrict__ col, float* __restrict__ invd,
                      float* __restrict__ finT, float* __restrict__ am,
                      int H, int W, int ntx, int K) {
  using C = Chan<GEO, INVD, ONES>;
  constexpr int NA = C::NFIELD - 6;  // accumulated channels (ones colour derives from T)
  __shared__ Staged<> s;
  __shared__ float s_ch[C::NACC][CULL_CHUNK];
  const Pixels p = pixels_of(ntx);
  const float px = (float)p.gx, py = (float)p.gy;
  float T = 1.0f, acc[C::NACC];
#pragma unroll
  for (int a = 0; a < C::NACC; ++a) acc[a] = 0.0f;
  bool act = (p.gx < W) && (p.gy < H);

  const int n = counts[p.tile];
  const int* ids = gidx + (size_t)p.tile * K;
  for (int base = 0; base < n; base += CULL_CHUNK) {
    if (!__syncthreads_or(act)) break;  // also the barrier before restaging
    stage_channels<C, CULL_CHUNK>(s_ch, fields, stage<C::NF>(s, fields, ids, base, n));
    __syncthreads();
    walk(s, min(CULL_CHUNK, n - base), p, act, [&](int i) {
      if (!act) return;
      const float dx = s.mx[i] - px;
      const float dy = s.my[i] - py;
      const float power = power_of(s.ca[i], s.cb[i], s.cc[i], dx, dy);
      const float alpha = fminf(ALPHA_MAX, s.op[i] * expf(power));
      if (power <= 0.0f && alpha >= ALPHA_EPS) {
        const float aT = alpha * T;
        const float rem = T - aT;
        if (rem >= T_EPS) {
#pragma unroll
          for (int a = 0; a < NA; ++a) acc[a] = acc[a] + s_ch[a][i] * aT;
          T = rem;
        } else {
          act = false;  // the instance that fails the T test is excluded
        }
      }
    });
  }

  if (p.gx < W && p.gy < H) {
    const size_t o = (size_t)p.gy * W + p.gx;
    const size_t HW = (size_t)H * W;
    if constexpr (ONES) {
      col[o] = 1.0f - T * (1.0f - bg[0]);  // the conservation form of ones colour
    } else {
      col[o] = acc[0] + T * bg[0];
    }
    if constexpr (INVD) {
      invd[o] = acc[C::invd_ch() - C::C0];
    } else {
      invd[o] = 0.0f;
    }
    finT[o] = T;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if constexpr (GEO) {
        am[a * HW + o] = acc[C::am_ch() - C::C0 + a];
      } else {
        am[a * HW + o] = 0.0f;
      }
    }
  }
}

// At least four blocks per SM (at most 64 registers): at <F, F, T> the
// compiler then schedules with 46 registers instead of 39, and the kernel
// ran ~10% faster on an NVIDIA H100 80GB HBM3 (PERF.md); at <T, T, T> it
// takes 62 either way.
template <bool GEO, bool INVD, bool ONES>
__global__ void __launch_bounds__(CULL_NT, 4)
tile_blend_bwd_kernel(const float* __restrict__ fields, const int* __restrict__ gidx,
                      const int* __restrict__ counts, const float* __restrict__ col,
                      const float* __restrict__ invd, const float* __restrict__ finT,
                      const float* __restrict__ am, const float* __restrict__ gcol,
                      const float* __restrict__ ginvd, const float* __restrict__ gfin,
                      const float* __restrict__ gam, float* __restrict__ qrows,
                      int* __restrict__ tickets, float* __restrict__ dpay,
                      int H, int W, int ntx, int K) {
  using C = Chan<GEO, INVD, ONES>;
  constexpr int NCH = C::NCH;
  constexpr int NG = C::NFIELD;  // gradients per slot: the six geometry fields + channel fields
  constexpr int SPREAD = 32 / sum_pad(NG);  // lanes per value of warp_sum<NG>
  constexpr int CH = bwd_chunk(NG);
  __shared__ Staged<CH> s;
  __shared__ float s_ch[C::NACC][CH];
  __shared__ Partials<NG, CH> pt;
  const Pixels p = pixels_of(ntx);
  const float px = (float)p.gx, py = (float)p.gy;
  float T = 1.0f, gt = 0.0f, ot = 0.0f, A[NCH], gch[NCH], och[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) A[c] = gch[c] = och[c] = 0.0f;
  bool act = (p.gx < W) && (p.gy < H);
  if (act) {
    const size_t o = (size_t)p.gy * W + p.gx;
    const size_t HW = (size_t)H * W;
    gt = gfin[o];
    ot = finT[o];
    gch[0] = gcol[o];
    och[0] = col[o];
    if constexpr (INVD) {
      gch[C::invd_ch()] = ginvd[o];
      och[C::invd_ch()] = invd[o];
    }
    if constexpr (GEO) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        gch[C::am_ch() + a] = gam[a * HW + o];
        och[C::am_ch() + a] = am[a * HW + o];
      }
    }
  }

  const int n = counts[p.tile];
  const int* ids = gidx + (size_t)p.tile * K;
  int base = 0;
  for (; base < n; base += CH) {
    if (!__syncthreads_or(act)) break;  // also the barrier before restaging
    const int cnt = min(CH, n - base);
    stage_channels<C, CH>(s_ch, fields, stage<C::NF>(s, fields, ids, base, n));
    begin_chunk(pt, cnt);
    __syncthreads();
    walk(s, cnt, p, act, [&](int i) {
      float v[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) v[q] = 0.0f;
      bool hit = false;
      if (act) {
        const float ca = s.ca[i], cb = s.cb[i], cc = s.cc[i], op = s.op[i];
        const float dx = s.mx[i] - px;
        const float dy = s.my[i] - py;
        const float power = power_of(ca, cb, cc, dx, dy);
        const float G = expf(power);
        const float alpha = fminf(ALPHA_MAX, op * G);
        if (power <= 0.0f && alpha >= ALPHA_EPS) {
          const float Ti = T;
          const float w = alpha * Ti;
          const float rem = Ti - w;
          if (rem >= T_EPS) {
            T = rem;
            const float inv1a = 1.0f / (1.0f - alpha);
            float ga = gt * (-ot * inv1a);
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
              const float ch = c < C::C0 ? 1.0f : s_ch[c < C::C0 ? 0 : c - C::C0][i];
              A[c] = A[c] + ch * w;
              ga = ga + gch[c] * (ch * Ti - (och[c] - A[c]) * inv1a);
            }
            const float dpow = ga * (op * G);
            v[0] = dpow * (-ca * dx - cb * dy);
            v[1] = dpow * (-cc * dy - cb * dx);
            v[2] = dpow * (-0.5f * dx * dx);
            v[3] = dpow * (-dx * dy);
            v[4] = dpow * (-0.5f * dy * dy);
            v[5] = ga * G;
#pragma unroll
            for (int c = C::C0; c < NCH; ++c) v[6 + c - C::C0] = gch[c] * w;
            hit = true;
          } else {
            act = false;
          }
        }
      }
      if (__any_sync(0xffffffffu, hit)) warp_row(pt, i, warp_sum(v), SPREAD);
    });
    __syncthreads();
    end_chunk(pt, qrows, p.tile, K, base, cnt);
  }
  zero_rest<NG>(qrows, p.tile, K, base, n);
  if (!last_quarter(tickets, p.tile)) return;

  for (int j = threadIdx.x; j < K; j += CULL_NT) {
    float g[NG];
#pragma unroll
    for (int q = 0; q < NG; ++q) g[q] = 0.0f;
    if (j < n) quarter_sum(qrows, p.tile, K, j, g);
    float4* row = reinterpret_cast<float4*>(dpay + ((size_t)p.tile * K + j) * C::NF);
#pragma unroll
    for (int k = 0; k < C::NF / 4; ++k) {
      row[k] = make_float4(4 * k < NG ? g[4 * k] : 0.0f, 4 * k + 1 < NG ? g[4 * k + 1] : 0.0f,
                           4 * k + 2 < NG ? g[4 * k + 2] : 0.0f,
                           4 * k + 3 < NG ? g[4 * k + 3] : 0.0f);
    }
  }
}

// Launchers of the eight channel sets, indexed by geo * 4 + invd * 2 + ones.

template <bool GEO, bool INVD, bool ONES>
void launch_fwd(const float* fields, const int* gidx, const int* counts, const float* bg,
                float* col, float* invd, float* finT, float* am, int H, int W, int nty, int ntx,
                int K, cudaStream_t stream) {
  tile_blend_fwd_kernel<GEO, INVD, ONES><<<4 * nty * ntx, CULL_NT, 0, stream>>>(
      fields, gidx, counts, bg, col, invd, finT, am, H, W, ntx, K);
}

template <bool GEO, bool INVD, bool ONES>
void launch_bwd(const float* fields, const int* gidx, const int* counts, const float* col,
                const float* invd, const float* finT, const float* am, const float* gcol,
                const float* ginvd, const float* gfin, const float* gam, float* qrows,
                int* tickets, float* dpay, int H, int W, int nty, int ntx, int K,
                cudaStream_t stream) {
  tile_blend_bwd_kernel<GEO, INVD, ONES><<<4 * nty * ntx, CULL_NT, 0, stream>>>(
      fields, gidx, counts, col, invd, finT, am, gcol, ginvd, gfin, gam, qrows, tickets, dpay,
      H, W, ntx, K);
}

using fwd_fn = decltype(&launch_fwd<false, false, false>);
using bwd_fn = decltype(&launch_bwd<false, false, false>);

constexpr fwd_fn FWD[8] = {
    launch_fwd<false, false, false>, launch_fwd<false, false, true>,
    launch_fwd<false, true, false>,  launch_fwd<false, true, true>,
    launch_fwd<true, false, false>,  launch_fwd<true, false, true>,
    launch_fwd<true, true, false>,   launch_fwd<true, true, true>,
};
constexpr bwd_fn BWD[8] = {
    launch_bwd<false, false, false>, launch_bwd<false, false, true>,
    launch_bwd<false, true, false>,  launch_bwd<false, true, true>,
    launch_bwd<true, false, false>,  launch_bwd<true, false, true>,
    launch_bwd<true, true, false>,   launch_bwd<true, true, true>,
};

inline int channel_set(int geo, int invd, int ones) {
  return (geo ? 4 : 0) + (invd ? 2 : 0) + (ones ? 1 : 0);
}

}  // namespace

extern "C" {

const char* cg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K1: the training channel set's forward, col and finT only
int blend_train_fwd(const void* fields, const void* gidx, const void* counts, const void* bg,
                    void* col, void* finT, int H, int W, int nty, int ntx, int K,
                    void* stream) {
  blend_train_fwd_kernel<<<4 * nty * ntx, CULL_NT, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const int*)gidx, (const int*)counts, (const float*)bg, (float*)col,
      (float*)finT, H, W, ntx, K);
  return (int)cudaGetLastError();
}

// K2 and K5 (basis = 0) or K6b (basis = 1): the moments per slot in
// rows[T, K, 8]; qrows[T, 4, 6, K] is scratch, tickets[T] zeroed
int blend_train_bwd(const void* fields, const void* gidx, const void* counts, const void* col,
                    const void* finT, const void* gc, const void* gtt, void* qrows,
                    void* tickets, void* rows, int H, int W, int nty, int ntx, int K, int basis,
                    void* stream) {
  auto kernel = basis ? blend_train_bwd_kernel<true> : blend_train_bwd_kernel<false>;
  kernel<<<4 * nty * ntx, CULL_NT, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const int*)gidx, (const int*)counts, (const float*)col,
      (const float*)finT, (const float*)gc, (const float*)gtt, (float*)qrows, (int*)tickets,
      (float*)rows, H, W, ntx, K);
  return (int)cudaGetLastError();
}

// K3: a channel the set lacks reads zero
int tile_blend_fwd(const void* fields, const void* gidx, const void* counts, const void* bg,
                   void* col, void* invd, void* finT, void* am, int H, int W, int nty, int ntx,
                   int K, int geo, int invd_on, int ones, void* stream) {
  FWD[channel_set(geo, invd_on, ones)](
      (const float*)fields, (const int*)gidx, (const int*)counts, (const float*)bg, (float*)col,
      (float*)invd, (float*)finT, (float*)am, H, W, nty, ntx, K, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K4: per-slot rows of dpay[T, K, NF]; qrows[T, 4, NFIELD, K] is scratch,
// tickets[T] zeroed
int tile_blend_bwd(const void* fields, const void* gidx, const void* counts, const void* col,
                   const void* invd, const void* finT, const void* am, const void* gcol,
                   const void* ginvd, const void* gfin, const void* gam, void* qrows,
                   void* tickets, void* dpay, int H, int W, int nty, int ntx, int K, int geo,
                   int invd_on, int ones, void* stream) {
  BWD[channel_set(geo, invd_on, ones)](
      (const float*)fields, (const int*)gidx, (const int*)counts, (const float*)col,
      (const float*)invd, (const float*)finT, (const float*)am, (const float*)gcol,
      (const float*)ginvd, (const float*)gfin, (const float*)gam, (float*)qrows, (int*)tickets,
      (float*)dpay, H, W, nty, ntx, K, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The slot -> Gaussian reduction: out[P1, nf] (nf = 8 or 16) from
// rows[*, nf] through slots[R, P]
int slot_reduce(const void* rows, const void* slots, void* out, int nf, int R, int P, int P1,
                void* stream) {
  if (P1 == 0) return 0;
  auto kernel = nf == 16 ? slot_reduce_kernel<16> : slot_reduce_kernel<8>;
  kernel<<<(P1 + REDUCE_NT - 1) / REDUCE_NT, REDUCE_NT, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const int*)slots, (float*)out, R, P, P1);
  return (int)cudaGetLastError();
}

}  // extern "C"
