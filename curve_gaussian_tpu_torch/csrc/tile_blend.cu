// Tile blend for Hopper (sm_90a): the forward of every channel set (K3,
// whose training instantiation is K1), the per-slot backward of every field
// (K4), and the moment backward of the training channel set, reduced into a
// per-Gaussian accumulator (K2) or written per slot (K5).  Plain C
// interface, loaded with ctypes by curve_gaussian_tpu_torch/ops/
// rasterize_cuda.py (K1, K2) and tile_blend_cuda.py (K3, K4, K5).
//
// Replaces the Pallas kernels of curve_gaussian_tpu/ops/rasterize_pallas.py:
//   K1  _make_fwd_train_paired (and its unpaired odd-width form
//       _make_fwd_kernel(False, False, True)): front-to-back compositing of
//       the training channel set, here fwd<GEO=0, INVD=0, ONES=1>
//   K2  _make_bwd_moment_rmw_paired (and the unpaired
//       _make_bwd_moment_rmw_kernel): six moments per (Gaussian, tile)
//       reduced into a [P1, 8] accumulator, here moment<PER_SLOT=0>
//   K3  _make_fwd_kernel(geo, invd, ones, indirect): compositing of the
//       colour channel (ones or a per-splat colour), the inverse depth and
//       the four allmap channels
//   K4  _make_bwd_kernel(geo, invd, ones, indirect): the gradient of every
//       field of every instance slot, written to a [T, K, NF] table
//   K5  _make_bwd_moment_kernel(indirect=True): K2's six moments written per
//       slot to a [T, K, 8] table, here moment<PER_SLOT=1>
// The slot -> Gaussian reduction of K4's and K5's tables is an index_add_
// outside the kernels, as the JAX package leaves it to an XLA scatter-add.
// The TPU layout is not copied: no tile pairing, no (8,128) register tiles,
// no tiled outputs, no sub-group pipelining, no parking buffers or one-hot
// MXU combiners, no [T, K, NF] payload table (the fields are read through
// gather_idx).
//
// Layout: one block per 32x32 tile, 256 threads; thread t owns the pixel
// column t % 32 and the rows t / 32 + 8 k (k = 0..3).  Instances come from
// gather_idx[tile, :counts[tile]] (depth order).  The kernels are templated
// on the channel set <GEO, INVD, ONES>, so every loop over channels unrolls
// at compile time.  Fields are staged in shared memory from fields[P1, NF]
// through gather_idx, one row per thread, as NF/4 float4 loads.  A tile's
// loop ends at the first chunk boundary where every pixel of it is done
// (__syncthreads_or).
//
// What bounds them: per-pixel serial chains and one expf per (instance,
// pixel), so instruction throughput, not bytes (a tile's fields are a few
// KB).  K4 carries 3 registers per channel and pixel (prefix, cotangent,
// output) and reduces up to 12 values per instance across the block (warp
// shuffles, then shared memory).  K4 and K5 write each slot's row once, with
// no atomics, so their results do not depend on the order in which blocks
// run; K2 lands one atomicAdd per nonzero moment, so the last bits of its
// accumulator vary from run to run.
//
// Built with -fmad=false so that the arithmetic rounds like the plain
// PyTorch versions' separate elementwise operations; expf (not __expf).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int NTHREADS = 256;
constexpr int PPT = 4;          // pixels per thread
constexpr int FWD_CHUNK = 256;  // instances staged per forward chunk
constexpr int BWD_CHUNK = 32;   // instances per backward reduction batch
constexpr int NWARPS = NTHREADS / 32;

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

// Stage the first NFIELD fields of gather_idx[base + threadIdx.x] into
// s_f[q][threadIdx.x] (q < NFIELD) when that slot is below n.
template <int NFIELD, int NF, int CHUNK>
__device__ __forceinline__ void stage_fields(float (*s_f)[CHUNK], const float* __restrict__ fields,
                                             const int* __restrict__ ids, int base, int n) {
  const int j = base + threadIdx.x;
  if (threadIdx.x < CHUNK && j < n) {
    const float4* row = reinterpret_cast<const float4*>(fields) + (size_t)ids[j] * (NF / 4);
#pragma unroll
    for (int v = 0; v < NF / 4; ++v) {
      const float4 x = row[v];
      if (4 * v + 0 < NFIELD) s_f[4 * v + 0][threadIdx.x] = x.x;
      if (4 * v + 1 < NFIELD) s_f[4 * v + 1][threadIdx.x] = x.y;
      if (4 * v + 2 < NFIELD) s_f[4 * v + 2][threadIdx.x] = x.z;
      if (4 * v + 3 < NFIELD) s_f[4 * v + 3][threadIdx.x] = x.w;
    }
  }
}

// ---------------------------------------------------------------------------
// K3 (and K1): forward
// ---------------------------------------------------------------------------
//
// It writes col and finT, invd only when INVD and am only when GEO: the
// caller supplies zeros for a gated channel, and K1 has none to write.  The
// six geometry fields are staged in arrays of their own: with every field
// in one [NFIELD][CHUNK] array, <false, false, true> (K1) ran measurably
// slower on an H100.

template <bool GEO, bool INVD, bool ONES>
__global__ void __launch_bounds__(NTHREADS)
tile_blend_fwd_kernel(const float* __restrict__ fields, const int* __restrict__ gidx,
                      const int* __restrict__ counts, const float* __restrict__ bg,
                      float* __restrict__ col, float* __restrict__ invd,
                      float* __restrict__ finT, float* __restrict__ am,
                      int H, int W, int ntx, int K) {
  using C = Chan<GEO, INVD, ONES>;
  constexpr int NA = C::NCH - C::C0;  // accumulated channels (ones colour derives from T)
  __shared__ float s_mx[FWD_CHUNK], s_my[FWD_CHUNK], s_ca[FWD_CHUNK];
  __shared__ float s_cb[FWD_CHUNK], s_cc[FWD_CHUNK], s_op[FWD_CHUNK];
  __shared__ float s_ch[C::NACC][FWD_CHUNK];

  const int tile = blockIdx.x;
  const int tx = tile % ntx;
  const int ty = tile / ntx;
  const int lx = threadIdx.x & 31;
  const int ly0 = threadIdx.x >> 5;
  const int gx = tx * TILE + lx;
  const float px = (float)gx;
  float py[PPT], T[PPT], acc[PPT][C::NACC];
  bool act[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int gy = ty * TILE + ly0 + 8 * k;
    py[k] = (float)gy;
    T[k] = 1.0f;
    act[k] = (gx < W) && (gy < H);
#pragma unroll
    for (int a = 0; a < C::NACC; ++a) acc[k][a] = 0.0f;
  }

  const int n = counts[tile];
  const int* ids = gidx + (size_t)tile * K;
  for (int base = 0; base < n; base += FWD_CHUNK) {
    const bool any = act[0] || act[1] || act[2] || act[3];
    if (!__syncthreads_or(any)) break;  // also the barrier before restaging
    const int j = base + threadIdx.x;
    if (j < n) {
      const float4* row = reinterpret_cast<const float4*>(fields) + (size_t)ids[j] * (C::NF / 4);
      float r[C::NF];
#pragma unroll
      for (int v = 0; v < C::NF / 4; ++v) {
        const float4 x = row[v];
        r[4 * v] = x.x;
        r[4 * v + 1] = x.y;
        r[4 * v + 2] = x.z;
        r[4 * v + 3] = x.w;
      }
      s_mx[threadIdx.x] = r[0];
      s_my[threadIdx.x] = r[1];
      s_ca[threadIdx.x] = r[2];
      s_cb[threadIdx.x] = r[3];
      s_cc[threadIdx.x] = r[4];
      s_op[threadIdx.x] = r[5];
#pragma unroll
      for (int a = 0; a < NA; ++a) s_ch[a][threadIdx.x] = r[6 + a];
    }
    __syncthreads();
    const int cnt = min(FWD_CHUNK, n - base);
    for (int jj = 0; jj < cnt; ++jj) {
      const float mx = s_mx[jj], my = s_my[jj], ca = s_ca[jj];
      const float cb = s_cb[jj], cc = s_cc[jj], op = s_op[jj];
      float ch[C::NACC];
#pragma unroll
      for (int a = 0; a < NA; ++a) ch[a] = s_ch[a][jj];
      const float dx = mx - px;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (!act[k]) continue;
        const float dy = my - py[k];
        const float power = power_of(ca, cb, cc, dx, dy);
        const float alpha = fminf(ALPHA_MAX, op * expf(power));
        if (power <= 0.0f && alpha >= ALPHA_EPS) {
          const float aT = alpha * T[k];
          const float rem = T[k] - aT;
          if (rem >= T_EPS) {
#pragma unroll
            for (int a = 0; a < NA; ++a) acc[k][a] = acc[k][a] + ch[a] * aT;
            T[k] = rem;
          } else {
            act[k] = false;  // the instance that fails the T test is excluded
          }
        }
      }
    }
  }

  const float bgv = bg[0];
  const size_t HW = (size_t)H * W;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int gy = ty * TILE + ly0 + 8 * k;
    if (gx < W && gy < H) {
      const size_t o = (size_t)gy * W + gx;
      if constexpr (ONES) {
        col[o] = 1.0f - T[k] * (1.0f - bgv);  // the conservation form of ones colour
      } else {
        col[o] = acc[k][0] + T[k] * bgv;
      }
      if constexpr (INVD) invd[o] = acc[k][C::invd_ch() - C::C0];
      finT[o] = T[k];
      if constexpr (GEO) {
#pragma unroll
        for (int a = 0; a < 4; ++a) am[a * HW + o] = acc[k][C::am_ch() - C::C0 + a];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4: per-slot gradients of every field
// ---------------------------------------------------------------------------
//
// One front-to-back pass carries T, liveness and the inclusive prefix A_c
// of every channel c.  For a contributing instance i (Ti its incoming
// transmittance, w = alpha Ti, O_c the output, g_c its cotangent, gt that
// of T_final = finT):
//   g_alpha = gt (-finT / (1 - alpha)) + sum_c g_c (ch_c Ti - (O_c - A_c) / (1 - alpha))
// (the colour's output includes bg T_final, so its tail term is right as
// it stands), and d power = g_alpha opa G gives the conic and mean terms.
// The derivative of alpha ignores the 0.99 clamp (d alpha / d opa = G).

template <bool GEO, bool INVD, bool ONES>
__global__ void __launch_bounds__(NTHREADS)
tile_blend_bwd_kernel(const float* __restrict__ fields, const int* __restrict__ gidx,
                      const int* __restrict__ counts, const float* __restrict__ col,
                      const float* __restrict__ invd, const float* __restrict__ finT,
                      const float* __restrict__ am, const float* __restrict__ gcol,
                      const float* __restrict__ ginvd, const float* __restrict__ gfin,
                      const float* __restrict__ gam, float* __restrict__ dpay,
                      int H, int W, int ntx, int K) {
  using C = Chan<GEO, INVD, ONES>;
  constexpr int NCH = C::NCH;
  constexpr int NG = C::NFIELD;  // gradients per slot: the six geometry fields + channel fields
  __shared__ float s_f[NG][BWD_CHUNK];
  __shared__ float s_red[NWARPS][BWD_CHUNK][NG];

  const int tile = blockIdx.x;
  const int tx = tile % ntx;
  const int ty = tile / ntx;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gx = tx * TILE + lane;
  const float px = (float)gx;
  const size_t HW = (size_t)H * W;
  float py[PPT], T[PPT], gt[PPT], ot[PPT];
  float A[PPT][NCH], gch[PPT][NCH], och[PPT][NCH];
  bool act[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int gy = ty * TILE + warp + 8 * k;
    py[k] = (float)gy;
    T[k] = 1.0f;
    act[k] = (gx < W) && (gy < H);
    const size_t o = act[k] ? (size_t)gy * W + gx : 0;
    gt[k] = act[k] ? gfin[o] : 0.0f;
    ot[k] = act[k] ? finT[o] : 0.0f;
    gch[k][0] = act[k] ? gcol[o] : 0.0f;
    och[k][0] = act[k] ? col[o] : 0.0f;
    if constexpr (INVD) {
      gch[k][C::invd_ch()] = act[k] ? ginvd[o] : 0.0f;
      och[k][C::invd_ch()] = act[k] ? invd[o] : 0.0f;
    }
    if constexpr (GEO) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        gch[k][C::am_ch() + a] = act[k] ? gam[a * HW + o] : 0.0f;
        och[k][C::am_ch() + a] = act[k] ? am[a * HW + o] : 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) A[k][c] = 0.0f;
  }

  const int n = counts[tile];
  const int* ids = gidx + (size_t)tile * K;
  for (int base = 0; base < n; base += BWD_CHUNK) {
    const bool any = act[0] || act[1] || act[2] || act[3];
    if (!__syncthreads_or(any)) break;
    const int cnt = min(BWD_CHUNK, n - base);
    stage_fields<NG, C::NF, BWD_CHUNK>(s_f, fields, ids, base, n);
    __syncthreads();
    for (int jj = 0; jj < cnt; ++jj) {
      const float mx = s_f[0][jj], my = s_f[1][jj], ca = s_f[2][jj];
      const float cb = s_f[3][jj], cc = s_f[4][jj], op = s_f[5][jj];
      float chv[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) chv[c] = c < C::C0 ? 1.0f : s_f[6 + c - C::C0][jj];
      const float dx = mx - px;
      float v[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) v[q] = 0.0f;
      bool hit = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (!act[k]) continue;
        const float dy = my - py[k];
        const float power = power_of(ca, cb, cc, dx, dy);
        const float G = expf(power);
        const float alpha = fminf(ALPHA_MAX, op * G);
        if (power <= 0.0f && alpha >= ALPHA_EPS) {
          const float Ti = T[k];
          const float w = alpha * Ti;
          const float rem = Ti - w;
          if (rem >= T_EPS) {
            T[k] = rem;
            const float inv1a = 1.0f / (1.0f - alpha);
            float ga = gt[k] * (-ot[k] * inv1a);
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
              A[k][c] = A[k][c] + chv[c] * w;
              ga = ga + gch[k][c] * (chv[c] * Ti - (och[k][c] - A[k][c]) * inv1a);
            }
            const float dpow = ga * (op * G);
            v[0] += dpow * (-ca * dx - cb * dy);
            v[1] += dpow * (-cc * dy - cb * dx);
            v[2] += dpow * (-0.5f * dx * dx);
            v[3] += dpow * (-dx * dy);
            v[4] += dpow * (-0.5f * dy * dy);
            v[5] += ga * G;
#pragma unroll
            for (int c = C::C0; c < NCH; ++c) v[6 + c - C::C0] += gch[k][c] * w;
            hit = true;
          } else {
            act[k] = false;
          }
        }
      }
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int q = 0; q < NG; ++q) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v[q] += __shfl_xor_sync(0xffffffffu, v[q], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < NG; ++q) s_red[warp][jj][q] = v[q];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cnt * NG; i += NTHREADS) {
      const int jj = i / NG;
      const int q = i % NG;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += s_red[w][jj][q];
      dpay[((size_t)tile * K + base + jj) * C::NF + q] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// K2 and K5: moments of the training channel set
// ---------------------------------------------------------------------------
//
// One front-to-back pass carries T and the prefix pr += gc w, which gives
// g_alpha = gc Ti + (base_inv + pr) / (1 - alpha), base_inv = -gtt finT - gc col,
// and D' = g_alpha G.  The six moments (D', D'dx, D'dy, D'dx^2, D'dx dy,
// D'dy^2) of each instance are reduced over the tile's pixels, then either
// added into the Gaussian's row of out[P1, 8] (K2: atomicAdd, nonzero sums
// only) or written to the slot's row of out[T, K, 8] (K5, PER_SLOT).

template <bool PER_SLOT>
__global__ void __launch_bounds__(NTHREADS)
blend_moment_bwd_kernel(const float* __restrict__ fields, const int* __restrict__ gidx,
                        const int* __restrict__ counts, const float* __restrict__ col,
                        const float* __restrict__ finT, const float* __restrict__ gc,
                        const float* __restrict__ gtt, float* __restrict__ out,
                        int H, int W, int ntx, int K) {
  static_assert(BWD_CHUNK * 6 <= NTHREADS, "one pass of the block writes a chunk's moments");
  __shared__ float s_f[6][BWD_CHUNK];
  __shared__ int s_id[BWD_CHUNK];
  __shared__ float s_red[NWARPS][BWD_CHUNK][6];

  const int tile = blockIdx.x;
  const int tx = tile % ntx;
  const int ty = tile / ntx;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gx = tx * TILE + lane;
  const float px = (float)gx;
  float py[PPT], T[PPT], pr[PPT], gcv[PPT], binv[PPT];
  bool act[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int gy = ty * TILE + warp + 8 * k;
    py[k] = (float)gy;
    T[k] = 1.0f;
    pr[k] = 0.0f;
    act[k] = (gx < W) && (gy < H);
    gcv[k] = 0.0f;
    binv[k] = 0.0f;
    if (act[k]) {
      const size_t o = (size_t)gy * W + gx;
      gcv[k] = gc[o];
      binv[k] = -gtt[o] * finT[o] - gc[o] * col[o];
    }
  }

  const int n = counts[tile];
  const int* ids = gidx + (size_t)tile * K;
  for (int base = 0; base < n; base += BWD_CHUNK) {
    const bool any = act[0] || act[1] || act[2] || act[3];
    if (!__syncthreads_or(any)) break;
    const int cnt = min(BWD_CHUNK, n - base);
    stage_fields<6, 8, BWD_CHUNK>(s_f, fields, ids, base, n);
    if (!PER_SLOT && threadIdx.x < cnt) s_id[threadIdx.x] = ids[base + threadIdx.x];
    __syncthreads();
    for (int jj = 0; jj < cnt; ++jj) {
      const float mx = s_f[0][jj], my = s_f[1][jj], ca = s_f[2][jj];
      const float cb = s_f[3][jj], cc = s_f[4][jj], op = s_f[5][jj];
      const float dx = mx - px;
      float m[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      bool hit = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (!act[k]) continue;
        const float dy = my - py[k];
        const float power = power_of(ca, cb, cc, dx, dy);
        const float G = expf(power);
        const float alpha = fminf(ALPHA_MAX, op * G);
        if (power <= 0.0f && alpha >= ALPHA_EPS) {
          const float aT = alpha * T[k];
          const float rem = T[k] - aT;
          if (rem >= T_EPS) {
            const float Ti = T[k];
            T[k] = rem;
            pr[k] = pr[k] + gcv[k] * aT;  // gc times the inclusive prefix
            const float inv1a = 1.0f / (1.0f - alpha);
            const float gal = gcv[k] * Ti + inv1a * (binv[k] + pr[k]);
            const float Dp = gal * G;
            const float e1 = Dp * dx;
            const float e2 = Dp * dy;
            m[0] += Dp;
            m[1] += e1;
            m[2] += e2;
            m[3] += e1 * dx;
            m[4] += e1 * dy;
            m[5] += e2 * dy;
            hit = true;
          } else {
            act[k] = false;
          }
        }
      }
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int q = 0; q < 6; ++q) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) m[q] += __shfl_xor_sync(0xffffffffu, m[q], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < 6; ++q) s_red[warp][jj][q] = m[q];
      }
    }
    __syncthreads();
    if (threadIdx.x < cnt * 6) {
      const int jj = threadIdx.x / 6;
      const int q = threadIdx.x % 6;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += s_red[w][jj][q];
      if constexpr (PER_SLOT) {
        out[((size_t)tile * K + base + jj) * 8 + q] = s;
      } else if (s != 0.0f) {
        atomicAdd(out + 8 * (size_t)s_id[jj] + q, s);
      }
    }
  }
}

// Launchers of the eight channel sets, indexed by geo * 4 + invd * 2 + ones.

template <bool GEO, bool INVD, bool ONES>
void launch_fwd(const float* fields, const int* gidx, const int* counts, const float* bg,
                float* col, float* invd, float* finT, float* am, int H, int W, int nty, int ntx,
                int K, cudaStream_t stream) {
  tile_blend_fwd_kernel<GEO, INVD, ONES><<<nty * ntx, NTHREADS, 0, stream>>>(
      fields, gidx, counts, bg, col, invd, finT, am, H, W, ntx, K);
}

template <bool GEO, bool INVD, bool ONES>
void launch_bwd(const float* fields, const int* gidx, const int* counts, const float* col,
                const float* invd, const float* finT, const float* am, const float* gcol,
                const float* ginvd, const float* gfin, const float* gam, float* dpay, int H,
                int W, int nty, int ntx, int K, cudaStream_t stream) {
  tile_blend_bwd_kernel<GEO, INVD, ONES><<<nty * ntx, NTHREADS, 0, stream>>>(
      fields, gidx, counts, col, invd, finT, am, gcol, ginvd, gfin, gam, dpay, H, W, ntx, K);
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

template <bool PER_SLOT>
int launch_moment(const void* fields, const void* gidx, const void* counts, const void* col,
                  const void* finT, const void* gc, const void* gtt, void* out, int H, int W,
                  int nty, int ntx, int K, void* stream) {
  blend_moment_bwd_kernel<PER_SLOT><<<nty * ntx, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const int*)gidx, (const int*)counts, (const float*)col,
      (const float*)finT, (const float*)gc, (const float*)gtt, (float*)out, H, W, ntx, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K1: the training channel set's forward, col and finT only
int blend_train_fwd(const void* fields, const void* gidx, const void* counts, const void* bg,
                    void* col, void* finT, int H, int W, int nty, int ntx, int K,
                    void* stream) {
  launch_fwd<false, false, true>((const float*)fields, (const int*)gidx, (const int*)counts,
                                 (const float*)bg, (float*)col, nullptr, (float*)finT, nullptr,
                                 H, W, nty, ntx, K, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K2: moments added into acc[P1, 8], which the caller zeroes
int blend_train_bwd(const void* fields, const void* gidx, const void* counts, const void* col,
                    const void* finT, const void* gc, const void* gtt, void* acc, int H, int W,
                    int nty, int ntx, int K, void* stream) {
  return launch_moment<false>(fields, gidx, counts, col, finT, gc, gtt, acc, H, W, nty, ntx, K,
                              stream);
}

// K3: invd and am are written only for a channel set that has them
int tile_blend_fwd(const void* fields, const void* gidx, const void* counts, const void* bg,
                   void* col, void* invd, void* finT, void* am, int H, int W, int nty, int ntx,
                   int K, int geo, int invd_on, int ones, void* stream) {
  FWD[channel_set(geo, invd_on, ones)](
      (const float*)fields, (const int*)gidx, (const int*)counts, (const float*)bg, (float*)col,
      (float*)invd, (float*)finT, (float*)am, H, W, nty, ntx, K, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K4: per-slot rows of dpay[T, K, NF]; the caller zeroes the table
int tile_blend_bwd(const void* fields, const void* gidx, const void* counts, const void* col,
                   const void* invd, const void* finT, const void* am, const void* gcol,
                   const void* ginvd, const void* gfin, const void* gam, void* dpay, int H, int W,
                   int nty, int ntx, int K, int geo, int invd_on, int ones, void* stream) {
  BWD[channel_set(geo, invd_on, ones)](
      (const float*)fields, (const int*)gidx, (const int*)counts, (const float*)col,
      (const float*)invd, (const float*)finT, (const float*)am, (const float*)gcol,
      (const float*)ginvd, (const float*)gfin, (const float*)gam, (float*)dpay, H, W, nty, ntx,
      K, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K5: per-slot rows of mom[T, K, 8]; the caller zeroes the table
int blend_moment_bwd(const void* fields, const void* gidx, const void* counts, const void* col,
                     const void* finT, const void* gc, const void* gtt, void* mom, int H, int W,
                     int nty, int ntx, int K, void* stream) {
  return launch_moment<true>(fields, gidx, counts, col, finT, gc, gtt, mom, H, W, nty, ntx, K,
                             stream);
}

}  // extern "C"
