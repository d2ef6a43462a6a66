// Training-configuration tile blend for Hopper (sm_90a): forward (K1) and
// moment backward (K2).  Plain C interface, loaded with ctypes by
// curve_gaussian_tpu_torch/ops/rasterize_cuda.py.
//
// Replaces the Pallas kernels of curve_gaussian_tpu/ops/rasterize_pallas.py:
//   K1  _make_fwd_train_paired (and its unpaired odd-ntx form
//       _make_fwd_kernel(False, False, True)): front-to-back compositing
//   K2  _make_bwd_moment_rmw_paired (and the unpaired
//       _make_bwd_moment_rmw_kernel): the prefix-accumulator backward that
//       reduces six moments per (Gaussian, tile) into a [P1, 8] accumulator
// Tile pairing, the (8,128) register tiling and the tiled outputs are TPU
// layout and are not copied: one block takes one 32x32 tile and writes the
// spatial [H, W] images directly.
//
// Layout: 256 threads per block; thread t owns the pixel column t % 32 and
// the four rows t / 32 + 8 k (k = 0..3) of the tile.  Instances come from
// gather_idx[tile, :counts[tile]] (depth order) and their six fields are
// staged in shared memory from fields[P1, 8] (mx, my, ca, cb, cc, opa, 0, 0),
// read as two float4 per row.
//
// What bounds them: per-pixel serial chains of ~20 flops and one expf per
// (instance, pixel), so instruction throughput and the exp unit, not bytes (a tile's
// fields are a few KB).  The design keeps every per-pixel value in
// registers, reads each instance's fields once per block from shared
// memory, and leaves a tile's loop as soon as every pixel of it is done
// (__syncthreads_or at each chunk boundary).  K2 reduces each instance's
// moments with warp shuffles and shared memory and lands one atomicAdd per
// nonzero moment; the atomics make the summation order, and so the last
// bits of the accumulator, vary from run to run.
//
// Built with -fmad=false so that the arithmetic rounds like the plain
// PyTorch version's separate elementwise operations; expf (not __expf).

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

__device__ __forceinline__ float power_of(float ca, float cb, float cc, float dx, float dy) {
  return -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
}

__global__ void __launch_bounds__(NTHREADS)
blend_train_fwd_kernel(const float* __restrict__ fields, const int* __restrict__ gidx,
                       const int* __restrict__ counts, const float* __restrict__ bg,
                       float* __restrict__ col, float* __restrict__ finT,
                       int H, int W, int ntx, int K) {
  __shared__ float s_mx[FWD_CHUNK], s_my[FWD_CHUNK], s_ca[FWD_CHUNK];
  __shared__ float s_cb[FWD_CHUNK], s_cc[FWD_CHUNK], s_op[FWD_CHUNK];

  const int tile = blockIdx.x;
  const int tx = tile % ntx;
  const int ty = tile / ntx;
  const int lx = threadIdx.x & 31;
  const int ly0 = threadIdx.x >> 5;
  const int gx = tx * TILE + lx;
  const float px = (float)gx;
  float py[PPT], T[PPT];
  bool act[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int gy = ty * TILE + ly0 + 8 * k;
    py[k] = (float)gy;
    T[k] = 1.0f;
    act[k] = (gx < W) && (gy < H);
  }

  const int n = counts[tile];
  const int* ids = gidx + (size_t)tile * K;
  const float4* f4 = reinterpret_cast<const float4*>(fields);
  for (int base = 0; base < n; base += FWD_CHUNK) {
    const bool any = act[0] || act[1] || act[2] || act[3];
    if (!__syncthreads_or(any)) break;  // also the barrier before restaging
    const int j = base + threadIdx.x;
    if (j < n) {
      const int g = ids[j];
      const float4 a = f4[2 * (size_t)g];
      const float4 b = f4[2 * (size_t)g + 1];
      s_mx[threadIdx.x] = a.x;
      s_my[threadIdx.x] = a.y;
      s_ca[threadIdx.x] = a.z;
      s_cb[threadIdx.x] = a.w;
      s_cc[threadIdx.x] = b.x;
      s_op[threadIdx.x] = b.y;
    }
    __syncthreads();
    const int cnt = min(FWD_CHUNK, n - base);
    for (int jj = 0; jj < cnt; ++jj) {
      const float mx = s_mx[jj], my = s_my[jj], ca = s_ca[jj];
      const float cb = s_cb[jj], cc = s_cc[jj], op = s_op[jj];
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
            T[k] = rem;
          } else {
            act[k] = false;  // the instance that fails the T test is excluded
          }
        }
      }
    }
  }

  const float bgv = bg[0];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int gy = ty * TILE + ly0 + 8 * k;
    if (gx < W && gy < H) {
      const size_t o = (size_t)gy * W + gx;
      col[o] = 1.0f - T[k] * (1.0f - bgv);  // ones colour: col = 1 - T (1 - bg)
      finT[o] = T[k];
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
blend_train_bwd_kernel(const float* __restrict__ fields, const int* __restrict__ gidx,
                       const int* __restrict__ counts, const float* __restrict__ col,
                       const float* __restrict__ finT, const float* __restrict__ gc,
                       const float* __restrict__ gtt, float* __restrict__ acc,
                       int H, int W, int ntx, int K) {
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
  const float4* f4 = reinterpret_cast<const float4*>(fields);
  for (int base = 0; base < n; base += BWD_CHUNK) {
    const bool any = act[0] || act[1] || act[2] || act[3];
    if (!__syncthreads_or(any)) break;
    const int cnt = min(BWD_CHUNK, n - base);
    if (threadIdx.x < cnt) {
      const int g = ids[base + threadIdx.x];
      const float4 a = f4[2 * (size_t)g];
      const float4 b = f4[2 * (size_t)g + 1];
      s_id[threadIdx.x] = g;
      s_f[0][threadIdx.x] = a.x;
      s_f[1][threadIdx.x] = a.y;
      s_f[2][threadIdx.x] = a.z;
      s_f[3][threadIdx.x] = a.w;
      s_f[4][threadIdx.x] = b.x;
      s_f[5][threadIdx.x] = b.y;
    }
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
      if (s != 0.0f) atomicAdd(acc + 8 * (size_t)s_id[jj] + q, s);
    }
  }
}

}  // namespace

extern "C" {

const char* cg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int blend_train_fwd(const void* fields, const void* gidx, const void* counts, const void* bg,
                    void* col, void* finT, int H, int W, int nty, int ntx, int K,
                    void* stream) {
  blend_train_fwd_kernel<<<nty * ntx, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const int*)gidx, (const int*)counts, (const float*)bg,
      (float*)col, (float*)finT, H, W, ntx, K);
  return (int)cudaGetLastError();
}

int blend_train_bwd(const void* fields, const void* gidx, const void* counts, const void* col,
                    const void* finT, const void* gc, const void* gtt, void* acc, int H, int W,
                    int nty, int ntx, int K, void* stream) {
  blend_train_bwd_kernel<<<nty * ntx, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const int*)gidx, (const int*)counts, (const float*)col,
      (const float*)finT, (const float*)gc, (const float*)gtt, (float*)acc, H, W, ntx, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
