// Fused single-channel SSIM for Hopper (sm_90a): value (K7) and input
// gradients (K8).  Plain C interface, loaded with ctypes by
// curve_gaussian_tpu_torch/ops/ssim_cuda.py.
//
// Replaces the Pallas kernels of curve_gaussian_tpu/ops/ssim_pallas.py:
//   K7  _fwd_kernel: five moment maps (x, y, x^2, y^2, xy), separable 11-tap
//       sigma-1.5 blur with exact 'same' zero padding, SSIM map, masked mean
//   K8  _bwd_kernel: moments recomputed on a halo tile, the four
//       d(mean SSIM)/d(moment) maps, the adjoint blur (the same blur: the
//       window is symmetric), combined into dimg1 and dimg2
// The TPU version blurs with band matrices on the matrix unit over 128-row
// slabs; here each block owns a TW x TH output tile and blurs by direct
// 11-tap sums in shared memory.
//
// What sets their time on the card.  Both do 250-450 float operations per
// pixel against 8-16 bytes of device memory, so instruction issue, not
// bytes.  The first design (16x16 tiles, one output per thread and pass)
// spent it on shared-memory loads (an 11-tap sum loaded its 11 inputs and
// its 11 taps: ~90 loads per pixel in K7, ~340 in K8), on recomputing K8's
// halo (moments on 26x26 for a 16x16 tile: ~1,065 float operations per
// pixel) and on 1.55 waves of K8's 1,024 blocks; K7's value took two more
// launches (torch.sum of the partials, the division).  Measured on an H100
// 80GB HBM3 at 700 W, it took 0.0178 ms (K7, three launches; its kernel
// alone 8.6 us of device time) and 0.0278 ms (K8).  This design:
//   - passes the 11 taps by value (`Taps`, a kernel argument in the
//     constant bank): every tap product reads its weight as an operand;
//   - blocks registers along each pass: a thread makes R consecutive
//     outputs of a row or a column from R + 10 values loaded once
//     (`moment_row`, `blur_seg`, shared by both kernels), and forms x^2,
//     y^2 and xy once per input value instead of once per tap;
//   - takes 32x32 output tiles (K8: input 52x52, moments on 42x42, the
//     adjoint's horizontal pass on 42x32): ~740 float operations and ~74
//     shared loads per pixel in K8, ~284 and ~27 in K7; 256 blocks at
//     512x512, one wave;
//   - stages the input with every device load of a thread in flight at
//     once;
//   - ends K7 in its own launch: each block writes its partial sum, takes a
//     ticket, and the block with the last ticket sums the partials in index
//     order with a fixed tree, writes the mean and resets the ticket, so the
//     value is the same from run to run whichever block ends last.  The
//     ticket is one counter per device: one stream per device, as the port
//     runs.
// On the same card: K7 0.0108 ms in one launch (6.6 us of device time), K8
// 0.0155 ms (11.2 us; the first design's kernels 8.6 and 23.8 us).  At the
// card's peak float32 rate (-fmad=false: a product and a sum are two
// instructions) their float work would take ~2.2 and ~5.8 us and their
// shared loads ~0.9 and ~2.3 us; what holds the rest (staging latency,
// dependent tap sums at 4 warps per scheduler, K7's ticket) is not
// measured.  ptxas (CUDA 12.9, sm_90a): K7 64 registers, 42,168 B of
// dynamic shared memory, 4 blocks per SM; K8 86 registers, 95,664 B, 2
// blocks per SM; no spills (PERF.md §6).
//
// Every per-pixel sum keeps the plain version's order (horizontal taps
// k = 0..10 from 0, then vertical taps k = 0..10, each product rounded on
// its own: -fmad=false), so K8 and K7's SSIM map are bitwise equal to the
// plain PyTorch versions; only K7's final sum runs in another order.

#include <cuda_runtime.h>

namespace {

constexpr int HALO = 5;            // window_size / 2
constexpr int WS = 2 * HALO + 1;   // window taps
constexpr float C1 = 1e-4f;        // 0.01^2
constexpr float C2 = 9e-4f;        // 0.03^2

constexpr int TW = 32, TH = 32;    // output tile, both kernels (ssim_cuda.TILE)
constexpr int NT = 256;            // threads per block
constexpr int MIN_BLOCKS = 2;      // resident per SM (K8's shared memory allows 2)
// outputs per thread of each pass: K7 horizontal and vertical; K8 horizontal
// moments, vertical moments, adjoint horizontal, adjoint vertical
constexpr int K7_HR = 4, K7_VR = 4;
constexpr int K8_HR = 3, K8_VR = 7, K8_AHR = 4, K8_AVR = 4;

// K7: input (TH + 10) x (TW + 10); horizontal moments (TH + 10) x TW
constexpr int F_ROWS = TH + 2 * HALO, F_COLS = TW + 2 * HALO;
constexpr int F_IP = F_COLS + 1, F_HP = TW + 1;  // odd pitches: a row per lane
constexpr int F_SMEM = (2 * F_ROWS * F_IP + 5 * F_ROWS * F_HP) * 4;
// K8: input (TH + 20) x (TW + 20); moments (TH + 20) x (TW + 10), then
// (TH + 10) x (TW + 10) with the d-maps; the adjoint's horizontal pass
// (TH + 10) x TW over the horizontal moments
constexpr int B_ROWS = TH + 4 * HALO, B_COLS = TW + 4 * HALO;
constexpr int B_MROWS = TH + 2 * HALO, B_MCOLS = TW + 2 * HALO;
constexpr int B_IP = B_COLS + 1, B_MP = B_MCOLS + 1, B_AP = TW + 1;
constexpr int B_HM = 5 * B_ROWS * B_MP, B_DM = 4 * B_MROWS * B_MP;
constexpr int B_SMEM = (2 * B_ROWS * B_IP + B_HM + B_DM) * 4;

static_assert(TW % K7_HR == 0 && TH % K7_VR == 0 && TW * (TH / K7_VR) == NT, "K7 runs");
static_assert(B_MCOLS % K8_HR == 0 && B_MROWS % K8_VR == 0 && TW % K8_AHR == 0 &&
              TH % K8_AVR == 0, "K8 runs");
static_assert(4 * B_MROWS * B_AP <= B_HM, "the adjoint's pass fits over the moments");
static_assert(F_IP % 2 == 1 && F_HP % 2 == 1 && B_IP % 2 == 1 && B_MP % 2 == 1 &&
              B_AP % 2 == 1, "odd pitches");

struct Taps {
  float w[WS];
};

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w];
  }
  return s;
}

// Load ROWS x COLS pixels at (y0, x0) of both images into shared memory
// (row pitch P), zero outside the image.  Every load of a thread is issued
// before its first store, so the block waits for device memory once, not
// once per pixel a thread stages.
template <int ROWS, int COLS, int P>
__device__ __forceinline__ void load_pair(const float* __restrict__ img1,
                                          const float* __restrict__ img2, int H, int W, int y0,
                                          int x0, float* s1, float* s2) {
  constexpr int N = ROWS * COLS, ITER = (N + NT - 1) / NT;
  float v1[ITER], v2[ITER];
#pragma unroll
  for (int n = 0; n < ITER; ++n) {
    const int i = threadIdx.x + n * NT;
    const int gy = y0 + i / COLS, gx = x0 + i % COLS;
    const bool in = i < N && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t o = (size_t)gy * W + gx;
    v1[n] = in ? __ldg(img1 + o) : 0.0f;
    v2[n] = in ? __ldg(img2 + o) : 0.0f;
  }
#pragma unroll
  for (int n = 0; n < ITER; ++n) {
    const int i = threadIdx.x + n * NT;
    if (i < N) {
      s1[(i / COLS) * P + i % COLS] = v1[n];
      s2[(i / COLS) * P + i % COLS] = v2[n];
    }
  }
}

// o[j] = w[0] v[j] + ... + w[10] v[j + 10], summed from 0 in tap order
template <int R>
__device__ __forceinline__ void taps_run(const float (&v)[R + WS - 1], const Taps& t,
                                         float (&o)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float a = 0.0f;
#pragma unroll
    for (int k = 0; k < WS; ++k) a += t.w[k] * v[j + k];
    o[j] = a;
  }
}

// One map blurred along a segment: R outputs from the R + 10 values at
// src, src + S, src + 2 S, ...
template <int R, int S>
__device__ __forceinline__ void blur_seg(const float* src, const Taps& t, float (&o)[R]) {
  float v[R + WS - 1];
#pragma unroll
  for (int i = 0; i < R + WS - 1; ++i) v[i] = src[i * S];
  taps_run<R>(v, t, o);
}

template <int R>
__device__ __forceinline__ void store_run(float* o, const float (&s)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) o[j] = s[j];
}

// The horizontal pass of the five moment maps over R consecutive outputs of
// a row: a and b point at the first of the row's R + 10 inputs of img1 and
// img2, map q goes to o + q * MS.
template <int R, int MS>
__device__ __forceinline__ void moment_row(const float* a, const float* b, const Taps& t,
                                           float* o) {
  constexpr int N = R + WS - 1;
  float x[N], y[N], p[N], s[R];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = a[i];
    y[i] = b[i];
  }
  taps_run<R>(x, t, s);
  store_run<R>(o, s);
  taps_run<R>(y, t, s);
  store_run<R>(o + MS, s);
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = x[i] * x[i];
  taps_run<R>(p, t, s);
  store_run<R>(o + 2 * MS, s);
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = y[i] * y[i];
  taps_run<R>(p, t, s);
  store_run<R>(o + 3 * MS, s);
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = x[i] * y[i];
  taps_run<R>(p, t, s);
  store_run<R>(o + 4 * MS, s);
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS)
ssim_fwd_kernel(const float* __restrict__ img1, const float* __restrict__ img2, const Taps t,
                float* __restrict__ partial, unsigned* __restrict__ ticket,
                float* __restrict__ out, int H, int W) {
  extern __shared__ float smem[];
  float* s1 = smem;
  float* s2 = s1 + F_ROWS * F_IP;
  float* hm = s2 + F_ROWS * F_IP;  // [5][F_ROWS][F_HP]
  __shared__ float red[NT / 32];
  __shared__ bool last;

  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  load_pair<F_ROWS, F_COLS, F_IP>(img1, img2, H, W, ty0 - HALO, tx0 - HALO, s1, s2);
  __syncthreads();

  // horizontal moments, F_ROWS x TW; neighbouring lanes take neighbouring rows
  for (int i = threadIdx.x; i < F_ROWS * (TW / K7_HR); i += NT) {
    const int r = i % F_ROWS, c0 = (i / F_ROWS) * K7_HR;
    moment_row<K7_HR, F_ROWS * F_HP>(s1 + r * F_IP + c0, s2 + r * F_IP + c0, t,
                                     hm + r * F_HP + c0);
  }
  __syncthreads();

  // vertical moments and the SSIM map, K7_VR rows of one column per thread
  const int c = threadIdx.x % TW, r0 = (threadIdx.x / TW) * K7_VR;
  float m[5][K7_VR];
#pragma unroll
  for (int q = 0; q < 5; ++q) blur_seg<K7_VR, F_HP>(hm + (q * F_ROWS + r0) * F_HP + c, t, m[q]);
  float v = 0.0f;
#pragma unroll
  for (int j = 0; j < K7_VR; ++j) {
    const float mu1 = m[0][j], mu2 = m[1][j], e11 = m[2][j], e22 = m[3][j], e12 = m[4][j];
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu12 = mu1 * mu2;
    const float sj = ((2.0f * mu12 + C1) * (2.0f * (e12 - mu12) + C2)) /
                     ((mu1_sq + mu2_sq + C1) * ((e11 - mu1_sq) + (e22 - mu2_sq) + C2));
    if (ty0 + r0 + j < H && tx0 + c < W) v += sj;
  }

  // one partial per block; the block with the last ticket adds them all
  const int nb = gridDim.x * gridDim.y;
  const float s = block_sum(v, red);
  if (threadIdx.x == 0) {
    partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
  }
  __syncthreads();
  if (!last) return;
  float a = 0.0f;
  for (int i = threadIdx.x; i < nb; i += NT) a += __ldcg(partial + i);
  const float total = block_sum(a, red);
  if (threadIdx.x == 0) {
    *out = total / (float)((long long)H * W);
    *ticket = 0u;
  }
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS)
ssim_bwd_kernel(const float* __restrict__ img1, const float* __restrict__ img2, const Taps t,
                const float* __restrict__ gbar, float* __restrict__ d1, float* __restrict__ d2,
                int H, int W) {
  extern __shared__ float smem[];
  float* s1 = smem;
  float* s2 = s1 + B_ROWS * B_IP;
  float* hm = s2 + B_ROWS * B_IP;  // [5][B_ROWS][B_MP]
  float* dm = hm + B_HM;           // [4][B_MROWS][B_MP]
  float* ah = hm;                  // [4][B_MROWS][B_AP], once the moments are read

  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  load_pair<B_ROWS, B_COLS, B_IP>(img1, img2, H, W, ty0 - 2 * HALO, tx0 - 2 * HALO, s1, s2);
  __syncthreads();

  // moments on the tile plus a HALO ring: horizontal over B_ROWS x B_MCOLS
  for (int i = threadIdx.x; i < B_ROWS * (B_MCOLS / K8_HR); i += NT) {
    const int r = i % B_ROWS, c0 = (i / B_ROWS) * K8_HR;
    moment_row<K8_HR, B_ROWS * B_MP>(s1 + r * B_IP + c0, s2 + r * B_IP + c0, t,
                                     hm + r * B_MP + c0);
  }
  __syncthreads();

  // vertical over B_MROWS x B_MCOLS, then the four d-maps, zero outside the image
  const float g = gbar[0] / (float)((long long)H * W);
  for (int i = threadIdx.x; i < B_MCOLS * (B_MROWS / K8_VR); i += NT) {
    const int c = i % B_MCOLS, r0 = (i / B_MCOLS) * K8_VR;
    float m[5][K8_VR];
#pragma unroll
    for (int q = 0; q < 5; ++q) blur_seg<K8_VR, B_MP>(hm + (q * B_ROWS + r0) * B_MP + c, t, m[q]);
#pragma unroll
    for (int j = 0; j < K8_VR; ++j) {
      const float mu1 = m[0][j], mu2 = m[1][j], e11 = m[2][j], e22 = m[3][j], e12 = m[4][j];
      const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu12 = mu1 * mu2;
      const float A1 = 2.0f * mu12 + C1;
      const float A2 = 2.0f * (e12 - mu12) + C2;
      const float B1 = mu1_sq + mu2_sq + C1;
      const float B2 = (e11 - mu1_sq) + (e22 - mu2_sq) + C2;
      const float inv = 1.0f / (B1 * B2);
      const float ssim_v = A1 * A2 * inv;
      const float dA1 = A2 * inv, dA2 = A1 * inv;
      const float dB1 = -ssim_v / B1, dB2 = -ssim_v / B2;
      const int gy = ty0 - HALO + r0 + j, gx = tx0 - HALO + c;
      const float gm = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? g : 0.0f;
      float* o = dm + (r0 + j) * B_MP + c;
      o[0 * B_MROWS * B_MP] = gm * 2.0f * (mu2 * (dA1 - dA2) + mu1 * (dB1 - dB2));
      o[1 * B_MROWS * B_MP] = gm * 2.0f * (mu1 * (dA1 - dA2) + mu2 * (dB1 - dB2));
      o[2 * B_MROWS * B_MP] = gm * dB2;
      o[3 * B_MROWS * B_MP] = gm * 2.0f * dA2;
    }
  }
  __syncthreads();

  // adjoint blur (= the blur): horizontal over B_MROWS x TW
  for (int i = threadIdx.x; i < B_MROWS * (TW / K8_AHR); i += NT) {
    const int r = i % B_MROWS, c0 = (i / B_MROWS) * K8_AHR;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float o[K8_AHR];
      blur_seg<K8_AHR, 1>(dm + (p * B_MROWS + r) * B_MP + c0, t, o);
#pragma unroll
      store_run<K8_AHR>(ah + (p * B_MROWS + r) * B_AP + c0, o);
    }
  }
  __syncthreads();

  // vertical over TH x TW, combined with the images
  for (int i = threadIdx.x; i < TW * (TH / K8_AVR); i += NT) {
    const int c = i % TW, r0 = (i / TW) * K8_AVR;
    float a[4][K8_AVR];
#pragma unroll
    for (int p = 0; p < 4; ++p) blur_seg<K8_AVR, B_AP>(ah + (p * B_MROWS + r0) * B_AP + c, t, a[p]);
#pragma unroll
    for (int j = 0; j < K8_AVR; ++j) {
      const int gy = ty0 + r0 + j, gx = tx0 + c;
      if (gy < H && gx < W) {
        const int si = (r0 + j + 2 * HALO) * B_IP + c + 2 * HALO;
        const float x1 = s1[si], x2 = s2[si];
        const size_t o = (size_t)gy * W + gx;
        d1[o] = a[0][j] + 2.0f * x1 * a[2][j] + x2 * a[3][j];
        d2[o] = a[1][j] + 2.0f * x2 * a[2][j] + x1 * a[3][j];
      }
    }
  }
}

Taps taps_of(const float* w) {
  Taps t;
  for (int k = 0; k < WS; ++k) t.w[k] = w[k];
  return t;
}

dim3 grid_of(int H, int W) { return dim3((W + TW - 1) / TW, (H + TH - 1) / TH); }

}  // namespace

extern "C" {

const char* cg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Once per process and device, before the first launch on it: lets K7 and
// K8 take their dynamic shared memory (K8's is above the 48 KB default).
int ssim_prepare() {
  cudaError_t e = cudaFuncSetAttribute(ssim_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(ssim_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   B_SMEM);
}

// K7.  taps: the 11 float32 window taps in host memory; partial: one float
// per TW x TH tile; ticket: one unsigned counter on the device, 0 before
// the first call (each call leaves it at 0); out: the 0-dim mean.
int ssim_fwd(const void* img1, const void* img2, const float* taps, void* partial, void* ticket,
             void* out, int H, int W, void* stream) {
  ssim_fwd_kernel<<<grid_of(H, W), NT, F_SMEM, (cudaStream_t)stream>>>(
      (const float*)img1, (const float*)img2, taps_of(taps), (float*)partial,
      (unsigned*)ticket, (float*)out, H, W);
  return (int)cudaGetLastError();
}

// K8.  taps as K7's; gbar: the one-element upstream gradient on the device.
int ssim_bwd(const void* img1, const void* img2, const float* taps, const void* gbar, void* d1,
             void* d2, int H, int W, void* stream) {
  ssim_bwd_kernel<<<grid_of(H, W), NT, B_SMEM, (cudaStream_t)stream>>>(
      (const float*)img1, (const float*)img2, taps_of(taps), (const float*)gbar, (float*)d1,
      (float*)d2, H, W);
  return (int)cudaGetLastError();
}

// Launch shape of K7 (which = 0) or K8 (1) at [H, W], after ssim_prepare:
// blocks, threads per block, dynamic shared memory and the blocks resident
// per SM.
int ssim_launch_shape(int which, int H, int W, int* blocks, int* threads, int* smem,
                      int* per_sm) {
  const void* fn = which == 0 ? (const void*)ssim_fwd_kernel : (const void*)ssim_bwd_kernel;
  const dim3 g = grid_of(H, W);
  *blocks = (int)(g.x * g.y);
  *threads = NT;
  *smem = which == 0 ? F_SMEM : B_SMEM;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, NT, *smem);
}

}  // extern "C"
