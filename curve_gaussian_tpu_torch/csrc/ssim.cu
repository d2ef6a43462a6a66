// Fused single-channel SSIM for Hopper (sm_90a): value (K7) and input
// gradients (K8).  Plain C interface, loaded with ctypes by
// curve_gaussian_tpu_torch/ops/ssim_cuda.py.
//
// Replaces the Pallas kernels of curve_gaussian_tpu/ops/ssim_pallas.py:
//   K7  _fwd_kernel: five moment maps (x, y, x^2, y^2, xy), separable 11-tap
//       sigma-1.5 blur with exact 'same' zero padding, SSIM map, masked sum
//   K8  _bwd_kernel: moments recomputed on a halo tile, the four
//       d(mean SSIM)/d(moment) maps, the adjoint blur (the same blur: the
//       window is symmetric), combined into dimg1 and dimg2
// The TPU version blurs with band matrices on the matrix unit over 128-row
// slabs; here each block owns a 16x16 output tile and blurs by direct
// 11-tap sums in shared memory.
//
// What bounds them: about 250 (K7) and 450 (K8) float operations per pixel
// against 8 (K7) and 16 (K8) bytes of device memory per pixel, so instruction throughput
// in shared memory, not bytes.  The design reads every image pixel from
// device memory once per block (with its halo), keeps all intermediates in
// shared memory, and blurs separably (22 taps per map instead of 121).
// K7 writes one partial sum per block (no atomics: the wrapper reduces
// them), so the value is the same from run to run.
//
// Built with -fmad=false so that the arithmetic rounds like the plain
// PyTorch version's separate elementwise operations.

#include <cuda_runtime.h>

namespace {

constexpr int TS = 16;             // output tile edge
constexpr int HALO = 5;            // window_size / 2
constexpr int WS = 2 * HALO + 1;   // window taps
constexpr int MID = TS + 2 * HALO; // 26: tile plus one halo
constexpr int IN2 = TS + 4 * HALO; // 36: tile plus two halos (K8 input)
constexpr int NT = TS * TS;        // 256 threads
constexpr float C1 = 1e-4f;        // 0.01^2
constexpr float C2 = 9e-4f;        // 0.03^2

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

// Load a square of `n` x `n` pixels at (y0, x0) of both images into shared
// memory, zero outside the image.
template <int N>
__device__ __forceinline__ void load_pair(const float* img1, const float* img2, int H, int W,
                                          int y0, int x0, float (*s1)[N + 1], float (*s2)[N + 1]) {
  for (int i = threadIdx.x; i < N * N; i += NT) {
    const int r = i / N, c = i % N;
    const int gy = y0 + r, gx = x0 + c;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t o = (size_t)gy * W + gx;
    s1[r][c] = in ? img1[o] : 0.0f;
    s2[r][c] = in ? img2[o] : 0.0f;
  }
}

__global__ void __launch_bounds__(NT)
ssim_fwd_kernel(const float* __restrict__ img1, const float* __restrict__ img2,
                const float* __restrict__ win, float* __restrict__ partial, int H, int W) {
  __shared__ float s1[MID][MID + 1], s2[MID][MID + 1];
  __shared__ float hb[5][MID][TS];
  __shared__ float w[WS];
  __shared__ float red[NT / 32];

  const int ty0 = blockIdx.y * TS, tx0 = blockIdx.x * TS;
  if (threadIdx.x < WS) w[threadIdx.x] = win[threadIdx.x];
  load_pair<MID>(img1, img2, H, W, ty0 - HALO, tx0 - HALO, s1, s2);
  __syncthreads();

  // horizontal pass over all MID rows, TS output columns
  for (int i = threadIdx.x; i < MID * TS; i += NT) {
    const int r = i / TS, c = i % TS;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
#pragma unroll
    for (int k = 0; k < WS; ++k) {
      const float x = s1[r][c + k], y = s2[r][c + k], wk = w[k];
      a0 += wk * x;
      a1 += wk * y;
      a2 += wk * (x * x);
      a3 += wk * (y * y);
      a4 += wk * (x * y);
    }
    hb[0][r][c] = a0; hb[1][r][c] = a1; hb[2][r][c] = a2; hb[3][r][c] = a3; hb[4][r][c] = a4;
  }
  __syncthreads();

  const int r = threadIdx.x / TS, c = threadIdx.x % TS;
  float m[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < WS; ++k) a += w[k] * hb[q][r + k][c];
    m[q] = a;
  }
  const float mu1 = m[0], mu2 = m[1], e11 = m[2], e22 = m[3], e12 = m[4];
  const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu12 = mu1 * mu2;
  float v = ((2.0f * mu12 + C1) * (2.0f * (e12 - mu12) + C2)) /
            ((mu1_sq + mu2_sq + C1) * ((e11 - mu1_sq) + (e22 - mu2_sq) + C2));
  if (ty0 + r >= H || tx0 + c >= W) v = 0.0f;
  const float s = block_sum(v, red);
  if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

__global__ void __launch_bounds__(NT)
ssim_bwd_kernel(const float* __restrict__ img1, const float* __restrict__ img2,
                const float* __restrict__ win, const float* __restrict__ gbar,
                float* __restrict__ d1, float* __restrict__ d2, int H, int W) {
  __shared__ float s1[IN2][IN2 + 1], s2[IN2][IN2 + 1];
  __shared__ float hb[5 * IN2 * MID];  // horizontal moments, then the adjoint's
  __shared__ float dm[4][MID][MID + 1];
  __shared__ float w[WS];

  const int ty0 = blockIdx.y * TS, tx0 = blockIdx.x * TS;
  if (threadIdx.x < WS) w[threadIdx.x] = win[threadIdx.x];
  load_pair<IN2>(img1, img2, H, W, ty0 - 2 * HALO, tx0 - 2 * HALO, s1, s2);
  __syncthreads();

  // moments on the tile plus a HALO ring: horizontal over IN2 rows x MID cols
  auto H5 = reinterpret_cast<float(*)[IN2][MID]>(hb);
  for (int i = threadIdx.x; i < IN2 * MID; i += NT) {
    const int r = i / MID, c = i % MID;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
#pragma unroll
    for (int k = 0; k < WS; ++k) {
      const float x = s1[r][c + k], y = s2[r][c + k], wk = w[k];
      a0 += wk * x;
      a1 += wk * y;
      a2 += wk * (x * x);
      a3 += wk * (y * y);
      a4 += wk * (x * y);
    }
    H5[0][r][c] = a0; H5[1][r][c] = a1; H5[2][r][c] = a2; H5[3][r][c] = a3; H5[4][r][c] = a4;
  }
  __syncthreads();

  const float g = gbar[0] / (float)((long long)H * W);
  for (int i = threadIdx.x; i < MID * MID; i += NT) {
    const int r = i / MID, c = i % MID;
    float m[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < WS; ++k) a += w[k] * H5[q][r + k][c];
      m[q] = a;
    }
    const float mu1 = m[0], mu2 = m[1], e11 = m[2], e22 = m[3], e12 = m[4];
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu12 = mu1 * mu2;
    const float A1 = 2.0f * mu12 + C1;
    const float A2 = 2.0f * (e12 - mu12) + C2;
    const float B1 = mu1_sq + mu2_sq + C1;
    const float B2 = (e11 - mu1_sq) + (e22 - mu2_sq) + C2;
    const float inv = 1.0f / (B1 * B2);
    const float ssim_v = A1 * A2 * inv;
    const float dA1 = A2 * inv, dA2 = A1 * inv;
    const float dB1 = -ssim_v / B1, dB2 = -ssim_v / B2;
    const int gy = ty0 - HALO + r, gx = tx0 - HALO + c;
    const float gm = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? g : 0.0f;
    dm[0][r][c] = gm * 2.0f * (mu2 * (dA1 - dA2) + mu1 * (dB1 - dB2));
    dm[1][r][c] = gm * 2.0f * (mu1 * (dA1 - dA2) + mu2 * (dB1 - dB2));
    dm[2][r][c] = gm * dB2;
    dm[3][r][c] = gm * 2.0f * dA2;
  }
  __syncthreads();

  // adjoint blur (= the blur): horizontal over MID rows x TS cols
  auto H4 = reinterpret_cast<float(*)[MID][TS]>(hb);
  for (int i = threadIdx.x; i < MID * TS; i += NT) {
    const int r = i / TS, c = i % TS;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < WS; ++k) a += w[k] * dm[q][r][c + k];
      H4[q][r][c] = a;
    }
  }
  __syncthreads();

  const int r = threadIdx.x / TS, c = threadIdx.x % TS;
  float a[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WS; ++k) s += w[k] * H4[q][r + k][c];
    a[q] = s;
  }
  const int gy = ty0 + r, gx = tx0 + c;
  if (gy < H && gx < W) {
    const float x1 = s1[r + 2 * HALO][c + 2 * HALO], x2 = s2[r + 2 * HALO][c + 2 * HALO];
    const size_t o = (size_t)gy * W + gx;
    d1[o] = a[0] + 2.0f * x1 * a[2] + x2 * a[3];
    d2[o] = a[1] + 2.0f * x2 * a[2] + x1 * a[3];
  }
}

}  // namespace

extern "C" {

const char* cg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ssim_fwd(const void* img1, const void* img2, const void* win, void* partial, int H, int W,
             void* stream) {
  const dim3 grid((W + TS - 1) / TS, (H + TS - 1) / TS);
  ssim_fwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)img1, (const float*)img2, (const float*)win, (float*)partial, H, W);
  return (int)cudaGetLastError();
}

int ssim_bwd(const void* img1, const void* img2, const void* win, const void* gbar, void* d1,
             void* d2, int H, int W, void* stream) {
  const dim3 grid((W + TS - 1) / TS, (H + TS - 1) / TS);
  ssim_bwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)img1, (const float*)img2, (const float*)win, (const float*)gbar,
      (float*)d1, (float*)d2, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
