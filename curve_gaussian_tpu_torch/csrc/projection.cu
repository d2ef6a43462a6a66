// Projection for Hopper (sm_90a): the per-Gaussian preprocessing of
// curve_gaussian_tpu_torch/ops/projection.py::preprocess_plain (the EWA
// projection of one 3D Gaussian to a 2D conic) and its gradient.  Plain C
// interface, loaded with ctypes by ops/projection.py.
//
// Replaces no Pallas kernel: the JAX package's projection
// (curve_gaussian_tpu/ops/projection.py::preprocess) is plain jnp, which
// XLA fuses into a few loops.  On the card the plain PyTorch version is
// ~200 small elementwise kernels and two float32 GEMMs forward and ~340
// autograd kernels backward, each reading and writing [P] columns.
//
// What bounds it: nothing of the card.  The work is one independent 3x3
// EWA projection per Gaussian, ~150 float operations over ~60 bytes in
// and ~40 bytes out (forward); at the step's 3,072-49,152 Gaussians a
// whole pass is a few microseconds at 3.35 TB/s.  The design keeps all of
// it in registers: one thread per Gaussian, every 3x3 product written out
// (no GEMM), the camera read once per thread from device memory (the same
// address across a warp, so one broadcast load each), and no value
// written to device memory but the outputs.  The backward recomputes the
// forward's intermediates from the same inputs (project) instead of
// saving them, and writes each gradient once: no atomics, so the same
// inputs give the same bits on every launch.
//
// The forward is the plain version's arithmetic, formula for formula and
// in its order of operations: built with -fmad=false, every product and
// sum rounds on its own as the plain version's separate elementwise
// kernels do, and the products of the means with the camera's rows round
// as the plain version's float32 GEMMs and GEMVs do on the H100 (gemm_row,
// gemv_row: cuBLAS's orders of fused multiply-adds, measured there).  So
// the forward gives the plain version's bits: a thin Gaussian's
// covariance, nearly singular before the +0.3 dilation, would carry one
// ulp of the view-space mean into ~1e-5 of its conic.  The orders were
// measured with torch 2.11.0+cu128 and cuBLAS 12.9.2, every output equal
// at 500 to 200,000 Gaussians; they are cuBLAS's choice, not documented,
// so another cuBLAS, or a size at which it picks another kernel, can move
// the plain version by an ulp, and the card test shows it.  The backward sums
// in its own order, within float32 rounding of autograd's.  Gradient rules
// kept from the plain version's autograd: clip's JAX rule in the
// 1.3 tanfov clamp (half the gradient at a tie), torch.clamp's in the
// antialiasing clamp (all of it at the bound), and nothing through the
// radius, the extent or the validity, which feed only the binning.
//
// The camera comes from device memory (world_to_cam, full_proj, and the
// intrinsics (fx, fy, 1.3 tanfovx, 1.3 tanfovy) when the caller has them
// as a tensor), so a step captured in a CUDA graph reads each view's rows
// of the device stacks; without the tensor the intrinsics are launch
// arguments.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;

constexpr float NEAR_CULL_Z = 0.2f;
constexpr float H_VAR = 0.3f;
constexpr float AA_MIN = 2.5e-5f;
constexpr float LAM_MIN = 0.1f;

// torch.clamp(x, min=lo): NaN stays NaN
__host__ __device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// min(max(x, lo), hi) as torch.minimum(torch.maximum(x, lo), hi): NaN stays NaN
__host__ __device__ __forceinline__ float clip(float x, float lo, float hi) {
  const float a = x < lo ? lo : x;
  return a > hi ? hi : a;
}

// the gradient of clip at x: JAX's rule, each bound passes half at a tie
__host__ __device__ __forceinline__ float clip_grad(float x, float lo, float hi, float g) {
  const float a = x < lo ? lo : x;
  float ga = a == hi ? g * 0.5f : g;
  if (a > hi) ga = 0.0f;
  float gx = x == lo ? ga * 0.5f : ga;
  if (x < lo) gx = 0.0f;
  return gx;
}

// m . w[0:3] + w[3] as PyTorch's float32 [P,3] x [3,3] GEMM and then the
// bias add round it: cuBLAS chains fused multiply-adds in k order
__host__ __device__ __forceinline__ float gemm_row(const float m[3], const float* w) {
  return fmaf(m[2], w[2], fmaf(m[1], w[1], m[0] * w[0])) + w[3];
}

// the same as PyTorch's float32 [P,3] x [3] GEMV and then the bias add
// round it: cuBLAS fuses m0 w0 into m1 w1 and adds the rounded m2 w2
__host__ __device__ __forceinline__ float gemv_row(const float m[3], const float* w) {
  return m[2] * w[2] + fmaf(m[1], w[1], m[0] * w[0]) + w[3];
}

struct Camera {
  float V[12];  // world_to_cam, rows 0-2
  float P[16];  // full_proj
  float fx, fy, limx, limy;
};

// The forward's intermediates of one Gaussian.
struct Proj {
  float hom0, hom1, inv_w, ndc0, ndc1, depth;  // screen position, depth
  float tv0, tv1, tz, ux, uy, cx, cy, tx, ty;  // view-space mean, clamped
  float inv_z, inv_z2, j00, j02, j11, j12;     // the Jacobian's entries
  float t0[3], t1[3];                          // its rows times W: J W
  float r[9];                                  // R(q), row-major
  float s[3];                                  // modifier * scale
  float a[3], b[3];                            // (T0 R)_k, (T1 R)_k
  float u[3], v[3];                            // a_k s_k, b_k s_k
  float c0, c1, c2;                            // cov2d before the dilation
  float det_raw, cxx, cyy, cxy, det, ratio, comp, det_inv;
};

// preprocess_plain's formulas for one Gaussian: mean m, scale sc, quat q
// (w, x, y, z); aa turns on the antialiasing compensation
__host__ __device__ __forceinline__ void project(const float m[3], const float sc[3],
                                                 const float q[4], float mod, bool aa,
                                                 const Camera& c, Proj& p) {
  const float* V = c.V;
  const float* P = c.P;
  p.hom0 = gemm_row(m, P);
  p.hom1 = gemm_row(m, P + 4);
  const float w = gemv_row(m, P + 12);
  p.inv_w = 1.0f / (w + 1e-7f);
  p.ndc0 = p.hom0 * p.inv_w;
  p.ndc1 = p.hom1 * p.inv_w;
  p.depth = gemv_row(m, V + 8);

  p.tv0 = gemm_row(m, V);
  p.tv1 = gemm_row(m, V + 4);
  p.tz = gemm_row(m, V + 8);
  p.ux = p.tv0 / p.tz;
  p.uy = p.tv1 / p.tz;
  p.cx = clip(p.ux, -c.limx, c.limx);
  p.cy = clip(p.uy, -c.limy, c.limy);
  p.tx = p.cx * p.tz;
  p.ty = p.cy * p.tz;
  p.inv_z = 1.0f / p.tz;
  p.inv_z2 = p.inv_z * p.inv_z;
  p.j00 = c.fx * p.inv_z;
  p.j02 = -c.fx * p.tx * p.inv_z2;
  p.j11 = c.fy * p.inv_z;
  p.j12 = -c.fy * p.ty * p.inv_z2;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p.t0[i] = p.j00 * V[i] + p.j02 * V[8 + i];
    p.t1[i] = p.j11 * V[4 + i] + p.j12 * V[8 + i];
  }

  const float qw = q[0], x = q[1], y = q[2], z = q[3];
  p.r[0] = 1.0f - 2.0f * (y * y + z * z);
  p.r[1] = 2.0f * (x * y - qw * z);
  p.r[2] = 2.0f * (x * z + qw * y);
  p.r[3] = 2.0f * (x * y + qw * z);
  p.r[4] = 1.0f - 2.0f * (x * x + z * z);
  p.r[5] = 2.0f * (y * z - qw * x);
  p.r[6] = 2.0f * (x * z - qw * y);
  p.r[7] = 2.0f * (y * z + qw * x);
  p.r[8] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.s[k] = mod * sc[k];
    p.a[k] = p.t0[0] * p.r[k] + p.t0[1] * p.r[3 + k] + p.t0[2] * p.r[6 + k];
    p.b[k] = p.t1[0] * p.r[k] + p.t1[1] * p.r[3 + k] + p.t1[2] * p.r[6 + k];
    p.u[k] = p.a[k] * p.s[k];
    p.v[k] = p.b[k] * p.s[k];
  }
  p.c0 = p.u[0] * p.u[0] + p.u[1] * p.u[1] + p.u[2] * p.u[2];
  p.c1 = p.u[0] * p.v[0] + p.u[1] * p.v[1] + p.u[2] * p.v[2];
  p.c2 = p.v[0] * p.v[0] + p.v[1] * p.v[1] + p.v[2] * p.v[2];

  p.det_raw = p.c0 * p.c2 - p.c1 * p.c1;
  p.cxx = p.c0 + H_VAR;
  p.cyy = p.c2 + H_VAR;
  p.cxy = p.c1;
  p.det = p.cxx * p.cyy - p.cxy * p.cxy;
  p.ratio = aa ? p.det_raw / p.det : 1.0f;
  p.comp = aa ? sqrtf(clamp_min(p.ratio, AA_MIN)) : 1.0f;
  p.det_inv = 1.0f / p.det;
}

struct Grads {
  float m[3], sc[3], q[4], o;
};

// The gradient of one Gaussian's (mean2d, conic, depth, opacity) at
// cotangents (gmx, gmy), (ga, gb, gc), gd, go; p from project
__host__ __device__ __forceinline__ void project_grad(const float q[4], float o, float mod,
                                                      bool aa, const Camera& c, const Proj& p,
                                                      float H, float W, float gmx, float gmy,
                                                      float ga, float gb, float gc, float gd,
                                                      float go, Grads& g) {
  const float* V = c.V;
  const float* P = c.P;
  // mean2d = ((ndc + 1) size - 1) / 2, ndc = hom / (w + 1e-7)
  const float gn0 = gmx * 0.5f * W;
  const float gn1 = gmy * 0.5f * H;
  const float gh0 = gn0 * p.inv_w;
  const float gh1 = gn1 * p.inv_w;
  const float giw = gn0 * p.hom0 + gn1 * p.hom1;
  const float gw = -giw * (p.inv_w * p.inv_w);

  // opacity * compensation; conic = (cyy, -cxy, cxx) / det
  g.o = go * p.comp;
  float gcxx = gc * p.det_inv;
  float gcyy = ga * p.det_inv;
  float gcxy = -(gb * p.det_inv);
  const float gdi = ga * p.cyy + gb * -p.cxy + gc * p.cxx;
  float gdet = -gdi * (p.det_inv * p.det_inv);
  float gc0 = 0.0f, gc1 = 0.0f, gc2 = 0.0f;
  if (aa) {  // compensation = sqrt(clamp(det_raw / det, min=2.5e-5))
    const float gcl = go * o / (2.0f * p.comp);
    const float gr = p.ratio >= AA_MIN ? gcl : 0.0f;
    const float gdr = gr / p.det;
    gdet += -gr * p.det_raw / (p.det * p.det);
    gc0 = gdr * p.c2;
    gc2 = gdr * p.c0;
    gc1 = -gdr * (2.0f * p.c1);
  }
  // det = cxx cyy - cxy^2, cxx = c0 + 0.3, cyy = c2 + 0.3, cxy = c1
  gcxx += gdet * p.cyy;
  gcyy += gdet * p.cxx;
  gcxy += -gdet * p.cxy * 2.0f;
  gc0 += gcxx;
  gc1 += gcxy;
  gc2 += gcyy;

  // c0 = u.u, c1 = u.v, c2 = v.v; u_k = a_k s_k, v_k = b_k s_k
  float gA[3], gB[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float gu = 2.0f * gc0 * p.u[k] + gc1 * p.v[k];
    const float gv = gc1 * p.u[k] + 2.0f * gc2 * p.v[k];
    g.sc[k] = (gu * p.a[k] + gv * p.b[k]) * mod;
    gA[k] = gu * p.s[k];
    gB[k] = gv * p.s[k];
  }
  // a_k = sum_j t0_j r_jk, b_k = sum_j t1_j r_jk
  float gr[9], gt0[3], gt1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gt0[j] = gA[0] * p.r[3 * j] + gA[1] * p.r[3 * j + 1] + gA[2] * p.r[3 * j + 2];
    gt1[j] = gB[0] * p.r[3 * j] + gB[1] * p.r[3 * j + 1] + gB[2] * p.r[3 * j + 2];
#pragma unroll
    for (int k = 0; k < 3; ++k) gr[3 * j + k] = gA[k] * p.t0[j] + gB[k] * p.t1[j];
  }
  // R(q)
  const float qw = q[0], x = q[1], y = q[2], z = q[3];
  g.q[0] = 2.0f * (-z * gr[1] + y * gr[2] + z * gr[3] - x * gr[5] - y * gr[6] + x * gr[7]);
  g.q[1] = 2.0f * (y * gr[1] + z * gr[2] + y * gr[3] - 2.0f * x * gr[4] - qw * gr[5] +
                   z * gr[6] + qw * gr[7] - 2.0f * x * gr[8]);
  g.q[2] = 2.0f * (-2.0f * y * gr[0] + x * gr[1] + qw * gr[2] + x * gr[3] + z * gr[5] -
                   qw * gr[6] + z * gr[7] - 2.0f * y * gr[8]);
  g.q[3] = 2.0f * (-2.0f * z * gr[0] - qw * gr[1] + x * gr[2] + qw * gr[3] - 2.0f * z * gr[4] +
                   y * gr[5] + x * gr[6] + y * gr[7]);

  // t0_i = j00 V0i + j02 V2i, t1_i = j11 V1i + j12 V2i
  const float gj00 = gt0[0] * V[0] + gt0[1] * V[1] + gt0[2] * V[2];
  const float gj02 = gt0[0] * V[8] + gt0[1] * V[9] + gt0[2] * V[10];
  const float gj11 = gt1[0] * V[4] + gt1[1] * V[5] + gt1[2] * V[6];
  const float gj12 = gt1[0] * V[8] + gt1[1] * V[9] + gt1[2] * V[10];
  // j00 = fx / z, j02 = -fx tx / z^2 (j11, j12 alike)
  const float ginvz2 = gj02 * (-c.fx * p.tx) + gj12 * (-c.fy * p.ty);
  const float gtx = gj02 * p.inv_z2 * -c.fx;
  const float gty = gj12 * p.inv_z2 * -c.fy;
  const float ginvz = gj00 * c.fx + gj11 * c.fy + 2.0f * p.inv_z * ginvz2;
  float gtz = -ginvz * (p.inv_z * p.inv_z);
  // tx = clip(tv0 / tz) tz (ty alike)
  gtz += gtx * p.cx + gty * p.cy;
  const float gux = clip_grad(p.ux, -c.limx, c.limx, gtx * p.tz);
  const float guy = clip_grad(p.uy, -c.limy, c.limy, gty * p.tz);
  const float gtv0 = gux / p.tz;
  const float gtv1 = guy / p.tz;
  gtz += -gux * p.tv0 / (p.tz * p.tz) + -guy * p.tv1 / (p.tz * p.tz);
  // the depth is the view-space z too, by another rounding
  gtz += gd;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    g.m[j] = gh0 * P[j] + gh1 * P[4 + j] + gw * P[12 + j] + gtv0 * V[j] + gtv1 * V[4 + j] +
             gtz * V[8 + j];
}

__device__ __forceinline__ Camera load_camera(const float* __restrict__ w2c,
                                              const float* __restrict__ proj,
                                              const float* __restrict__ intr, float fx, float fy,
                                              float limx, float limy) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 12; ++i) c.V[i] = w2c[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) c.P[i] = proj[i];
  if (intr != nullptr) {
    fx = intr[0];
    fy = intr[1];
    limx = intr[2];
    limy = intr[3];
  }
  c.fx = fx;
  c.fy = fy;
  c.limx = limx;
  c.limy = limy;
  return c;
}

__device__ __forceinline__ void load_gaussian(const float* __restrict__ mean3d,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ quat, int i, float m[3],
                                              float sc[3], float q[4]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m[k] = mean3d[3 * i + k];
    sc[k] = scale[3 * i + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = quat[4 * i + k];
}

// One thread per Gaussian: every output of Preprocessed.  alive may be null.
__global__ void __launch_bounds__(NT) project_fwd_kernel(
    const float* __restrict__ mean3d, const float* __restrict__ scale,
    const float* __restrict__ quat, const float* __restrict__ opacity,
    const unsigned char* __restrict__ alive, const float* __restrict__ w2c,
    const float* __restrict__ proj, const float* __restrict__ intr, float fx, float fy,
    float limx, float limy, float mod, int P, int H, int W, bool aa, float* __restrict__ mean2d,
    float* __restrict__ conic, float* __restrict__ depth, float* __restrict__ opa_eff,
    int* __restrict__ radius, float* __restrict__ extent, unsigned char* __restrict__ valid) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= P) return;
  const Camera c = load_camera(w2c, proj, intr, fx, fy, limx, limy);
  float m[3], sc[3], q[4];
  load_gaussian(mean3d, scale, quat, i, m, sc, q);
  Proj p;
  project(m, sc, q, mod, aa, c, p);

  const float mid = 0.5f * (p.cxx + p.cyy);
  const float lam_max = mid + sqrtf(clamp_min(mid * mid - p.det, LAM_MIN));
  const float radius_f = ceilf(3.0f * sqrtf(lam_max));
  const float op = opacity[i] * p.comp;
  // per-axis reach of the exact alpha >= 1/255 support ellipse
  const float reach = sqrtf(2.0f * clamp_min(logf(clamp_min(op, 1e-12f) * 255.0f), 0.0f));
  bool ok = p.depth > NEAR_CULL_Z && p.det > 0.0f && radius_f > 0.0f;
  if (alive != nullptr) ok = ok && alive[i] != 0;

  mean2d[2 * i] = ((p.ndc0 + 1.0f) * (float)W - 1.0f) * 0.5f;
  mean2d[2 * i + 1] = ((p.ndc1 + 1.0f) * (float)H - 1.0f) * 0.5f;
  conic[3 * i] = p.cyy * p.det_inv;
  conic[3 * i + 1] = -p.cxy * p.det_inv;
  conic[3 * i + 2] = p.cxx * p.det_inv;
  depth[i] = p.depth;
  opa_eff[i] = op;
  radius[i] = ok ? (int)radius_f : 0;
  extent[2 * i] = reach * sqrtf(clamp_min(p.cxx, 0.0f));
  extent[2 * i + 1] = reach * sqrtf(clamp_min(p.cyy, 0.0f));
  valid[i] = ok ? 1 : 0;
}

// One thread per Gaussian: the gradients of mean3d, scale, quat and
// opacity from the cotangents of mean2d [P,2], conic [P,3], depth [P] and
// opacity [P].  A null cotangent reads zero; a null output is not written.
__global__ void __launch_bounds__(NT) project_bwd_kernel(
    const float* __restrict__ mean3d, const float* __restrict__ scale,
    const float* __restrict__ quat, const float* __restrict__ opacity,
    const float* __restrict__ w2c, const float* __restrict__ proj,
    const float* __restrict__ intr, float fx, float fy, float limx, float limy, float mod, int P,
    int H, int W, bool aa, const float* __restrict__ g_mean2d, const float* __restrict__ g_conic,
    const float* __restrict__ g_depth, const float* __restrict__ g_opa,
    float* __restrict__ d_mean3d, float* __restrict__ d_scale, float* __restrict__ d_quat,
    float* __restrict__ d_opacity) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= P) return;
  const Camera c = load_camera(w2c, proj, intr, fx, fy, limx, limy);
  float m[3], sc[3], q[4];
  load_gaussian(mean3d, scale, quat, i, m, sc, q);
  Proj p;
  project(m, sc, q, mod, aa, c, p);

  const float gmx = g_mean2d ? g_mean2d[2 * i] : 0.0f;
  const float gmy = g_mean2d ? g_mean2d[2 * i + 1] : 0.0f;
  const float ga = g_conic ? g_conic[3 * i] : 0.0f;
  const float gb = g_conic ? g_conic[3 * i + 1] : 0.0f;
  const float gc = g_conic ? g_conic[3 * i + 2] : 0.0f;
  const float gd = g_depth ? g_depth[i] : 0.0f;
  const float go = g_opa ? g_opa[i] : 0.0f;
  Grads g;
  project_grad(q, opacity[i], mod, aa, c, p, (float)H, (float)W, gmx, gmy, ga, gb, gc, gd, go,
               g);
  if (d_mean3d) {
#pragma unroll
    for (int k = 0; k < 3; ++k) d_mean3d[3 * i + k] = g.m[k];
  }
  if (d_scale) {
#pragma unroll
    for (int k = 0; k < 3; ++k) d_scale[3 * i + k] = g.sc[k];
  }
  if (d_quat) {
#pragma unroll
    for (int k = 0; k < 4; ++k) d_quat[4 * i + k] = g.q[k];
  }
  if (d_opacity) d_opacity[i] = g.o;
}

}  // namespace

extern "C" {

const char* cg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Every output of Preprocessed for P Gaussians: mean2d [P,2], conic [P,3],
// depth [P], opacity [P], radius [P] int32, extent [P,2], valid [P] bool.
// intr [4] (fx, fy, 1.3 tanfovx, 1.3 tanfovy) or null: then the four
// float arguments; alive [P] bool or null.
int project_fwd(const void* mean3d, const void* scale, const void* quat, const void* opacity,
                const void* alive, const void* w2c, const void* proj, const void* intr,
                float fx, float fy, float limx, float limy, float mod, int P, int H, int W,
                int aa, void* mean2d, void* conic, void* depth, void* opa_eff, void* radius,
                void* extent, void* valid, void* stream) {
  if (P == 0) return 0;
  project_fwd_kernel<<<(P + NT - 1) / NT, NT, 0, (cudaStream_t)stream>>>(
      (const float*)mean3d, (const float*)scale, (const float*)quat, (const float*)opacity,
      (const unsigned char*)alive, (const float*)w2c, (const float*)proj, (const float*)intr,
      fx, fy, limx, limy, mod, P, H, W, aa != 0, (float*)mean2d, (float*)conic, (float*)depth,
      (float*)opa_eff, (int*)radius, (float*)extent, (unsigned char*)valid);
  return (int)cudaGetLastError();
}

// d mean3d [P,3], d scale [P,3], d quat [P,4], d opacity [P] (each may be
// null) from the cotangents of mean2d, conic, depth, opacity (each may be
// null: zero)
int project_bwd(const void* mean3d, const void* scale, const void* quat, const void* opacity,
                const void* w2c, const void* proj, const void* intr, float fx, float fy,
                float limx, float limy, float mod, int P, int H, int W, int aa,
                const void* g_mean2d, const void* g_conic, const void* g_depth,
                const void* g_opa, void* d_mean3d, void* d_scale, void* d_quat, void* d_opacity,
                void* stream) {
  if (P == 0) return 0;
  project_bwd_kernel<<<(P + NT - 1) / NT, NT, 0, (cudaStream_t)stream>>>(
      (const float*)mean3d, (const float*)scale, (const float*)quat, (const float*)opacity,
      (const float*)w2c, (const float*)proj, (const float*)intr, fx, fy, limx, limy, mod, P, H,
      W, aa != 0, (const float*)g_mean2d, (const float*)g_conic, (const float*)g_depth,
      (const float*)g_opa, (float*)d_mean3d, (float*)d_scale, (float*)d_quat,
      (float*)d_opacity);
  return (int)cudaGetLastError();
}

}  // extern "C"
