// Tile binning for Hopper (sm_90a): the `sort` method of
// curve_gaussian_tpu_torch/ops/binning.py::bin_gaussians_plain with the
// packed key, in five kernels.  Plain C interface, loaded with ctypes by
// ops/binning_cuda.py.
//
// Replaces no Pallas kernel: the JAX package's binning
// (curve_gaussian_tpu/ops/binning.py::_bin_sort) is plain jnp, which XLA
// fuses into a few loops around its sort.  On the card the plain PyTorch
// version is ~340 small kernels a view (the rect fields, the pairs and
// their alpha cull over [R, P] columns, the big tier's stable sort and
// gathers, the packed key's sort, searchsorted, the [T, K] gathers, the
// slots table's scatter), whatever the number of Gaussians.
//
// What bounds it: nothing of the card.  The work is ~20 integer and ~60
// float operations a pair over ~15,000-200,000 pairs, of which ~30% are
// candidates, and a [T, K] table of 5 bytes an entry (~3 MB at 800x800, K
// 896); at 3.35 TB/s that is a few microseconds.  A first design kept the
// plain version's sort of every pair's packed key (torch.sort between two
// launches): at 199,680 pairs it took 0.093 of the chain's 0.116 ms (8
// radix passes over 64-bit keys and their int64 permutation, ~15 kernels)
// on an H100.  But only a tile's own candidates need an order: this design
// buckets the candidates by tile and sorts each bucket in shared memory.
//   bin_tier1_kernel    one thread per Gaussian: the rect fields, the
//                       packed keys of its tier-1 rect slots with the exact
//                       alpha cull; per block the number of big Gaussians
//                       and the rect overflow; zeroes the tile counters;
//   bin_big_kernel      one thread per Gaussian or big-tier column: each
//                       block scans the per-block big counts, so a big
//                       Gaussian knows its column in index order (the plain
//                       version's stable sort) and writes the keys of its
//                       slots [tier1, max_rect) there; each Gaussian counts
//                       its candidates into their tiles (integer atomics,
//                       one for the lanes of a warp that share a tile);
//                       per block the big-tier overflow;
//   bin_scan_kernel     one block: each tile's start (an exclusive scan of
//                       the counts), its count clamped to K, the peak and
//                       every overflow;
//   bin_scatter_kernel  one thread per pair: each candidate's key into its
//                       tile's bucket, at a place an atomic hands out (one
//                       for the lanes of a warp that share a tile);
//   bin_tile_kernel     one block per tile: sorts its bucket in shared
//                       memory (bitonic, CHUNK keys at a time, the stages
//                       between lanes of a warp by shuffles; a bucket of
//                       several chunks ranks each key by binary search in
//                       the other sorted chunks), then writes its row of
//                       the [T, K] table and its candidates' slots.
// The places the atomics hand out differ from launch to launch, but a
// candidate's key is unique (a Gaussian is once in a tile), so each
// bucket's sorted order, and every output, is the same on every launch.
// Every output is written in full, once, with no memset.  The key is the
// plain version's packed key, ([tile | depth bits >> tbits] << 31) |
// index, with the index shifted up to carry the pair's rect slot r in the
// low rbits bits: r does not change the order (the index is unique in a
// tile) and tells the tile kernel where the pair's slot row goes.
//
// The cull is the plain version's arithmetic on the card, operation for
// operation: built with -fmad=false every product and sum rounds on its
// own, as PyTorch's separate elementwise kernels do; division by a tensor
// is IEEE division; division of a tensor by a Python number is, in
// PyTorch's CUDA kernels, a product with the number's reciprocal taken in
// double and rounded to float32 (so ln(opacity / ALPHA_EPS) multiplies by
// 255.0f: measured on the H100 with torch 2.11.0+cu128, equal on 4,194,304
// opacities, where a true division by (float)ALPHA_EPS differs in 74% of
// them); logf is the one PyTorch's torch.log calls; minimum and maximum
// propagate NaN as torch.minimum and torch.maximum do; float-to-int
// conversion is the C cast, as PyTorch's.  So the candidates, the keys,
// and everything after them, equal the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads of the per-Gaussian and per-pair kernels
constexpr int NT_SCAN = 1024;  // threads of the one block that scans and sums
constexpr int NT_TILE = 256;   // threads of a tile's block
constexpr int CHUNK = 4096;    // keys a tile's block sorts at once in shared memory (32 KB)

// torch.maximum / torch.minimum on float: the first NaN wins
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp(x, lo, hi) on float: NaN stays NaN
__device__ __forceinline__ float tclamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ int iclamp(int x, int lo, int hi) { return min(max(x, lo), hi); }
// torch.div(a, b, rounding_mode="floor") on int32
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return ((a < 0) != (b < 0)) && q * b != a ? q - 1 : q;
}
// _floor_i32: clamp the floor in float first, then convert
__device__ __forceinline__ int floor_i32(float x, int lo, int hi) {
  return (int)tclamp(floorf(x), (float)(lo - 1), (float)(hi + 1));
}

struct Grid {
  int ntx, nty, T, max_rect, tier1, tbits, rbits;
  float inv_tw, inv_th;  // (float)(1 / TILE_W), (float)(1 / TILE_H): PyTorch's "/ TILE_W"
  int tw, th;
  float inv_alpha;  // (float)(1 / ALPHA_EPS), PyTorch's factor for "/ ALPHA_EPS"
};

struct Gauss {
  float mx, my, ca, cb, cc, depth, log_ratio;
  bool valid;
  int x0t, y0t, y1t, rw_c, rh_c, y0c, area;
};

// _rect_fields and ln(opa / ALPHA_EPS) of Gaussian p
__device__ Gauss load_gauss(const float* __restrict__ mean2d, const float* __restrict__ conic,
                            const float* __restrict__ depth, const float* __restrict__ opacity,
                            const float* __restrict__ extent,
                            const unsigned char* __restrict__ valid, int p, const Grid& g) {
  Gauss s;
  s.mx = mean2d[2 * p];
  s.my = mean2d[2 * p + 1];
  const float ex = extent[2 * p], ey = extent[2 * p + 1];
  s.ca = conic[3 * p];
  s.cb = conic[3 * p + 1];
  s.cc = conic[3 * p + 2];
  s.depth = depth[p];
  s.valid = valid[p] != 0;
  float o = opacity[p];
  o = o != o ? o : fmaxf(o, (float)1e-12);
  s.log_ratio = logf(o * g.inv_alpha);
  s.x0t = iclamp(floor_i32((s.mx - ex) * g.inv_tw, 0, g.ntx), 0, g.ntx);
  const int x1t = iclamp(floor_i32((s.mx + ex) * g.inv_tw, 0, g.ntx) + 1, 0, g.ntx);
  s.y0t = iclamp(floor_i32((s.my - ey) * g.inv_th, 0, g.nty), 0, g.nty);
  s.y1t = iclamp(floor_i32((s.my + ey) * g.inv_th, 0, g.nty) + 1, 0, g.nty);
  const int rw = max(x1t - s.x0t, 0), rh = max(s.y1t - s.y0t, 0);
  s.rw_c = min(rw, g.max_rect);
  s.rh_c = min(rh, max(floordiv(g.max_rect, max(s.rw_c, 1)), 1));
  // a clipped rect keeps the rows nearest the mean
  const int mean_ty = iclamp(floor_i32(s.my * g.inv_th, 0, g.nty), s.y0t, max(s.y1t - 1, s.y0t));
  s.y0c = iclamp(mean_ty - floordiv(s.rh_c - 1, 2), s.y0t, max(s.y1t - s.rh_c, s.y0t));
  s.area = rw * rh;
  return s;
}

// q(d) = 0.5 (a dx^2 + c dy^2) + b dx dy, in the plain version's order
__device__ __forceinline__ float quad(const Gauss& s, float dx, float dy) {
  return 0.5f * (s.ca * dx * dx + s.cc * dy * dy) + s.cb * dx * dy;
}

// _emit_pairs for rect slot r: true with its tile for a candidate (inside
// the clipped rect and the alpha >= 1/255 support over the tile's box)
__device__ bool candidate(const Gauss& s, int r, const Grid& g, int* tile) {
  const int rw_s = max(s.rw_c, 1);
  const int py = s.y0c + r / rw_s;
  const int px = s.x0t + r % rw_s;
  if (!(r < s.rw_c * s.rh_c && py < s.y0c + s.rh_c && s.valid)) return false;
  const float tx0 = (float)(px * g.tw), ty0 = (float)(py * g.th);
  const float xl = tx0 - s.mx, xh = tx0 + (float)(g.tw - 1) - s.mx;
  const float yl = ty0 - s.my, yh = ty0 + (float)(g.th - 1) - s.my;
  // the box minimum is at the origin (if inside) or on an edge, where the
  // 1-D minimiser is -b*edge/other clamped to the box
  const float ex_l = quad(s, xl, tmin(tmax(-s.cb * xl / s.cc, yl), yh));
  const float ex_h = quad(s, xh, tmin(tmax(-s.cb * xh / s.cc, yl), yh));
  const float ey_l = quad(s, tmin(tmax(-s.cb * yl / s.ca, xl), xh), yl);
  const float ey_h = quad(s, tmin(tmax(-s.cb * yh / s.ca, xl), xh), yh);
  float qmin = tmin(tmin(ex_l, ex_h), tmin(ey_l, ey_h));
  if (xl <= 0.0f && 0.0f <= xh && yl <= 0.0f && 0.0f <= yh) qmin = 0.0f;
  *tile = py * g.ntx + px;
  return qmin <= s.log_ratio + (float)1e-4;
}

// the packed key of rect slot r of Gaussian `index`; a non-candidate has
// tile T and depth inf
__device__ __forceinline__ unsigned long long pack_key(bool ok, int tile, float depth, int index,
                                                       int r, const Grid& g) {
  const unsigned long long t = ok ? (unsigned long long)tile : (unsigned long long)g.T;
  const unsigned long long bits = __float_as_uint(ok ? depth : __int_as_float(0x7f800000));
  const unsigned long long key = (t << (32 - g.tbits)) | (bits >> g.tbits);
  return (key << 31) | ((unsigned long long)index << g.rbits) | (unsigned long long)r;
}

__device__ __forceinline__ int key_tile(unsigned long long key, const Grid& g) {
  return (int)(key >> (63 - g.tbits));
}

// adds one to count[t] for each lane of the warp whose t is a tile (below
// T), the lanes of one tile in one atomic (every lane of the warp calls)
__device__ __forceinline__ void count_tile(int* count, int t, int T) {
  const unsigned peers = __match_any_sync(0xffffffffu, t);
  if (t < T && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&count[t], __popc(peers));
}

// the sum of v over the block (every thread must call; thread 0 gets it)
template <int NTB>
__device__ long long block_sum(long long v, long long* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) sh[w] = v;
  __syncthreads();
  v = 0;
  if (w == 0) {
    v = l < NTB / 32 ? sh[l] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// the scratch integers: the tile counters and fill counters [T] each, the
// tile starts [T + 1], per-block big counts and rect overflows [nb1],
// per-block big-tier overflows [nb2]
struct Scratch {
  int *count, *fill, *start, *blk_big, *blk_rect, *blk_over;
};

__global__ void __launch_bounds__(NT) bin_tier1_kernel(
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ depth, const float* __restrict__ opacity,
    const float* __restrict__ extent, const unsigned char* __restrict__ valid, int P, Grid g,
    unsigned long long* __restrict__ keys, int* __restrict__ slots, Scratch w) {
  __shared__ long long sh[NT / 32];
  const int p = blockIdx.x * NT + threadIdx.x;
  for (int k = p; k < 2 * g.T; k += gridDim.x * NT) w.count[k] = 0;  // count, then fill
  bool big = false;
  int rect_over = 0;
  if (p < P) {
    const Gauss s = load_gauss(mean2d, conic, depth, opacity, extent, valid, p, g);
    const int area_c = s.rw_c * s.rh_c;
    big = s.valid && area_c > g.tier1;
    rect_over = s.valid ? s.area - area_c : 0;
    for (int r = 0; r < g.tier1; ++r) {
      int tile = 0;
      const bool ok = candidate(s, r, g, &tile);
      keys[(long long)r * P + p] = pack_key(ok, tile, s.depth, p, r, g);
      if (slots && !ok) slots[(long long)r * P + p] = -1;
    }
  }
  const int n_big = __syncthreads_count(big);
  const long long over = block_sum<NT>(rect_over, sh);
  if (threadIdx.x == 0) {
    w.blk_big[blockIdx.x] = n_big;
    w.blk_rect[blockIdx.x] = (int)over;
  }
}

__global__ void __launch_bounds__(NT) bin_big_kernel(
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ depth, const float* __restrict__ opacity,
    const float* __restrict__ extent, const unsigned char* __restrict__ valid, int P, int cap,
    int nb1, Grid g, unsigned long long* __restrict__ keys, int* __restrict__ slots, Scratch w) {
  __shared__ long long sh[NT / 32];
  __shared__ int warp_big[NT / 32];
  __shared__ int before_total[2];
  const int b = blockIdx.x, i = b * NT + threadIdx.x;
  const int wi = threadIdx.x >> 5, l = threadIdx.x & 31;
  // the big Gaussians of the blocks before this one, and of all
  long long before = 0, total = 0;
  for (int k = threadIdx.x; k < nb1; k += NT) {
    const int c = w.blk_big[k];
    total += c;
    if (k < b) before += c;
  }
  before = block_sum<NT>(before, sh);
  total = block_sum<NT>(total, sh);
  if (threadIdx.x == 0) {
    before_total[0] = (int)before;
    before_total[1] = (int)total;
  }
  Gauss s;
  bool big = false;
  if (i < P) {
    s = load_gauss(mean2d, conic, depth, opacity, extent, valid, i, g);
    big = s.valid && s.rw_c * s.rh_c > g.tier1;
  }
  // its column: its place among the big Gaussians in index order
  const unsigned mask = __ballot_sync(0xffffffffu, big);
  if (l == 0) warp_big[wi] = __popc(mask);
  __syncthreads();
  int pos = before_total[0] + __popc(mask & ((1u << l) - 1u));
  for (int k = 0; k < wi; ++k) pos += warp_big[k];
  const int n_big = before_total[1];
  const long long n1 = (long long)g.tier1 * P;
  const bool mine = i < P;
  for (int r = 0; r < g.tier1; ++r)  // the tier-1 candidates bin_tier1_kernel keyed
    count_tile(w.count, mine ? key_tile(keys[(long long)r * P + i], g) : g.T, g.T);
  const bool listed = big && pos < cap;  // big: i < P
  const int over = big && !listed ? s.rw_c * s.rh_c - g.tier1 : 0;
  for (int r = g.tier1; r < g.max_rect; ++r) {
    bool ok = false;
    int tile = g.T;
    if (listed) {
      ok = candidate(s, r, g, &tile);
      keys[n1 + (long long)(r - g.tier1) * cap + pos] = pack_key(ok, tile, s.depth, i, r, g);
      if (!ok) tile = g.T;
    }
    count_tile(w.count, tile, g.T);
    if (mine && slots && !ok) slots[(long long)r * P + i] = -1;
  }
  if (i >= n_big && i < cap) {  // an empty column of the big tier
    for (int r = g.tier1; r < g.max_rect; ++r)
      keys[n1 + (long long)(r - g.tier1) * cap + i] = pack_key(false, 0, 0.0f, 0, 0, g);
  }
  const long long o = block_sum<NT>(over, sh);
  if (threadIdx.x == 0) w.blk_over[b] = (int)o;
}

__global__ void __launch_bounds__(NT_SCAN) bin_scan_kernel(
    int T, int K, int nb1, int nb2, Scratch w, int* __restrict__ counts, int* __restrict__ out) {
  __shared__ long long sh[NT_SCAN / 32];
  __shared__ int warp_sum[NT_SCAN / 32];
  __shared__ int carry;
  const int l = threadIdx.x & 31, wi = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  long long k_over = 0, rect = 0, big_over = 0, n_big = 0;
  int peak = 0;
  for (int t0 = 0; t0 < T; t0 += NT_SCAN) {  // the starts, NT_SCAN tiles at a time
    const int t = t0 + threadIdx.x;
    const int n = t < T ? w.count[t] : 0;
    if (t < T) {
      counts[t] = min(n, K);
      peak = max(peak, n);
      k_over += max(n - K, 0);
    }
    int incl = n;  // inclusive scan of the warp, then of the warps' sums
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (l >= o) incl += v;
    }
    __syncthreads();  // carry and warp_sum of the last round read
    if (l == 31) warp_sum[wi] = incl;
    __syncthreads();
    int before = carry;
    for (int k = 0; k < wi; ++k) before += warp_sum[k];
    if (t < T) w.start[t] = before + incl - n;
    __syncthreads();
    if (threadIdx.x == NT_SCAN - 1) carry = before + incl;
  }
  __syncthreads();
  if (threadIdx.x == 0) w.start[T] = carry;
  for (int b = threadIdx.x; b < nb1; b += NT_SCAN) {
    n_big += w.blk_big[b];
    rect += w.blk_rect[b];
  }
  for (int b = threadIdx.x; b < nb2; b += NT_SCAN) big_over += w.blk_over[b];
  for (int o = 16; o > 0; o >>= 1) peak = max(peak, __shfl_down_sync(0xffffffffu, peak, o));
  if (l == 0) warp_sum[wi] = peak;
  k_over = block_sum<NT_SCAN>(k_over, sh);
  rect = block_sum<NT_SCAN>(rect, sh);
  big_over = block_sum<NT_SCAN>(big_over, sh);
  n_big = block_sum<NT_SCAN>(n_big, sh);
  if (threadIdx.x == 0) {
    for (int k = 0; k < NT_SCAN / 32; ++k) peak = max(peak, warp_sum[k]);
    out[0] = (int)(k_over + rect + big_over);  // overflow
    out[1] = peak;
    out[2] = (int)n_big;
    out[3] = (int)big_over;
  }
}

__global__ void __launch_bounds__(NT) bin_scatter_kernel(
    const unsigned long long* __restrict__ keys, long long N, Grid g, Scratch w,
    unsigned long long* __restrict__ bucket) {
  const long long j = (long long)blockIdx.x * NT + threadIdx.x;
  const unsigned long long key = j < N ? keys[j] : 0ull;
  const int t = j < N ? key_tile(key, g) : g.T;
  // the lanes of one tile take their places in one atomic
  const unsigned peers = __match_any_sync(0xffffffffu, t);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader && t < g.T) base = w.start[t] + atomicAdd(&w.fill[t], __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (t < g.T) bucket[base + __popc(peers & ((1u << lane) - 1u))] = key;
}

// the number of keys below `key` in a sorted run.  The run was written by
// this block: a const __restrict__ pointer would let the compiler read it
// through the read-only cache, which does not see those writes.
__device__ int below(const unsigned long long* run, int n, unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (run[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(NT_TILE) bin_tile_kernel(
    unsigned long long* bucket, int P, int K, Grid g, Scratch w,
    int* __restrict__ gather, unsigned char* __restrict__ slot_valid, int* __restrict__ slots) {
  __shared__ unsigned long long sh[CHUNK];
  const int t = blockIdx.x;
  const int s0 = w.start[t], n = w.start[t + 1] - s0;
  unsigned long long* run = bucket + s0;
  // sort each chunk of the bucket in shared memory (ascending bitonic)
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int len = min(CHUNK, n - c0);
    int m = 32;  // whole warps, padded with the largest key
    while (m < len) m <<= 1;
    for (int i = threadIdx.x; i < m; i += NT_TILE) sh[i] = i < len ? run[c0 + i] : ~0ull;
    __syncthreads();
    for (int k = 2; k <= m; k <<= 1) {
      int j = k >> 1;
      for (; j >= 32; j >>= 1) {  // partners in other warps: through shared memory
        for (int i = threadIdx.x; i < m; i += NT_TILE) {
          const int ij = i ^ j;
          if (ij > i) {
            const unsigned long long a = sh[i], b = sh[ij];
            if ((a > b) == ((i & k) == 0)) {
              sh[i] = b;
              sh[ij] = a;
            }
          }
        }
        __syncthreads();
      }
      // partners in the same warp (lane ^ j): every stage j < 32 in registers
      for (int i = threadIdx.x; i < m; i += NT_TILE) {
        unsigned long long v = sh[i];
        for (int jj = j; jj > 0; jj >>= 1) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, jj);
          v = (((i & k) == 0) == ((i & jj) == 0)) == (o < v) ? o : v;
        }
        sh[i] = v;
      }
      __syncthreads();
    }
    if (n > CHUNK) {
      for (int i = threadIdx.x; i < len; i += NT_TILE) run[c0 + i] = sh[i];
      __syncthreads();
    }
  }
  // each key's place in the tile: its place in its chunk plus the keys
  // below it in the other chunks
  const int cnt = min(n, K);
  const unsigned long long imask = (1ull << (31 - g.rbits)) - 1ull;
  const unsigned long long rmask = (1ull << g.rbits) - 1ull;
  const long long row = (long long)t * K;
  for (int i = threadIdx.x; i < n; i += NT_TILE) {
    unsigned long long key;
    const int own = i - i % CHUNK;  // the start of its chunk
    int j = i - own;
    if (n <= CHUNK) {
      key = sh[i];
    } else {
      key = run[i];
      for (int c0 = 0; c0 < n; c0 += CHUNK)
        if (c0 != own) j += below(run + c0, min(CHUNK, n - c0), key);
    }
    const int p = (int)((key >> g.rbits) & imask), r = (int)(key & rmask);
    if (j < K) gather[row + j] = p;
    if (slots) slots[(long long)r * P + p] = j < K ? t * K + j : -1;
  }
  for (int k = threadIdx.x; k < K; k += NT_TILE) {
    if (k >= cnt) gather[row + k] = P;
    slot_valid[row + k] = k < cnt;
  }
}

}  // namespace

extern "C" {

const char* cg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Binning of P Gaussians (mean2d [P,2], conic [P,3], depth [P], opacity
// [P], extent [P,2] float32, valid [P] bool) on an ntx x nty grid of
// tw x th pixel tiles, inv_alpha = (float)(1 / ALPHA_EPS), K table
// columns, rect slots [0, tier1) for every Gaussian and [tier1, max_rect)
// for a big tier of cap Gaussians, the key's tile bits tbits and slot
// bits rbits.  Writes gather [T,K] int32, slot_valid [T,K] bool, counts
// [T] int32, slots [R, P] int32 (or null) and out [4] int32: overflow,
// peak, big_count, big_overflow.  Scratch: keys [2 N] uint64, N = tier1 P
// + (max_rect - tier1) cap, and ints [3 T + 1 + 2 nb1 + nb2],
// nb1 = ceil(P / 128) (at least 1), nb2 = ceil(max(P, cap) / 128).
int bin_tiles(const void* mean2d, const void* conic, const void* depth, const void* opacity,
              const void* extent, const void* valid, int P, int ntx, int nty, int tw, int th,
              float inv_alpha, int max_rect, int tier1, int cap, int K, int tbits, int rbits,
              void* keys, void* ints, void* gather, void* slot_valid, void* counts, void* slots,
              void* out, void* stream) {
  const Grid g{ntx, nty, ntx * nty, max_rect, tier1, tbits, rbits, (float)(1.0 / tw),
               (float)(1.0 / th), tw, th, inv_alpha};
  const int T = g.T;
  const int nb1 = P > 0 ? (P + NT - 1) / NT : 1, nb2 = (max(P, cap) + NT - 1) / NT;
  const long long N = (long long)tier1 * P + (long long)max(max_rect - tier1, 0) * cap;
  int* iw = (int*)ints;
  const Scratch w{iw, iw + T, iw + 2 * T, iw + 3 * T + 1, iw + 3 * T + 1 + nb1,
                  iw + 3 * T + 1 + 2 * nb1};
  unsigned long long* k = (unsigned long long*)keys;
  cudaStream_t st = (cudaStream_t)stream;
  const float* f[5] = {(const float*)mean2d, (const float*)conic, (const float*)depth,
                       (const float*)opacity, (const float*)extent};
  const unsigned char* v = (const unsigned char*)valid;
  bin_tier1_kernel<<<nb1, NT, 0, st>>>(f[0], f[1], f[2], f[3], f[4], v, P, g, k, (int*)slots, w);
  if (nb2 > 0)
    bin_big_kernel<<<nb2, NT, 0, st>>>(f[0], f[1], f[2], f[3], f[4], v, P, cap, nb1, g, k,
                                       (int*)slots, w);
  bin_scan_kernel<<<1, NT_SCAN, 0, st>>>(T, K, nb1, nb2, w, (int*)counts, (int*)out);
  if (N > 0)
    bin_scatter_kernel<<<(unsigned)((N + NT - 1) / NT), NT, 0, st>>>(k, N, g, w, k + N);
  bin_tile_kernel<<<T, NT_TILE, 0, st>>>(k + N, P, K, g, w, (int*)gather,
                                         (unsigned char*)slot_valid, (int*)slots);
  return (int)cudaGetLastError();
}

}  // extern "C"
