// Fused scatter + dense Adam step on the feature tables, sm_90a.
//
// Replaces the TPU kernels of shine_mapping_tpu/ops/adam_kernel.py:
//   K1  _kernel        (one level's table; via _pallas_update, reached by
//                       fused_adam_packed)
//   K2  _kernel_multi  (all levels concatenated, per-level lr; via
//                       _pallas_update_multi, reached by
//                       fused_adam_packed_multi and
//                       fused_adam_packed_multi_pre)
// Both compute the same step, so this file holds ONE kernel template; the
// wrapper (shine_mapping_tpu_torch/ops/adam_kernel.py) calls it with L = 1
// for K1 and with all L levels' tables for K2.  Three entry points, one per
// table dtype combination the TPU kernels take:
//   fused_adam_f32          p, m, v float32
//   fused_adam_f32p_bf16m   p float32, m and v bfloat16  (tpu.moments_bf16;
//                           K1 adam_kernel.py:85-96, K2 :178-185, :201-202)
//   fused_adam_bf16p_bf16m  p, m, v bfloat16, p written back with stochastic
//                           rounding (tpu.params_bf16; K2 :186-198)
// each with a run-time flag that rounds every gradient entry to bf16 (RNE)
// before the sum (grads_bf16, the TPU's half-matmul branch).  The sum, the
// moments' arithmetic and p_new are float32 in every variant; bf16 moments
// are loaded, widened, and stored back with round-to-nearest-even, and p_new
// is computed from the float32 m_new / v_new (as adam_kernel.py:184-187).
//
// What it computes.  Level l's tables p[l], m[l], v[l] are row-major
// (C_l, D) buffers of their own: the TPU kernel's concatenated table
// becomes one base pointer per level, so nothing is copied.  Gradient
// entries (row, D f32 values) carry GLOBAL rows (level l's row r is
// row_off[l] + r, row_off the running sum of the C_l) and arrive sorted by
// that row, duplicates allowed.  For every row r < n_used[l] of every level
// (the used head):
//     g = sum of the entries of row r          (0 for untouched rows)
//     m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2
//     p = p - lr[l] (m / bc1) / (sqrt(v / bc2) + eps)
// in place.  Untouched rows still decay (reference dense Adam).  Rows past a
// level's used head are never visited and stay bit-identical; entries whose
// row lies outside every used head (the wrapper maps trashbin and dropped
// entries to a sentinel row) are never read.
//
// Stochastic rounding (bf16 p).  Output bits = (bits(p_new) + noise16) &
// 0xFFFF0000, non-finite values passed through: the operation of the XLA
// twin sr_round_bf16 (adam_kernel.py:778-789).  The 16 noise bits are a pure
// function of (seed, level, element index): Philox4x32-10 keyed by the
// per-step seed, one call per 8 consecutive elements of a level (128 bits =
// 8 x 16).  The TPU kernel seeds its generator per tile (prng_seed(seed +
// t), :194); keying by element makes the result independent of the tile
// size and of the grid, so a change of either cannot change a trajectory.
//
// Design.  One CTA per tile of tb = TILE_ELEMS / D rows of one level (a tile
// never straddles a level, so it has one lr).  The CTA binary-searches its
// row range [row0, row0 + nrows) in the sorted entry rows, sums those
// entries into a (tb, D) f32 tile in shared memory with shared-memory
// atomics (f32 sums match the plain version up to addition order), then
// sweeps the tile: read p, m, v once, apply Adam, write them once.  The TPU
// kernel's one-hot bf16 hi+lo MXU matmul (adam_kernel.py:74-84) was a trick
// for the TPU's matrix unit and is not copied.  With bf16 p the CTA first
// draws its tile's noise into shared memory (one Philox call per 8
// elements, 4 KB), so the sweep reads and writes the tables coalesced, as
// in the other variants.
//
// Bound.  Memory bandwidth: per step the kernel reads and writes p, m and v
// over the used heads -- 24 B per table element for f32 p/m/v, 16 B for f32
// p with bf16 m/v, 12 B for bf16 p/m/v -- plus 4 + 4 D bytes per entry, and
// does ~13 flops per element (far below the f32 rate; Philox adds ~8 integer
// multiplies per element with bf16 p, also far below the integer rate).  At
// the smoke's used rows (3.41M + 3.15M + 2.62M rows x D 8 = 73.4M elements):
// 1.76 GB / 1.17 GB / 0.88 GB per step, >= 0.53 / 0.35 / 0.26 ms at
// 3.35 TB/s; chip_smoke.py recomputes each bound from the sizes it runs.
// Simple first: scalar loads, one tile per CTA.  16-byte vector loads, a
// persistent grid, or cp.async / TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#define MAX_LEVELS 16
#define TILE_ELEMS 2048  // floats per tile: 8 KB of shared memory
#define THREADS 256

struct Levels {
  void* p[MAX_LEVELS];            // level l's (C_l, D) tables
  void* m[MAX_LEVELS];
  void* v[MAX_LEVELS];
  long long row_off[MAX_LEVELS];  // first global row of level l
  long long n_used[MAX_LEVELS];   // rows swept of level l (its used head)
  int tile_off[MAX_LEVELS + 1];   // first tile of level l; [L] = total tiles
  float lr[MAX_LEVELS];           // learning rate of level l
  int n_levels;
};

// first index i in sorted a[0, n) with a[i] >= key
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float load(const float* a, int i) { return a[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* a, int i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void store(float* a, int i, float x) { a[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* a, int i, float x) {
  a[i] = __float2bfloat16_rn(x);  // round to nearest even, as astype(bf16)
}

// Philox4x32-10 (Salmon et al., SC'11), counter-based: a pure function of
// (counter, key)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// f32 -> bf16 by adding 16 noise bits below the mantissa cut and
// truncating: carries run into the exponent; non-finite values pass through
__device__ __forceinline__ __nv_bfloat16 sr_bf16(float x, unsigned noise16) {
  const unsigned bits = __float_as_uint(x);
  if ((bits & 0x7F800000u) == 0x7F800000u) return __float2bfloat16_rn(x);
  return __ushort_as_bfloat16((unsigned short)((bits + noise16) >> 16));
}

template <typename P, typename Mt, bool GRADS_BF16>
__global__ void __launch_bounds__(THREADS) fused_adam_kernel(
    const int* __restrict__ rows, const float* __restrict__ g, int M, int D,
    int tb, Levels lv, float b1, float b2, float omb1, float omb2, float bc1,
    float bc2, float eps, unsigned seed) {
  extern __shared__ float gtile[];
  __shared__ int s_lo, s_hi;

  const int t = blockIdx.x;
  int l = 0;
  while (l + 1 < lv.n_levels && t >= lv.tile_off[l + 1]) ++l;
  const long long k = t - lv.tile_off[l];
  const long long row0 = lv.row_off[l] + k * tb;  // global, as the entries
  const long long left = lv.n_used[l] - k * tb;
  const int nrows = (int)(left < tb ? left : tb);
  const int nel = nrows * D;

  for (int e = threadIdx.x; e < nel; e += THREADS) gtile[e] = 0.f;
  if (threadIdx.x == 0) {
    s_lo = lower_bound(rows, M, row0);
    s_hi = lower_bound(rows, M, row0 + nrows);
  }
  __syncthreads();

  // segmented sum of this tile's entries (entry-major, D lanes each)
  const int lo = s_lo;
  const int n = (s_hi - s_lo) * D;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int j = lo + e / D;
    const int d = e - (e / D) * D;
    float gv = g[(long long)j * D + d];
    if (GRADS_BF16) gv = __bfloat162float(__float2bfloat16_rn(gv));
    atomicAdd(&gtile[(int)(rows[j] - row0) * D + d], gv);
  }
  __syncthreads();

  // dense Adam over every row of the tile, touched or not
  const float lr = lv.lr[l];
  const long long base = k * tb * D;  // the tile's first element in level l
  P* __restrict__ p = static_cast<P*>(lv.p[l]) + base;
  Mt* __restrict__ m = static_cast<Mt*>(lv.m[l]) + base;
  Mt* __restrict__ v = static_cast<Mt*>(lv.v[l]) + base;
  constexpr bool SR = std::is_same<P, __nv_bfloat16>::value;
  // bf16 p: the tile's 16-bit rounding noise, one Philox call per 8-element
  // group of the level, staged in shared memory so the sweep stays coalesced
  __shared__ unsigned short noise[SR ? TILE_ELEMS : 1];
  if constexpr (SR) {
    const long long g_end = (base + nel - 1) >> 3;
    for (long long grp = (base >> 3) + threadIdx.x; grp <= g_end;
         grp += THREADS) {
      const uint4 r = philox4x32_10(
          make_uint4((unsigned)grp, (unsigned)(grp >> 32), (unsigned)l, 0u),
          make_uint2(seed, 0x53524E44u));
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long e = grp * 8 + j - base;
        if (e >= 0 && e < nel)
          noise[e] = (unsigned short)(w[j >> 1] >> ((j & 1) * 16));
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < nel; e += THREADS) {
    const float gi = gtile[e];
    const float mi = b1 * load(m, e) + omb1 * gi;
    const float vi = b2 * load(v, e) + omb2 * gi * gi;
    const float pn = load(p, e) - lr * (mi / bc1) / (sqrtf(vi / bc2) + eps);
    if constexpr (SR)
      p[e] = sr_bf16(pn, noise[e]);
    else
      p[e] = pn;
    store(m, e, mi);
    store(v, e, vi);
  }
}

// Launches the step on `stream`; returns cudaGetLastError() (0 = launched).
// p, m, v (device pointers, one per level), row_off, n_used and lr are HOST
// arrays of n_levels entries.
template <typename P, typename Mt>
static int launch(void* const* p, void* const* m, void* const* v,
                  const int* rows, const float* g, int M, int D, int n_levels,
                  const long long* row_off, const long long* n_used,
                  const float* lr, float b1, float b2, float omb1, float omb2,
                  float bc1, float bc2, float eps, int grads_bf16,
                  unsigned seed, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || D < 1 || D > TILE_ELEMS ||
      M < 0)
    return (int)cudaErrorInvalidValue;
  const int tb = TILE_ELEMS / D;
  Levels lv;
  long long tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (n_used[l] < 0) return (int)cudaErrorInvalidValue;
    lv.p[l] = p[l];
    lv.m[l] = m[l];
    lv.v[l] = v[l];
    lv.row_off[l] = row_off[l];
    lv.n_used[l] = n_used[l];
    lv.tile_off[l] = (int)tiles;
    lv.lr[l] = lr[l];
    tiles += (n_used[l] + tb - 1) / tb;
  }
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lv.tile_off[n_levels] = (int)tiles;
  lv.n_levels = n_levels;
  if (tiles > 0) {
    const size_t smem = (size_t)tb * D * sizeof(float);
    cudaStream_t s = (cudaStream_t)stream;
    if (grads_bf16)
      fused_adam_kernel<P, Mt, true><<<(unsigned)tiles, THREADS, smem, s>>>(
          rows, g, M, D, tb, lv, b1, b2, omb1, omb2, bc1, bc2, eps, seed);
    else
      fused_adam_kernel<P, Mt, false><<<(unsigned)tiles, THREADS, smem, s>>>(
          rows, g, M, D, tb, lv, b1, b2, omb1, omb2, bc1, bc2, eps, seed);
  }
  return (int)cudaGetLastError();
}

#define FUSED_ADAM_ARGS                                                      \
  void *const *p, void *const *m, void *const *v, const int *rows,           \
      const float *g, int M, int D, int n_levels, const long long *row_off,  \
      const long long *n_used, const float *lr, float b1, float b2,          \
      float omb1, float omb2, float bc1, float bc2, float eps,               \
      int grads_bf16, unsigned seed, void *stream
#define FUSED_ADAM_PASS                                                       \
  p, m, v, rows, g, M, D, n_levels, row_off, n_used, lr, b1, b2, omb1, omb2, \
      bc1, bc2, eps, grads_bf16, seed, stream

extern "C" {

int fused_adam_f32(FUSED_ADAM_ARGS) {
  return launch<float, float>(FUSED_ADAM_PASS);
}

int fused_adam_f32p_bf16m(FUSED_ADAM_ARGS) {
  return launch<float, __nv_bfloat16>(FUSED_ADAM_PASS);
}

int fused_adam_bf16p_bf16m(FUSED_ADAM_ARGS) {
  return launch<__nv_bfloat16, __nv_bfloat16>(FUSED_ADAM_PASS);
}

}  // extern "C"
