// Design (b) of scripts/probe_k2_shards.py: csrc/fused_adam.cu as a
// persistent grid with a cp.async ring, measured and not taken.
//
// The update kernel of csrc/fused_adam.cu (same C interface, same step, same
// rounding, the same checks) on a persistent grid: as many CTAs as the SMs
// hold at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor, queried once
// a device), CTA b walking the work items b, b + G, b + 2 G, ... by a static
// stride, the next stages - 1 tiles' p, m and v in flight in a shared-memory
// ring of 16-byte cp.async copies while the current tile is summed and
// stepped; each thread copies and reads back only its own groups, so the
// ring needs no barrier; the tile's sums stay zero between tiles (each
// reader zeroes what it read), and the next tile's entry range is loaded a
// tile ahead.  fused_adam_grid reports the grid a launch takes.  The probe
// builds its altered copies (stages, CTAs an SM, one CTA a tile, registers
// in place of the ring, TMA bulk copies in place of cp.async) from this
// file; PERF.md §6 has their times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#define MAX_LEVELS 16
#define MAX_DEVICES 64
#define THREADS 128
#define GPT 2  // groups of 8 elements a thread owns: 2,048-element tiles
#define TILE_MAX (GPT * THREADS * 8)  // elements of a tile the ring stages
#define SMEM_DEFAULT (48 * 1024)  // dynamic shared memory without opting in
#define SMEM_MAX (227 * 1024)

struct Levels {
  void* p[MAX_LEVELS];            // level l's (C_l, D) tables
  void* m[MAX_LEVELS];
  void* v[MAX_LEVELS];
  const float* g[MAX_LEVELS];     // level l's (M_l, D) gradient entries
  long long ent_off[MAX_LEVELS];  // first entry of level l in the concatenation
  long long row_off[MAX_LEVELS];  // first global row of level l
  long long n_used[MAX_LEVELS];   // rows swept of level l (its used head)
  long long grp_base[MAX_LEVELS]; // Philox group of the table's first element
  int tile_lo[MAX_LEVELS + 1];    // first tile of level l; [L] = total tiles
  float lr[MAX_LEVELS];           // learning rate of level l
  int n_levels;
};

struct Hyper {
  float b1, b2, omb1, omb2, bc1, bc2, eps;
};

// The entry-balanced grid's work list and scratch (chunk 0: none)
struct Split {
  const int* off;     // (T) each tile's first extra item; keys its slot
  const int2* items;  // (E_max) each extra item's (tile, chunk j >= 1)
  const int* count;   // (1) the number of extra items
  float* acc;         // (E_max, tb * D) f32 slots, zero between launches
  int* arrive;        // (E_max) arrival counters, zero between launches
  int chunk;          // entries a work item sums; 0 = one item a tile
  int T;              // tiles: work items >= T are extra items
  int n_items;        // T + E_max (chunk > 0) or T: the items the grid walks
};

// 8 consecutive float32, 16-byte aligned (the gradient tile in shared memory)
__device__ __forceinline__ void load8(const float* a, float (&x)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(a);
  const float4 w = *reinterpret_cast<const float4*>(a + 4);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  x[4] = w.x; x[5] = w.y; x[6] = w.z; x[7] = w.w;
}
__device__ __forceinline__ void store8(float* a, const float (&x)[8]) {
  *reinterpret_cast<float4*>(a) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(a + 4) = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));  // round to nearest even
}
__device__ __forceinline__ void store8(__nv_bfloat16* a, const float (&x)[8]) {
  unsigned q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q[j] = (unsigned)bf16_bits(x[2 * j]) | ((unsigned)bf16_bits(x[2 * j + 1]) << 16);
  *reinterpret_cast<uint4*>(a) = make_uint4(q[0], q[1], q[2], q[3]);
}
// 8 bf16 values given as their bits (the stochastically rounded p)
__device__ __forceinline__ void store8(__nv_bfloat16* a, const unsigned short (&b)[8]) {
  *reinterpret_cast<uint4*>(a) =
      make_uint4(b[0] | ((unsigned)b[1] << 16), b[2] | ((unsigned)b[3] << 16),
                 b[4] | ((unsigned)b[5] << 16), b[6] | ((unsigned)b[7] << 16));
}
__device__ __forceinline__ void store1(float* a, int i, float x) { a[i] = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* a, int i, float x) {
  a[i] = __float2bfloat16_rn(x);
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

// f32 -> bf16 bits by adding 16 noise bits below the mantissa cut and
// truncating: carries run into the exponent; non-finite values pass through
__device__ __forceinline__ unsigned short sr_bits(float x, unsigned noise16) {
  const unsigned bits = __float_as_uint(x);
  if ((bits & 0x7F800000u) == 0x7F800000u) return bf16_bits(x);
  return (unsigned short)((bits + (noise16 & 0xFFFFu)) >> 16);
}

// one element's Adam step, each operation rounded on its own
__device__ __forceinline__ void adam1(float& p, float& m, float& v, float g, float lr,
                                      const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m, h.bc1)), den));
}

// 8 consecutive elements as loaded: two float4 of f32, one uint4 of bf16
// (4 registers), widened to float only when the group is stepped
template <typename T> struct Raw8;
template <> struct Raw8<float> { float4 a, b; };
template <> struct Raw8<__nv_bfloat16> { uint4 a; };

__device__ __forceinline__ void load_raw(const float* a, int n, Raw8<float>& r) {
  if (n == 8) {
    r.a = *reinterpret_cast<const float4*>(a);
    r.b = *reinterpret_cast<const float4*>(a + 4);
  } else {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = j < n ? a[j] : 0.f;
    r.a = make_float4(x[0], x[1], x[2], x[3]);
    r.b = make_float4(x[4], x[5], x[6], x[7]);
  }
}
__device__ __forceinline__ void load_raw(const __nv_bfloat16* a, int n, Raw8<__nv_bfloat16>& r) {
  if (n == 8) {
    r.a = *reinterpret_cast<const uint4*>(a);
  } else {
    unsigned short x[8];
    const unsigned short* u = reinterpret_cast<const unsigned short*>(a);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = j < n ? u[j] : 0;
    r.a = make_uint4(x[0] | ((unsigned)x[1] << 16), x[2] | ((unsigned)x[3] << 16),
                     x[4] | ((unsigned)x[5] << 16), x[6] | ((unsigned)x[7] << 16));
  }
}
__device__ __forceinline__ void unpack(const Raw8<float>& r, float (&x)[8]) {
  x[0] = r.a.x; x[1] = r.a.y; x[2] = r.a.z; x[3] = r.a.w;
  x[4] = r.b.x; x[5] = r.b.y; x[6] = r.b.z; x[7] = r.b.w;
}
__device__ __forceinline__ void unpack(const Raw8<__nv_bfloat16>& r, float (&x)[8]) {
  const unsigned q[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(q[j] << 16);
    x[2 * j + 1] = __uint_as_float(q[j] & 0xFFFF0000u);
  }
}

template <typename P, typename Mt>
struct Group {
  Raw8<P> p;
  Raw8<Mt> m, v;
};

// group q of the tile (elements e0 = 8 q ...; the last may be a tail of n < 8)
template <typename P, typename Mt>
__device__ __forceinline__ void load_group(Group<P, Mt>& r, const P* p, const Mt* m,
                                           const Mt* v, int e0, int n) {
  load_raw(p + e0, n, r.p);
  load_raw(m + e0, n, r.m);
  load_raw(v + e0, n, r.v);
}

// steps a loaded group and stores it; gt (the tile's sums in shared memory,
// nullptr: no entries) is left zero where it was read
template <typename P, typename Mt>
__device__ __forceinline__ void finish_group(const Group<P, Mt>& r, P* p, Mt* m, Mt* v,
                                             int e0, int n, float* gt, float lr,
                                             const Hyper& h, long long grp, int level,
                                             unsigned seed) {
  float pf[8], mf[8], vf[8], g[8];
  unpack(r.p, pf);
  unpack(r.m, mf);
  unpack(r.v, vf);
  if (gt != nullptr) {
    load8(gt + e0, g);  // shared memory; the tile is a whole number of groups
    const float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    store8(gt + e0, z);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) g[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) adam1(pf[j], mf[j], vf[j], g[j], lr, h);
  if constexpr (std::is_same<P, __nv_bfloat16>::value) {
    const uint4 w = philox4x32_10(
        make_uint4((unsigned)grp, (unsigned)(grp >> 32), (unsigned)level, 0u),
        make_uint2(seed, 0x53524E44u));
    const unsigned q[4] = {w.x, w.y, w.z, w.w};
    unsigned short b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = sr_bits(pf[j], q[j >> 1] >> ((j & 1) * 16));
    if (n == 8) store8(p + e0, b);
    else for (int j = 0; j < n; ++j) p[e0 + j] = __ushort_as_bfloat16(b[j]);
  } else {
    if (n == 8) store8(p + e0, pf);
    else for (int j = 0; j < n; ++j) store1(p, e0 + j, pf[j]);
  }
  if (n == 8) {
    store8(m + e0, mf);
    store8(v + e0, vf);
  } else {
    for (int j = 0; j < n; ++j) {
      store1(m, e0 + j, mf[j]);
      store1(v, e0 + j, vf[j]);
    }
  }
}

// the tile's atomics sum of entries [lo, hi) into the (tb, D) tile; eo (the
// level's first entry) and row0 (the tile's first global row) are below
// 2^31 (the wrapper refuses more entries or rows)
template <bool GRADS_BF16>
__device__ __forceinline__ void sum_atomic(float* gtile, const int* __restrict__ rows,
                                           const int* __restrict__ order,
                                           const float* __restrict__ g, int eo, int row0,
                                           int lo, int hi, int D) {
  const int n = (hi - lo) * D;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int j = lo + e / D;
    const int d = e - (e / D) * D;
    float gv = g[(long long)(order[j] - eo) * D + d];
    if (GRADS_BF16) gv = __bfloat162float(__float2bfloat16_rn(gv));
    atomicAdd(&gtile[(rows[j] - row0) * D + d], gv);
  }
}

// where tile t lies: its level, its index in the level, its elements and
// its first element in the level
struct Tile {
  int l, nel;
  long long k, base;
};
__device__ __forceinline__ Tile tile_at(const Levels& lv, int t, int tb, int D) {
  Tile x;
  x.l = 0;
  while (x.l + 1 < lv.n_levels && t >= lv.tile_lo[x.l + 1]) ++x.l;
  x.k = t - lv.tile_lo[x.l];
  const long long left = lv.n_used[x.l] - x.k * tb;
  x.nel = (int)(left < tb ? left : tb) * D;
  x.base = x.k * tb * D;
  return x;
}

// The ring: stages of a tile's p, m and v (TILE_MAX elements each, in that
// order), filled by 16-byte cp.async copies that bypass L1; each thread
// copies and later reads only its own whole groups, so the ring needs no
// barrier.  Stages per variant: the tile being stepped and stages - 1 in
// flight, as many as keep the CTAs an SM holds (MinCtas) within its 228 KB.
template <typename P, typename Mt>
struct Ring {
  static constexpr int stages = std::is_same<P, float>::value &&
                                std::is_same<Mt, float>::value ? 2 : 3;
  static constexpr int bytes = TILE_MAX * (int)(sizeof(P) + 2 * sizeof(Mt));
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
template <typename T>
__device__ __forceinline__ void stage8(T* dst, const T* src) {
  cp_async16(dst, src);
  if (sizeof(T) == 4) cp_async16(dst + 4, src + 4);
}

// this thread's whole groups of tile t into stage st (a tail group is
// loaded where it is stepped)
template <typename P, typename Mt>
__device__ __forceinline__ void fill(char* st, const Levels& lv, int t, int tb, int D) {
  const Tile x = tile_at(lv, t, tb, D);
  P* sp = reinterpret_cast<P*>(st);
  Mt* sm = reinterpret_cast<Mt*>(st + TILE_MAX * sizeof(P));
  Mt* sv = sm + TILE_MAX;
  const P* p = static_cast<const P*>(lv.p[x.l]) + x.base;
  const Mt* m = static_cast<const Mt*>(lv.m[x.l]) + x.base;
  const Mt* v = static_cast<const Mt*>(lv.v[x.l]) + x.base;
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    const int e0 = (threadIdx.x + i * THREADS) << 3;
    if (e0 + 8 <= x.nel) {
      stage8(sp + e0, p + e0);
      stage8(sm + e0, m + e0);
      stage8(sv + e0, v + e0);
    }
  }
}

// CTAs an SM holds at once (the registers a thread may take follow): as
// many as the ring's shared memory lets in, 8 KB of sums plus the stages
// (bf16 p 44 KB, 5 CTAs; bf16 moments 56 KB, 4; f32 56 KB, 4)
template <typename P, typename Mt>
struct MinCtas {
  static constexpr int value = std::is_same<P, __nv_bfloat16>::value ? 5 : 4;
};

// A persistent grid: CTA b walks the work items b, b + G, b + 2 G, ... (G
// = gridDim.x; items < T are tiles, the rest the work list's extra items),
// with the next stages - 1 tiles' tables in flight in its ring while it
// sums and steps the current one.  THREADS threads a CTA, each owning GPT
// groups of a tile.
template <typename P, typename Mt, bool GRADS_BF16>
__global__ void __launch_bounds__(THREADS, MinCtas<P, Mt>::value) fused_adam_kernel(
    const int* __restrict__ rows, const int* __restrict__ order,
    const int* __restrict__ tile_off, int D, int tb, Levels lv, Hyper h, unsigned seed,
    int det, Split sp) {
  using R = Ring<P, Mt>;
  extern __shared__ float4 smem4[];
  float* gtile = reinterpret_cast<float*>(smem4);  // the tile's sums, zero between tiles
  const int n4 = (tb * D) >> 2;                   // tb * D is a multiple of 8
  char* ring = reinterpret_cast<char*>(smem4 + n4);
  for (int e = threadIdx.x; e < n4; e += THREADS) smem4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int G = gridDim.x;
#pragma unroll
  for (int s = 0; s + 1 < R::stages; ++s) {
    const int t = blockIdx.x + s * G;
    if (t < sp.T) fill<P, Mt>(ring + s * R::bytes, lv, t, tb, D);
    cp_async_commit();
  }
  // the next tile's entry range, loaded a tile ahead
  int nlo = 0, nhi = 0;
  if ((int)blockIdx.x < sp.T) {
    nlo = tile_off[blockIdx.x];
    nhi = tile_off[blockIdx.x + 1];
  }
  for (int i = blockIdx.x, it = 0; i < sp.n_items; i += G, ++it) {
    {
      const int t = i + (R::stages - 1) * G;
      if (t < sp.T) fill<P, Mt>(ring + ((it + R::stages - 1) % R::stages) * R::bytes, lv, t, tb, D);
      cp_async_commit();
    }
    int t = i, j = 0, lo = nlo, hi = nhi;
    if (i + G < sp.T) {
      nlo = tile_off[i + G];
      nhi = tile_off[i + G + 1];
    }
    if (t >= sp.T) {  // an extra work item
      const int e = t - sp.T;
      if (e >= *sp.count) break;  // past the list: n_items is its upper bound
      const int2 w = sp.items[e];
      t = w.x;
      j = w.y;
      lo = tile_off[t];
      hi = tile_off[t + 1];
    }
    const Tile x = tile_at(lv, t, tb, D);
    const int n_groups = (x.nel + 7) >> 3;
    P* __restrict__ p = static_cast<P*>(lv.p[x.l]) + x.base;
    Mt* __restrict__ m = static_cast<Mt*>(lv.m[x.l]) + x.base;
    Mt* __restrict__ v = static_cast<Mt*>(lv.v[x.l]) + x.base;
    const int row0 = (int)(lv.row_off[x.l] + x.k * tb);  // global, as the entries
    const float* __restrict__ g = lv.g[x.l];
    const int eo = (int)lv.ent_off[x.l];
    const float lr = lv.lr[x.l];
    const long long grp0 = lv.grp_base[x.l] + (x.base >> 3);
    if (sp.chunk > 0 && hi - lo > sp.chunk) {
      // a split tile: this item sums its chunk, the partial goes to the
      // tile's slot, and the last item to arrive sweeps the tile, loading
      // the tables itself (its stage, if any, is dropped)
      __syncthreads();  // every thread's reads of the previous sums are done
      const int klo = lo + j * sp.chunk;
      sum_atomic<GRADS_BF16>(gtile, rows, order, g, eo, row0, klo, min(hi, klo + sp.chunk), D);
      __syncthreads();
      const int slot = sp.off[t];
      float* acc = sp.acc + (long long)slot * tb * D;
      for (int e = threadIdx.x; e < tb * D; e += THREADS) {
        const float y = gtile[e];
        if (y != 0.f) {
          atomicAdd(acc + e, y);
          gtile[e] = 0.f;
        }
      }
      __threadfence();
      __syncthreads();
      int last = 0;
      if (threadIdx.x == 0) last = atomicAdd(sp.arrive + slot, 1) == (hi - lo - 1) / sp.chunk;
      if (!__syncthreads_or(last)) continue;  // the barrier carries thread 0's answer
      __threadfence();  // the other items' adds, before the slot is read
      float4* acc4 = reinterpret_cast<float4*>(acc);
      for (int e = threadIdx.x; e < n4; e += THREADS) {
        smem4[e] = __ldcg(acc4 + e);
        __stcg(acc4 + e, make_float4(0.f, 0.f, 0.f, 0.f));  // zero for the next launch
      }
      if (threadIdx.x == 0) sp.arrive[slot] = 0;
      __syncthreads();
      for (int q = threadIdx.x; q < n_groups; q += THREADS) {
        Group<P, Mt> r;
        load_group(r, p, m, v, q << 3, min(8, x.nel - (q << 3)));
        finish_group(r, p, m, v, q << 3, min(8, x.nel - (q << 3)), gtile, lr, h, grp0 + q,
                     x.l, seed);
      }
      continue;
    }
    const bool touched = hi > lo;  // the same for the whole CTA
    if (touched) {
      __syncthreads();  // every thread's reads of the previous sums are done
      if (det) {
        // entries sorted by row inside the tile (the plain prep's stable
        // sort): the thread at a run's head sums the run in entry order, so
        // every launch on the same entries gives the same bits
        const int n = (hi - lo) * D;
        for (int e = threadIdx.x; e < n; e += THREADS) {
          const int jj = lo + e / D;
          const int d = e - (e / D) * D;
          const int rr = rows[jj];
          if (jj > lo && rows[jj - 1] == rr) continue;
          float a = 0.f;
          for (int k = jj; k < hi && rows[k] == rr; ++k) {
            float gv = g[(long long)(order[k] - eo) * D + d];
            if (GRADS_BF16) gv = __bfloat162float(__float2bfloat16_rn(gv));
            a = __fadd_rn(a, gv);
          }
          gtile[(rr - row0) * D + d] = a;
        }
      } else {
        sum_atomic<GRADS_BF16>(gtile, rows, order, g, eo, row0, lo, hi, D);
      }
      __syncthreads();
    }
    float* gt = touched ? gtile : nullptr;
    cp_async_wait<R::stages - 1>();  // this tile's stage: this thread's copies have landed
    const char* st = ring + (it % R::stages) * R::bytes;
    const P* sp_ = reinterpret_cast<const P*>(st);
    const Mt* sm_ = reinterpret_cast<const Mt*>(st + TILE_MAX * sizeof(P));
    const Mt* sv_ = sm_ + TILE_MAX;
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
      const int q = threadIdx.x + k * THREADS;
      if (q < n_groups) {
        const int e0 = q << 3, n = min(8, x.nel - e0);
        Group<P, Mt> r;
        if (n == 8) load_group(r, sp_, sm_, sv_, e0, 8);
        else load_group(r, p, m, v, e0, n);
        finish_group(r, p, m, v, e0, n, gt, lr, h, grp0 + q, x.l, seed);
      }
    }
    // tiles of more than GPT * THREADS groups (D > 256, where tb is 8 rows)
    for (int q = threadIdx.x + GPT * THREADS; q < n_groups; q += THREADS) {
      Group<P, Mt> r;
      load_group(r, p, m, v, q << 3, min(8, x.nel - (q << 3)));
      finish_group(r, p, m, v, q << 3, min(8, x.nel - (q << 3)), gt, lr, h, grp0 + q, x.l,
                   seed);
    }
  }
}

// The persistent grid of one instantiation on the current device, for a
// launch of `smem` bytes of dynamic shared memory: every SM full
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, queried once a device
// and size).  Returns a CUDA error, or 0 and *ctas.
template <typename P, typename Mt, bool GB>
static int grid_ctas(size_t smem, long long* ctas) {
  struct Cache {
    size_t smem;
    long long ctas;
  };
  static Cache cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  Cache& c = cache[dev];
  if (c.ctas == 0 || c.smem != smem) {
    if (smem > SMEM_DEFAULT) {
      e = cudaFuncSetAttribute(fused_adam_kernel<P, Mt, GB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    // all of the SM's 228 KB as shared memory (L1 takes the rest), so that
    // MinCtas CTAs fit
    e = cudaFuncSetAttribute(fused_adam_kernel<P, Mt, GB>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_adam_kernel<P, Mt, GB>,
                                                      THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    c.smem = smem;
    c.ctas = (long long)per_sm * sms;
  }
  *ctas = c.ctas;
  return 0;
}

// dynamic shared memory of a launch: the (tb, D) f32 sums and the ring
template <typename P, typename Mt>
static size_t smem_bytes(int tb, int D) {
  return (size_t)tb * D * sizeof(float) + (size_t)Ring<P, Mt>::stages * Ring<P, Mt>::bytes;
}

template <typename P, typename Mt, bool GB>
static int launch_t(long long items, size_t smem, cudaStream_t s, const int* rows,
                    const int* order, const int* tile_off, int D, int tb, const Levels& lv,
                    const Hyper& h, unsigned seed, int det, const Split& sp) {
  long long ctas = 0;
  const int err = grid_ctas<P, Mt, GB>(smem, &ctas);
  if (err != 0) return err;
  const long long grid = items < ctas ? items : ctas;
  fused_adam_kernel<P, Mt, GB><<<(unsigned)grid, THREADS, smem, s>>>(rows, order, tile_off, D,
                                                                     tb, lv, h, seed, det, sp);
  return 0;
}

// Launches the step on `stream`; returns cudaGetLastError() (0 = launched).
// p, m, v, g (device pointers, one per level), ent_off, row_off, n_used and
// lr are HOST arrays of n_levels entries; rows, order (M) and tile_off
// (tiles + 1) device arrays from the entry prep with the same tb.  chunk >
// 0 (not with det): the prep's work list split_off (tiles), split_items
// (E_max, 2), n_split (1) and, for E_max slots, acc (E_max * tb * D f32)
// and arrive (E_max int32), device scratch that is zero before the launch
// and that the launch leaves zero.
template <typename P, typename Mt>
static int launch(void* const* p, void* const* m, void* const* v, const void* const* g,
                  const long long* ent_off, const int* rows, const int* order,
                  const int* tile_off, int D, int tb, int n_levels, const long long* row_off,
                  const long long* n_used, const float* lr, float b1, float b2, float omb1,
                  float omb2, float bc1, float bc2, float eps, int grads_bf16, unsigned seed,
                  void* stream, const long long* row_base, int det, int chunk, int E_max,
                  const void* split_off, const void* split_items, const void* n_split,
                  void* acc, void* arrive) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || D < 1 || tb < 8 || tb % 8 != 0 || chunk < 0 ||
      (chunk > 0 && (det || E_max < 1 || split_off == nullptr || split_items == nullptr ||
                     n_split == nullptr || acc == nullptr || arrive == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<P, Mt>(tb, D);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  Levels lv;
  long long tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    // the kernel keeps entries and global rows in 32 bits
    if (n_used[l] < 0 || ent_off[l] < 0 || ent_off[l] > 0x7fffffffLL || row_off[l] < 0 ||
        row_off[l] + n_used[l] > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    // a shard's elements keep the noise of their place in the whole table,
    // which needs its first element on a group of 8
    const long long e0 = row_base == nullptr ? 0 : row_base[l] * D;
    if (e0 < 0 || e0 % 8 != 0) return (int)cudaErrorInvalidValue;
    lv.grp_base[l] = e0 >> 3;
    lv.p[l] = p[l];
    lv.m[l] = m[l];
    lv.v[l] = v[l];
    lv.g[l] = static_cast<const float*>(g[l]);
    lv.ent_off[l] = ent_off[l];
    lv.row_off[l] = row_off[l];
    lv.n_used[l] = n_used[l];
    lv.tile_lo[l] = (int)tiles;
    lv.lr[l] = lr[l];
    tiles += (n_used[l] + tb - 1) / tb;
  }
  const long long items = tiles + (chunk > 0 ? E_max : 0);
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lv.tile_lo[n_levels] = (int)tiles;
  lv.n_levels = n_levels;
  const Hyper h{b1, b2, omb1, omb2, bc1, bc2, eps};
  const Split sp{static_cast<const int*>(split_off), static_cast<const int2*>(split_items),
                 static_cast<const int*>(n_split), static_cast<float*>(acc),
                 static_cast<int*>(arrive), chunk, (int)tiles, (int)items};
  if (tiles > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int err = grads_bf16
        ? launch_t<P, Mt, true>(items, smem, s, rows, order, tile_off, D, tb, lv, h, seed,
                                det, sp)
        : launch_t<P, Mt, false>(items, smem, s, rows, order, tile_off, D, tb, lv, h, seed,
                                 det, sp);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

#define FUSED_ADAM_ARGS                                                                 \
  void *const *p, void *const *m, void *const *v, const void *const *g,                \
      const long long *ent_off, const int *rows, const int *order, const int *tile_off, \
      int D, int tb, int n_levels, const long long *row_off, const long long *n_used,   \
      const float *lr, float b1, float b2, float omb1, float omb2, float bc1, float bc2, \
      float eps, int grads_bf16, unsigned seed, void *stream
#define FUSED_ADAM_PASS                                                                \
  p, m, v, g, ent_off, rows, order, tile_off, D, tb, n_levels, row_off, n_used, lr, b1, \
      b2, omb1, omb2, bc1, bc2, eps, grads_bf16, seed, stream
// the work list (chunk 0: none), last in every entry point
#define SPLIT_ARGS                                                                     \
  int chunk, int E_max, const void *split_off, const void *split_items, const void *n_split, \
      void *acc, void *arrive
#define SPLIT_PASS chunk, E_max, split_off, split_items, n_split, acc, arrive

template <typename P, typename Mt>
static int grid_of(int grads_bf16, int D, int tb, long long items, long long* out) {
  const size_t smem = smem_bytes<P, Mt>(tb, D);
  if (D < 1 || tb < 8 || tb % 8 != 0 || items < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  long long ctas = 0;
  const int err = grads_bf16 ? grid_ctas<P, Mt, true>(smem, &ctas)
                             : grid_ctas<P, Mt, false>(smem, &ctas);
  if (err != 0) return err;
  *out = items < ctas ? items : ctas;
  return 0;
}

extern "C" {

int fused_adam_f32(FUSED_ADAM_ARGS, SPLIT_ARGS) {
  return launch<float, float>(FUSED_ADAM_PASS, nullptr, 0, SPLIT_PASS);
}

int fused_adam_f32p_bf16m(FUSED_ADAM_ARGS, SPLIT_ARGS) {
  return launch<float, __nv_bfloat16>(FUSED_ADAM_PASS, nullptr, 0, SPLIT_PASS);
}

int fused_adam_bf16p_bf16m(FUSED_ADAM_ARGS, SPLIT_ARGS) {
  return launch<__nv_bfloat16, __nv_bfloat16>(FUSED_ADAM_PASS, nullptr, 0, SPLIT_PASS);
}

// The same three with a row shard's place in the whole tables and the
// deterministic sum: row_base (HOST, n_levels entries) is the first row of
// each level's block in its whole table (its Philox groups are those of the
// whole table; nullptr = 0), det sums each row's entries in the prep's
// order instead of with atomics (and takes chunk 0).
int fused_adam_ex_f32(FUSED_ADAM_ARGS, const long long *row_base, int det, SPLIT_ARGS) {
  return launch<float, float>(FUSED_ADAM_PASS, row_base, det, SPLIT_PASS);
}

int fused_adam_ex_f32p_bf16m(FUSED_ADAM_ARGS, const long long *row_base, int det, SPLIT_ARGS) {
  return launch<float, __nv_bfloat16>(FUSED_ADAM_PASS, row_base, det, SPLIT_PASS);
}

int fused_adam_ex_bf16p_bf16m(FUSED_ADAM_ARGS, const long long *row_base, int det,
                              SPLIT_ARGS) {
  return launch<__nv_bfloat16, __nv_bfloat16>(FUSED_ADAM_PASS, row_base, det, SPLIT_PASS);
}

// The CTAs a launch of `items` work items (tiles, plus E_max with a work
// list) of variant 0 f32, 1 bf16 moments, 2 bf16 p takes on the current
// device: min(items, SMs x CTAs an SM holds).  Returns a CUDA error, or 0
// and *grid.
int fused_adam_grid(int variant, int grads_bf16, int D, int tb, long long items,
                    long long *grid) {
  if (variant == 0) return grid_of<float, float>(grads_bf16, D, tb, items, grid);
  if (variant == 1) return grid_of<float, __nv_bfloat16>(grads_bf16, D, tb, items, grid);
  if (variant == 2) return grid_of<__nv_bfloat16, __nv_bfloat16>(grads_bf16, D, tb, items, grid);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
