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
// for K1's one-level step, with all L levels' tables and each level's lr
// for K1's per-level step (fused_adam_levels: every row's result depends on
// its own level's entries and lr alone, so one launch gives the L per-level
// launches' step) and for K2.  Three entry points, one per table dtype
// combination the TPU kernels take:
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
// (C_l, D) buffers of their own, and so are its gradient entries g[l]
// (M_l, D): the TPU kernel's concatenated tables become one base pointer
// per level, so nothing is copied or gathered.  Level l's used head
// [0, n_used[l]) is cut into tiles of tb rows; the entry prep
// (csrc/entry_prep.cu, or its plain version) has binned the entries by
// tile: tile t's entries are positions [tile_off[t], tile_off[t + 1]) of
// rows (their GLOBAL rows, row_off[l] + r) and order (their index in the
// levels' entries concatenated; level l's start at ent_off[l]).  For every
// row r of every used head:
//     g = sum of the entries of row r          (0 for untouched rows)
//     m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2
//     p = p - lr[l] (m / bc1) / (sqrt(v / bc2) + eps)
// in place.  Untouched rows still decay (reference dense Adam).  Rows past a
// level's used head are never visited and stay bit-identical; the prep
// leaves trashbin and out-of-head entries out of every tile.  Every
// product, quotient, root and sum is rounded on its own (__fmul_rn and
// friends, no contraction into FMAs), as the plain torch version rounds, so
// on rows with at most one entry the float32 results equal it bit for bit.
//
// Stochastic rounding (bf16 p).  Output bits = (bits(p_new) + noise16) &
// 0xFFFF0000, non-finite values passed through: the operation of the XLA
// twin sr_round_bf16 (adam_kernel.py:778-789).  The 16 noise bits are a pure
// function of (seed, level, element index): Philox4x32-10 with counter
// (group lo, group hi, level, 0) and key (seed, 0x53524E44), one call per
// aligned group of 8 elements of a level (128 bits = 8 x 16); element 8 k + j
// takes bits 16 (j & 1) of word j >> 1.  ops/adam_kernel.philox_noise16 is
// the same function in torch.  The TPU kernel seeds its generator per tile
// (prng_seed(seed + t), :194); keying by element makes the result
// independent of the tile size and of the grid.
//
// Row shards (K2's row-sharded caller, fused_adam_packed_shard,
// adam_kernel.py:528).  A shard's tables are one contiguous row block of each
// level's table; the _ex entry points take each block's first row in its
// whole table, and the Philox counter counts groups from there, so a shard's
// stochastic rounding draws the bits the unsharded step draws for the same
// elements (0 on the unsharded path: its bits do not change).  A shard
// sweeps its whole blocks (n_used = the block's rows): rows no entry has
// reached hold zero moments and take an exact no-op step.
//
// Deterministic sum (det, the _ex entry points).  The atomics leave the
// order of a row's sum to the hardware, so two launches on the same entries
// may differ in the last bit where a row has two or more entries.  Replicas
// that must stay equal (data-parallel ranks updating the same tables) set
// det and pass a prep sorted by row inside each tile (the plain prep's
// stable sort; the wrappers refuse any other prep): the thread at the head
// of each row's run sums it in entry order, as index_add_ does on the CPU.
//
// Bound: memory bandwidth.  Per step the kernel reads and writes p, m and v
// over the used heads -- 24 B per table element for f32 p/m/v, 16 B for f32
// p with bf16 m/v, 12 B for bf16 p/m/v -- plus 8 + 4 D bytes per binned
// entry; ~13 flops per element (far below the f32 rate; Philox adds ~8
// integer multiplies per element with bf16 p).  At the smoke's used rows
// (3.18M + 3.07M + 2.40M rows x D 8): 1.76 / 1.17 / 0.88 GB, >= 0.53 / 0.35
// / 0.26 ms at 3.35 TB/s; chip_smoke.py recomputes each bound.
//
// Design, and what each choice does about the bound:
// - 16-byte sweep.  A tile is tb rows, tb a multiple of 8 (tile_rows in the
//   wrapper: 256 at D 8), so every tile starts on an aligned group of 8
//   elements whatever D is.  Each thread owns whole groups: two float4
//   loads and stores per f32 table, one 16-byte access per bf16 table (the
//   parent kernel's scalar 4-byte accesses left too few bytes in flight to
//   cover the memory latency).  A level whose element count is not a
//   multiple of 8 ends in a scalar tail group.
// - 128 threads a CTA, each holding two groups of its tile (2,048
//   elements, 8 KB of f32 sums) in registers as loaded (4 registers per
//   bf16 group), both loads issued before the tile's entries are summed:
//   the table stream overlaps the sum and its barriers, and twice the
//   bytes are in flight per thread.  In a trial on the card this beat 256
//   threads with one group each and 64 threads with four in every variant
//   (the bf16 ones most: their groups are half the bytes).
// - Per-tile ranges come from the prep (tile_off): two loads per CTA where
//   the parent kernel's thread 0 ran two serial binary searches (~36
//   dependent L2 round trips) while the CTA waited.  The prep bins by tile
//   in three small launches, which also replace the live sort.
// - Segmented sum: shared-memory atomics into a (tb, D) f32 tile.  Most
//   tiles hold a handful of entries; a tile with none skips the zeroing,
//   the sum and both barriers (its g is 0).
// - Gradients are read in place through order from the levels' own (M_l, D)
//   tensors (one pointer per level): no concatenated, gathered copy.
// - Stochastic rounding: the thread that owns a group makes that group's
//   one Philox call itself, so no noise is staged in shared memory.
// - One CTA a tile (~36k at the main path's sizes, 12,288 over a 4-shard
//   block), 8 KB of f32 sums each: 9 / 8 / 6 CTAs an SM, 56 / 64 / 78
//   registers (bf16 p / bf16 moments / f32; MinCtas).  What held each
//   variant back (scripts/probe_k2_shards.py, PERF.md §6): f32 streams at
//   83-88 % of its bytes bound with the arithmetic under the stream.  The
//   bf16 variants move fewer bytes an element, and their arithmetic alone
//   (the correctly rounded quotients and root, bf16 p's Philox) takes about
//   as long as their bytes (bf16 p at a 4-shard block: 0.100 ms against
//   0.105 streaming alone), so the two overlap only as far as the SM has
//   warps to issue from: one more CTA an SM took bf16 p from 65 % to 72 %
//   of its bound and bf16 moments from 79 % to 86 %.  A persistent grid
//   keeping the next tiles' tables in flight (a cp.async ring, TMA bulk
//   copies, or registers; scripts/probes/fused_adam_ring.cu) lost in every
//   variant and shape (its best form, TMA bulk copies at bf16 p, by 5-9 %):
//   its staging took registers and shared memory, an SM then held 2-5 CTAs,
//   and the arithmetic slowed more than the overlap gained.
// - Idle groups (finish_group): a group whose moments and summed gradient
//   are +0 (the headroom past a used head, most of a row shard's last
//   blocks) skips the quotients, the root and Philox, whose zero operands
//   took __fdiv_rn's and __fsqrt_rn's slow paths: a 4-shard block that was
//   mostly headroom took 0.187 ms against 0.142 for a full one (bf16 p,
//   before this path; 0.108 with it).  The same bits as the full step.
// - Entry-balanced grid (small, hot tables).  Where a level's used head is
//   a few tiles and each takes thousands of entries (4 levels of 1,024 -
//   286,720 used rows, 32,768 entries each: the RGB-D configs), one CTA a
//   tile leaves most SMs idle while a handful of CTAs serialise on their
//   shared-memory atomics.  The prep's work list (csrc/entry_prep.cu, its
//   chunk) splits a tile of n > chunk entries into k = ceil(n / chunk)
//   work items: the tile's own CTA sums the first chunk, k - 1 extra CTAs
//   (grid indices past the tiles, launched up to the host-known bound T +
//   M / chunk; those past the list's count exit) one chunk each.  Each
//   adds its shared-memory partial into the tile's f32 slot in global
//   memory (red.add, zeros skipped, so a hot row costs D atomics a CTA),
//   fences, and counts itself in; the last to arrive reads the slot, leaves
//   it and its counter at zero for the next launch, and runs the tile's
//   Adam sweep, loading the tables itself (so no host read and no second
//   launch; the groups every CTA prefetched are dead on this path, which
//   keeps the registers of the common path at their level before the work
//   list).  Tiles of at most chunk entries keep the path above.  chunk 0
//   (no work list, or det) is the one-CTA-a-tile grid: the deterministic
//   sum never splits a tile.
// - The split tiles' scratch (slots and counters) lives with the wrapper,
//   one buffer a device, zero between launches; launches on one stream
//   take turns on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#define MAX_LEVELS 16
#define THREADS 128
#define GPT 2  // groups of 8 elements a thread prefetches: 2,048-element tiles
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
  float idle_q[MAX_LEVELS];       // level l's quotient where m, v and g are +0
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
  int chunk;          // entries a work item sums; 0 = one CTA a tile
  int T;              // tiles: grid indices >= T are extra items
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
  for (int j = 0; j < 4; ++j) {  // one conversion of two values, each to nearest even
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    q[j] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(a) = make_uint4(q[0], q[1], q[2], q[3]);
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

// the bits of 8 loaded elements ORed: 0 when every one is +0
__device__ __forceinline__ unsigned bits_or(const Raw8<float>& r) {
  return __float_as_uint(r.a.x) | __float_as_uint(r.a.y) | __float_as_uint(r.a.z) |
         __float_as_uint(r.a.w) | __float_as_uint(r.b.x) | __float_as_uint(r.b.y) |
         __float_as_uint(r.b.z) | __float_as_uint(r.b.w);
}
__device__ __forceinline__ unsigned bits_or(const Raw8<__nv_bfloat16>& r) {
  return r.a.x | r.a.y | r.a.z | r.a.w;
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

// An idle group: m, v and the summed gradient all +0 (rows no entry reached
// and whose moments are zero: the headroom past a used head, most of a row
// shard's blocks).  Its step keeps m = v = +0 and takes p - idle_q, where
// idle_q = lr (0 / bc1) / (sqrt(0 / bc2) + eps) is +0 for every sane lr and
// eps (launch computes it on the host with the same IEEE single operations),
// so it skips the quotients and the root, whose zero operands take
// __fdiv_rn's and __fsqrt_rn's slow paths, and Philox: idle_q is a zero or
// NaN, so p - idle_q is a bf16 value or not finite, which the noise cannot
// move.  The same bits as the full step.
template <typename P, typename Mt>
__device__ __forceinline__ void finish_group(const Group<P, Mt>& r, P* p, Mt* m, Mt* v,
                                             int e0, int n, const float* gt, float lr,
                                             float idle_q, const Hyper& h, long long grp,
                                             int level, unsigned seed) {
  float pf[8], mf[8], vf[8], g[8];
  unpack(r.p, pf);
  unpack(r.m, mf);
  unpack(r.v, vf);
  unsigned gbits = 0;
  if (gt != nullptr) {
    load8(gt + e0, g);  // shared memory; the tile is a whole number of groups
#pragma unroll
    for (int j = 0; j < 8; ++j) gbits |= __float_as_uint(g[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) g[j] = 0.f;
  }
  const bool idle = (gbits | bits_or(r.m) | bits_or(r.v)) == 0u;
  if (idle) {
#pragma unroll
    for (int j = 0; j < 8; ++j) pf[j] = __fsub_rn(pf[j], idle_q);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) adam1(pf[j], mf[j], vf[j], g[j], lr, h);
  }
  if constexpr (std::is_same<P, __nv_bfloat16>::value) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (!idle)
      w = philox4x32_10(make_uint4((unsigned)grp, (unsigned)(grp >> 32), (unsigned)level, 0u),
                        make_uint2(seed, 0x53524E44u));
    const unsigned q[4] = {w.x, w.y, w.z, w.w};
    unsigned short b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = sr_bits(pf[j], q[j >> 1] >> ((j & 1) * 16));
    if (n == 8) {
      *reinterpret_cast<uint4*>(p + e0) =
          make_uint4(b[0] | ((unsigned)b[1] << 16), b[2] | ((unsigned)b[3] << 16),
                     b[4] | ((unsigned)b[5] << 16), b[6] | ((unsigned)b[7] << 16));
    } else {
      for (int j = 0; j < n; ++j) p[e0 + j] = __ushort_as_bfloat16(b[j]);
    }
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

// the tile's atomics sum of entries [lo, hi) into the zeroed (tb, D) tile;
// eo (the level's first entry) and row0 (the tile's first global row) are
// below 2^31 (the wrapper refuses more entries or rows)
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

// CTAs an SM must hold at once (the registers a thread may take follow),
// set by scripts/probe_k2_shards.py on the card (PERF.md §6): bf16 p 9
// CTAs, 56 registers (20 bytes spilled), 10-12.5 % faster than at 8 (60
// registers) at K2's unsharded and row-shard launches, where its
// arithmetic needs the warps; 10 (48 registers, 84 bytes spilled) was 1-2
// % behind 9, 11-12 (40, 288 bytes) 10-12 % behind 8.  bf16 moments 8
// CTAs, 64 registers, 7-8 % faster than at 7 (69), 9 no faster.  f32 6
// CTAs, 78 registers: it streams at 85-88 % of its bound, and 8 was 17-20
// % slower.  (A bound of 1 let f32 take 135 registers, 30 % slower; and
// the work list's path keeps its own sweep so that it does not raise the
// common path's registers.)
template <typename P, typename Mt>
struct MinCtas {
  static constexpr int value = std::is_same<P, __nv_bfloat16>::value ? 9
                               : std::is_same<Mt, __nv_bfloat16>::value ? 8 : 6;
};

// THREADS threads a CTA; each prefetches GPT groups of its tile (the whole
// of a 2,048-element tile) before the entries are summed.  Grid: one CTA a
// tile, then (sp.chunk > 0) the work list's extra items
template <typename P, typename Mt, bool GRADS_BF16>
__global__ void __launch_bounds__(THREADS, MinCtas<P, Mt>::value) fused_adam_kernel(
    const int* __restrict__ rows, const int* __restrict__ order,
    const int* __restrict__ tile_off, int D, int tb, Levels lv, Hyper h, unsigned seed,
    int det, Split sp) {
  extern __shared__ float4 smem4[];
  float* gtile = reinterpret_cast<float*>(smem4);
  __shared__ int s_last;

  int t = blockIdx.x, j = 0;
  if (t >= sp.T) {  // an extra work item
    const int e = t - sp.T;
    if (e >= *sp.count) return;  // past the list: the grid is its upper bound
    const int2 w = sp.items[e];
    t = w.x;
    j = w.y;
  }
  int l = 0;
  while (l + 1 < lv.n_levels && t >= lv.tile_lo[l + 1]) ++l;
  const long long k = t - lv.tile_lo[l];
  const long long left = lv.n_used[l] - k * tb;
  const int nel = (int)(left < tb ? left : tb) * D;  // the tile's elements
  const int n_groups = (nel + 7) >> 3;
  const long long base = k * tb * D;  // the tile's first element in level l
  P* __restrict__ p = static_cast<P*>(lv.p[l]) + base;
  Mt* __restrict__ m = static_cast<Mt*>(lv.m[l]) + base;
  Mt* __restrict__ v = static_cast<Mt*>(lv.v[l]) + base;

  // this thread's first GPT groups, in flight while the entries are summed
  Group<P, Mt> r[GPT];
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    const int q = threadIdx.x + i * THREADS;
    if (q < n_groups) load_group(r[i], p, m, v, q << 3, min(8, nel - (q << 3)));
  }

  const int lo = tile_off[t], hi = tile_off[t + 1];
  const bool touched = hi > lo;  // the same for the whole CTA
  const int row0 = (int)(lv.row_off[l] + k * tb);  // global, as the entries
  const float* __restrict__ g = lv.g[l];
  const int eo = (int)lv.ent_off[l];
  const int n4 = (tb * D) >> 2;  // tb * D is a multiple of 8
  if (sp.chunk > 0 && hi - lo > sp.chunk) {
    // a split tile: this item sums its chunk, the partial goes to the
    // tile's slot, and the last item to arrive sweeps the tile with groups
    // of its own (the prefetched ones are dead here, which keeps the
    // registers of the path below those it had before the work list)
    for (int e = threadIdx.x; e < n4; e += THREADS) smem4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const int klo = lo + j * sp.chunk;
    sum_atomic<GRADS_BF16>(gtile, rows, order, g, eo, row0, klo, min(hi, klo + sp.chunk), D);
    __syncthreads();
    const int slot = sp.off[t];
    float* acc = sp.acc + (long long)slot * tb * D;
    for (int e = threadIdx.x; e < tb * D; e += THREADS) {
      const float x = gtile[e];
      if (x != 0.f) atomicAdd(acc + e, x);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(sp.arrive + slot, 1) == (hi - lo - 1) / sp.chunk;
    __syncthreads();
    if (!s_last) return;
    __threadfence();  // the other items' adds, before the slot is read
    float4* acc4 = reinterpret_cast<float4*>(acc);
    for (int e = threadIdx.x; e < n4; e += THREADS) {
      smem4[e] = __ldcg(acc4 + e);
      __stcg(acc4 + e, make_float4(0.f, 0.f, 0.f, 0.f));  // zero for the next launch
    }
    if (threadIdx.x == 0) sp.arrive[slot] = 0;
    __syncthreads();
    const float lr = lv.lr[l];
    const long long grp0 = lv.grp_base[l] + (base >> 3);
    for (int q = threadIdx.x; q < n_groups; q += THREADS) {
      Group<P, Mt> x;
      load_group(x, p, m, v, q << 3, min(8, nel - (q << 3)));
      finish_group(x, p, m, v, q << 3, min(8, nel - (q << 3)), gtile, lr, lv.idle_q[l], h,
                   grp0 + q, l, seed);
    }
    return;
  }
  if (touched) {
    for (int e = threadIdx.x; e < n4; e += THREADS) smem4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
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
        for (int i = jj; i < hi && rows[i] == rr; ++i) {
          float gv = g[(long long)(order[i] - eo) * D + d];
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

  const float lr = lv.lr[l];
  const long long grp0 = lv.grp_base[l] + (base >> 3);
  const float* gt = touched ? gtile : nullptr;
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    const int q = threadIdx.x + i * THREADS;
    if (q < n_groups)
      finish_group(r[i], p, m, v, q << 3, min(8, nel - (q << 3)), gt, lr, lv.idle_q[l], h,
                   grp0 + q, l, seed);
  }
  // tiles of more than GPT * THREADS groups (D > 256, where tb is 8 rows)
  for (int q = threadIdx.x + GPT * THREADS; q < n_groups; q += THREADS) {
    Group<P, Mt> x;
    load_group(x, p, m, v, q << 3, min(8, nel - (q << 3)));
    finish_group(x, p, m, v, q << 3, min(8, nel - (q << 3)), gt, lr, lv.idle_q[l], h, grp0 + q,
                 l, seed);
  }
}

template <typename P, typename Mt, bool GB>
static int launch_t(unsigned grid, size_t smem, cudaStream_t s, const int* rows,
                    const int* order, const int* tile_off, int D, int tb, const Levels& lv,
                    const Hyper& h, unsigned seed, int det, const Split& sp) {
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(fused_adam_kernel<P, Mt, GB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_adam_kernel<P, Mt, GB><<<grid, THREADS, smem, s>>>(rows, order, tile_off, D, tb, lv,
                                                            h, seed, det, sp);
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
  const size_t smem = (size_t)tb * D * sizeof(float);
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
    // an idle element's quotient (finish_group), IEEE single as the kernel's
    lv.idle_q[l] = (lr[l] * (0.f / bc1)) / (sqrtf(0.f / bc2) + eps);
    tiles += (n_used[l] + tb - 1) / tb;
  }
  const long long grid = tiles + (chunk > 0 ? E_max : 0);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lv.tile_lo[n_levels] = (int)tiles;
  lv.n_levels = n_levels;
  const Hyper h{b1, b2, omb1, omb2, bc1, bc2, eps};
  const Split sp{static_cast<const int*>(split_off), static_cast<const int2*>(split_items),
                 static_cast<const int*>(n_split), static_cast<float*>(acc),
                 static_cast<int*>(arrive), chunk, (int)tiles};
  if (tiles > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int err = grads_bf16
        ? launch_t<P, Mt, true>((unsigned)grid, smem, s, rows, order, tile_off, D, tb, lv, h,
                                seed, det, sp)
        : launch_t<P, Mt, false>((unsigned)grid, smem, s, rows, order, tile_off, D, tb, lv, h,
                                 seed, det, sp);
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

}  // extern "C"
