// Windowed segmented sum + dense Adam on a packed (R, 128) float32 table,
// sm_90a: the one-hot kernels of the kernel-study scripts.
//
// Replaces the TPU kernels
//   K3  _fused_kernel            experiments/exp_fused_adam.py:58
//   K4  make_kernel(...).kernel  experiments/exp_pallas_debug.py:41 (six
//                                variants: copy, sweep, window, onehot,
//                                dot_bf16, dot_hi)
//   K5  _kernel4                 experiments/exp_pallas_trainer.py:310 (K1's
//                                body plus a copy of the new p in f32 or bf16)
// All three compute one function, so this file holds ONE kernel template
// with the mode and the copy's type as compile-time switches; the wrapper
// is shine_mapping_tpu_torch/ops/onehot_adam.py.
//
// What it computes.  p, m, v are (C, 8) float32 tables seen as R = C / 16
// packed rows of 128 lanes (the same buffer: no layout change).  Gradient
// entries arrive sorted by packed row: ids[j] is entry j's packed row (or,
// in the NARROW mode of K3, its corner row, whose packed row is id >> 4 and
// whose 8 values land in lanes (id & 15) * 8 ...), negative for padding.
// Tile t covers packed rows [t tb, (t + 1) tb) and sees only the entries of
// its window [offs[t] w, offs[t] w + 2 w): an entry of the tile outside it
// is dropped, as the TPU kernel's one-hot product over its two window
// blocks drops it (no check, no fallback; the wrapper exports windows_ok).
// For every packed row of every tile:
//     g = sum of its window entries' lanes          (0 for untouched rows)
//     m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g g
//     p = p - lr (m / bc1) / (sqrt(v / bc2) + eps)
// written to po, mo, vo (fresh outputs for K3/K4; the inputs themselves for
// K5, in place), and for K5 also pc = p as float32 or bfloat16 (round to
// nearest even).  The arithmetic is float32 with every product, quotient,
// root and sum rounded on its own (no contraction), so the kernel matches
// the plain torch version bit for bit wherever the sum's order does not
// matter.  K4's variants:
//   COPY      po, mo, vo = p, m, v (the bytes really move: fresh outputs)
//   SWEEP     g = 0
//   WINDOW    reads the tile's window (ids and the hi lanes), folds their sum
//             into g as sum * zero, zero a run-time 0 the compiler cannot drop
//   ONEHOT    finds each row's run in the window (the membership work) and
//             folds its length into g as count * zero
//   DOT_BF16  g = sum of the hi parts + sum of the lo parts (K1's hi + lo sum)
//   DOT_HI    g = sum of (hi + lo) in float32
//   NARROW    K3: narrow (M, 8) float32 gradients, g = their f32 sum
//
// Design.  A persistent grid (the SMs times the CTAs resident on one, for
// the launch's shared memory, computed once per device and size) walks the
// tiles; 8 warps a CTA.  At each tile the CTA stages the window's 2 w ids
// in shared memory (padding mapped past every row, so the window stays
// sorted), then each warp walks its rows of the tile (every 8th): it
// binary-searches the row's run in the staged ids, sums the run's 128
// lanes in f32 with 4 lanes a thread (16-byte loads of f32, 8-byte loads of
// 4 bf16), and applies Adam to those 4 lanes of p, m and v.  The TPU's
// one-hot product over a (tb, w) 0/1 matrix is a run lookup here: the
// entries are sorted, so a row's entries are contiguous.
//
// The stream of p, m and v is what the kernel's time is made of.  Each
// warp has U = AHEAD + 1 rows of them in registers: row r + 1's 16-byte
// loads are issued before row r's stores, written out in that order in the
// source (K5 updates in place, where a lane reads an address before it
// writes it, so the pointers may not be declared __restrict__), and a
// tile's first rows are loaded before its window is staged.  Fresh outputs
// (K3, K4) are stored with the streaming hint (__stcs) and their inputs,
// read once, loaded with it (__ldcs, a coherent load: a launch whose
// outputs are its inputs stays right); K5's in-place tables use plain
// loads and stores, its copy of p __stcs.  U = 3 or 4 spends registers
// (64-76 a thread) that cost K5 a wave of CTAs and gain the others at most
// 1.4% (scripts/probe_study_kernels.py).
//
// COPY needs no window and no row of another table, so it is its own
// kernel, copy_tma_kernel below: TMA bulk copies through shared memory,
// table after table.  It is 1-3% faster than the same copy by 16-byte
// vector loads and stores (scripts/probes/copy_vector.cu).
//
// Bound.  Memory bandwidth: p, m, v read and written once (24 B per
// element, 805 MB at C = 4,194,304), plus the entries (36 B each for K3's
// narrow gradients; 512 B of hi + lo lanes per padded entry for the dot
// variants and K5) and K5's copy (4 or 2 B per element); ~15 flops per
// element, far below the f32 rate.  chip_smoke.py computes each bound from
// the shapes it runs.  Later work: the tensor-core form of the one-hot sum
// (a bf16 mma over a 0/1 A operand, exact) for windows much denser than
// the bench's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

#define THREADS 256
#define WARPS (THREADS / 32)
// shared memory a launch may take without opting in: the 2 w window ids
// (dynamic) and s_red (static) must fit together
#define SMEM_LIMIT (48 * 1024)
#define STATIC_SMEM (WARPS * sizeof(float))
// U - 1: the rows after the one a warp works on whose p, m, v are loaded
// before that row's stores (U rows in registers)
#define AHEAD 1
// COPY's ring: stages of COPY_CHUNK bytes in shared memory (opted in above
// the 48 KB a launch takes by default)
#define COPY_STAGES 4
#define COPY_CHUNK (32 * 1024)
#define COPY_SMEM (COPY_STAGES * COPY_CHUNK)

enum Mode { COPY = 0, SWEEP, WINDOW, ONEHOT, DOT_BF16, DOT_HI, NARROW, N_MODES };
enum Copy { PC_NONE = 0, PC_F32, PC_BF16, N_COPIES };

struct Params {
  float lr, bc1, bc2;  // used when scal is null
  float b1, b2, omb1, omb2, eps;
  float zero;          // a run-time 0.0 (WINDOW, ONEHOT)
  long long n_ids;     // entries in ids (window slots outside [0, n_ids) are absent)
};

// first index i in sorted a[0, n) with a[i] >= key
__device__ __forceinline__ int lower_bound(const int* a, int n, long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// 4 consecutive bf16 (8 bytes) widened to float (exact)
__device__ __forceinline__ float4 ld4_bf16(const __nv_bfloat16* a) {
  const uint2 u = *reinterpret_cast<const uint2*>(a);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
}

// one element's Adam step, each operation rounded on its own
__device__ __forceinline__ void adam(float p, float m, float v, float g, float lr,
                                     float bc1, float bc2, const Params& a,
                                     float& po, float& mo, float& vo) {
  mo = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  vo = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vo, bc2)), a.eps);
  po = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, __fdiv_rn(mo, bc1)), den));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <bool FRESH>
__device__ __forceinline__ float4 ld_in(const float* a) {
  const float4* q = reinterpret_cast<const float4*>(a);
  return FRESH ? __ldcs(q) : *q;
}

template <bool FRESH>
__device__ __forceinline__ void st_out(float* a, const float4 x) {
  if (FRESH) __stcs(reinterpret_cast<float4*>(a), x);
  else *reinterpret_cast<float4*>(a) = x;
}

// COPY: p, m and v copied to po, mo and vo by TMA bulk copies through
// shared memory.  One thread a CTA drives a ring of COPY_STAGES chunks of
// COPY_CHUNK bytes: cp.async.bulk global -> shared completing on the
// stage's mbarrier, then cp.async.bulk shared -> global in a bulk group
// with an L2 evict-first policy; a stage is loaded again once the store of
// its last chunk has read it (wait_group.read 1), so COPY_STAGES - 1
// chunks' loads stay in flight beside the stores.  The persistent grid
// walks the 3 bytes / COPY_CHUNK chunks, table after table, CTA b taking
// chunks b, b + grid, ...
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__global__ void __launch_bounds__(32) copy_tma_kernel(const float* p, const float* m,
                                                      const float* v, float* po, float* mo,
                                                      float* vo, long long bytes) {
  extern __shared__ __align__(16) unsigned char ring[];  // 16 B: cp.async.bulk's alignment
  __shared__ __align__(8) unsigned long long bar[COPY_STAGES];
  if (threadIdx.x != 0) return;
  const char* src[3] = {reinterpret_cast<const char*>(p), reinterpret_cast<const char*>(m),
                        reinterpret_cast<const char*>(v)};
  char* dst[3] = {reinterpret_cast<char*>(po), reinterpret_cast<char*>(mo),
                  reinterpret_cast<char*>(vo)};
  const long long per = (bytes + COPY_CHUNK - 1) / COPY_CHUNK;  // chunks a table
  const long long total = 3 * per;
  const long long mine =
      blockIdx.x < total ? (total - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  for (int s = 0; s < COPY_STAGES; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[s]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // the outputs are not read again here: their lines leave L2 first
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(evict_first));

  // this CTA's chunk i: its table, offset and size
  auto where = [&](long long i, int& t, long long& off, uint32_t& nb) {
    const long long c = blockIdx.x + i * gridDim.x;
    t = (int)(c / per);
    off = (c % per) * COPY_CHUNK;
    const long long left = bytes - off;
    nb = (uint32_t)(left < COPY_CHUNK ? left : COPY_CHUNK);
  };
  auto load = [&](long long i) {
    int t;
    long long off;
    uint32_t nb;
    where(i, t, off, nb);
    const int s = (int)(i % COPY_STAGES);
    const uint32_t b = smem_addr(&bar[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(nb)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(ring + (size_t)s * COPY_CHUNK)),
        "l"(src[t] + off), "r"(nb), "r"(b)
        : "memory");
  };

  for (long long i = 0; i < mine && i < COPY_STAGES; ++i) load(i);
  for (long long i = 0; i < mine; ++i) {
    const int s = (int)(i % COPY_STAGES);
    wait_parity(smem_addr(&bar[s]), (uint32_t)((i / COPY_STAGES) & 1));
    int t;
    long long off;
    uint32_t nb;
    where(i, t, off, nb);
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(
            dst[t] + off),
        "r"(smem_addr(ring + (size_t)s * COPY_CHUNK)), "r"(nb), "l"(evict_first)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (i >= 1 && i - 1 + COPY_STAGES < mine) {  // refill chunk i - 1's stage
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i - 1 + COPY_STAGES);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int MODE, int PC>
__global__ void __launch_bounds__(THREADS) onehot_adam_kernel(
    const float* p, const float* m, const float* v, float* po, float* mo, float* vo,
    void* pc, const int* __restrict__ ids, const void* __restrict__ g0,
    const void* __restrict__ g1, const int* __restrict__ offs,
    const float* __restrict__ scal, Params a, int T, int tb, int w) {
  // K3/K4 write fresh outputs (stream hints on p, m, v and the outputs); K5
  // (a copy of p) updates p, m, v in place (plain loads and stores)
  constexpr bool FRESH = PC == PC_NONE;
  static_assert(MODE != COPY, "COPY is copy_tma_kernel");
  extern __shared__ int s_ids[];  // the window's 2 w ids, padding -> INT_MAX
  __shared__ float s_red[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = 2 * w;
  // this warp's rows of a tile: warp + i WARPS for i < nr
  const int nr = tb > warp ? (tb - warp + WARPS - 1) / WARPS : 0;
  float lr = a.lr, bc1 = a.bc1, bc2 = a.bc2;
  if (scal != nullptr) {
    lr = scal[0];
    bc1 = scal[1];
    bc2 = scal[2];
  }

  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const long long row0 = (long long)t * tb + warp;  // this warp's first row
    // the rows ahead: row i's p, m, v sit in slot i % AHEAD from AHEAD rows
    // before row i is reached until its new values are made; the tile's
    // first AHEAD rows go out before its window is staged
    float4 pi[AHEAD], mi[AHEAD], vi[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (k < nr) {
        const long long off = (row0 + (long long)k * WARPS) * 128 + lane * 4;
        pi[k] = ld_in<FRESH>(p + off);
        mi[k] = ld_in<FRESH>(m + off);
        vi[k] = ld_in<FRESH>(v + off);
      }
    }

    const long long base = (long long)offs[t] * w;  // the window's first entry
    float gw = 0.f;  // WINDOW: the window's sum times zero
    if (MODE >= WINDOW) {
      __syncthreads();  // every warp is done with the last tile's window
      float touch = 0.f;
      for (int e = threadIdx.x; e < n; e += THREADS) {
        const long long j = base + e;
        const bool in = j >= 0 && j < a.n_ids;
        const int r = in ? ids[j] : -1;
        if (MODE == WINDOW) touch += (float)r;
        s_ids[e] = r < 0 ? INT_MAX : r;
      }
      if (MODE == WINDOW) {
        // the hi lanes of both window blocks, 4 bf16 a load
        const __nv_bfloat16* gh = static_cast<const __nv_bfloat16*>(g0);
        long long lo_e = base < 0 ? 0 : base;
        long long hi_e = base + n < a.n_ids ? base + n : a.n_ids;
        for (long long q = lo_e * 32 + threadIdx.x; q < hi_e * 32; q += THREADS) {
          const float4 x = ld4_bf16(gh + q * 4);
          touch += (x.x + x.y) + (x.z + x.w);
        }
        for (int o = 16; o > 0; o >>= 1) touch += __shfl_xor_sync(0xffffffffu, touch, o);
        if (lane == 0) s_red[warp] = touch;
      }
      __syncthreads();
      if (MODE == WINDOW) {
        float s = 0.f;
        for (int k = 0; k < WARPS; ++k) s += s_red[k];
        gw = s * a.zero;
      }
    }

    for (int i0 = 0; i0 < nr; i0 += AHEAD) {
#pragma unroll
      for (int k = 0; k < AHEAD; ++k) {
        const int i = i0 + k;
        if (i >= nr) break;
        const long long row = row0 + (long long)i * WARPS;
        const long long off = row * 128 + lane * 4;
        float4 g = make_float4(gw, gw, gw, gw);
        if (MODE >= ONEHOT) {
          const long long k0 = MODE == NARROW ? row * 16 : row;
          const long long k1 = MODE == NARROW ? row * 16 + 16 : row + 1;
          const int jlo = lower_bound(s_ids, n, k0), jhi = lower_bound(s_ids, n, k1);
          if (MODE == ONEHOT) {
            const float c = (float)(jhi - jlo) * a.zero;
            g = make_float4(c, c, c, c);
          } else if (MODE == DOT_BF16) {
            const __nv_bfloat16* gh = static_cast<const __nv_bfloat16*>(g0);
            const __nv_bfloat16* gl = static_cast<const __nv_bfloat16*>(g1);
            float4 sh = make_float4(0.f, 0.f, 0.f, 0.f), sl = sh;
            for (int j = jlo; j < jhi; ++j) {
              const long long e = (base + j) * 128 + lane * 4;
              add4(sh, ld4_bf16(gh + e));
              add4(sl, ld4_bf16(gl + e));
            }
            g = sh;
            add4(g, sl);
          } else if (MODE == DOT_HI) {
            const __nv_bfloat16* gh = static_cast<const __nv_bfloat16*>(g0);
            const __nv_bfloat16* gl = static_cast<const __nv_bfloat16*>(g1);
            for (int j = jlo; j < jhi; ++j) {
              const long long e = (base + j) * 128 + lane * 4;
              float4 x = ld4_bf16(gh + e);
              add4(x, ld4_bf16(gl + e));
              add4(g, x);
            }
          } else {  // NARROW: entry j's 8 values sit in lanes (id & 15) * 8 ...
            const float* gn = static_cast<const float*>(g0);
            for (int j = jlo; j < jhi; ++j) {
              if ((s_ids[j] & 15) == (lane >> 1))
                add4(g, *reinterpret_cast<const float4*>(gn + (base + j) * 8 + (lane & 1) * 4));
            }
          }
        }
        float4 pn, mn, vn;
        adam(pi[k].x, mi[k].x, vi[k].x, g.x, lr, bc1, bc2, a, pn.x, mn.x, vn.x);
        adam(pi[k].y, mi[k].y, vi[k].y, g.y, lr, bc1, bc2, a, pn.y, mn.y, vn.y);
        adam(pi[k].z, mi[k].z, vi[k].z, g.z, lr, bc1, bc2, a, pn.z, mn.z, vn.z);
        adam(pi[k].w, mi[k].w, vi[k].w, g.w, lr, bc1, bc2, a, pn.w, mn.w, vn.w);
        // the row AHEAD later: its loads go out before this row's stores (in
        // place, each lane reads an address before it writes it)
        if (i + AHEAD < nr) {
          const long long nxt = off + (long long)AHEAD * WARPS * 128;
          pi[k] = ld_in<FRESH>(p + nxt);
          mi[k] = ld_in<FRESH>(m + nxt);
          vi[k] = ld_in<FRESH>(v + nxt);
        }
        st_out<FRESH>(po + off, pn);
        st_out<FRESH>(mo + off, mn);
        st_out<FRESH>(vo + off, vn);
        if (PC == PC_F32) {
          __stcs(reinterpret_cast<float4*>(static_cast<float*>(pc) + off), pn);
        } else if (PC == PC_BF16) {
          __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(pc) + off),
                 make_uint2(pack_bf16(pn.x, pn.y), pack_bf16(pn.z, pn.w)));
        }
      }
    }
  }
}

// Dynamic shared memory of a launch: the 2 w staged ids of a window mode.
template <int MODE>
static size_t smem_of(int w) {
  return MODE >= WINDOW ? (size_t)2 * w * sizeof(int) : 0;
}

// The CTAs of the persistent grid for one instantiation and its dynamic
// shared memory on the current device: the SMs times the CTAs resident on
// one, computed once per (device, shared memory size).
template <int MODE, int PC>
static cudaError_t resident_ctas(int w, int* ctas) {
  const size_t smem = smem_of<MODE>(w);
  static std::mutex lock;
  static int dev_cached = -1, ctas_cached = 0;
  static size_t smem_cached = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> guard(lock);
  if (dev != dev_cached || smem != smem_cached) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if constexpr (MODE == COPY) {
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(copy_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 COPY_SMEM);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, copy_tma_kernel, 32,
                                                          COPY_SMEM);
    } else {
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, onehot_adam_kernel<MODE, PC>,
                                                          THREADS, smem);
    }
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    dev_cached = dev;
    smem_cached = smem;
    ctas_cached = sms * per_sm;
  }
  *ctas = ctas_cached;
  return cudaSuccess;
}

template <int MODE, int PC>
static cudaError_t launch_t(int T, cudaStream_t s, const float* p, const float* m,
                            const float* v, float* po, float* mo, float* vo, void* pc,
                            const int* ids, const void* g0, const void* g1, const int* offs,
                            const float* scal, Params a, int tb, int w) {
  int ctas = 0;
  const cudaError_t e = resident_ctas<MODE, PC>(w, &ctas);
  if (e != cudaSuccess) return e;
  if constexpr (MODE == COPY) {
    const long long bytes = (long long)T * tb * 128 * sizeof(float);  // a table's
    const long long chunks = 3 * ((bytes + COPY_CHUNK - 1) / COPY_CHUNK);
    copy_tma_kernel<<<(unsigned)(chunks < ctas ? chunks : ctas), 32, COPY_SMEM, s>>>(
        p, m, v, po, mo, vo, bytes);
  } else {
    const unsigned blocks = (unsigned)(T < ctas ? T : ctas);
    onehot_adam_kernel<MODE, PC><<<blocks, THREADS, smem_of<MODE>(w), s>>>(
        p, m, v, po, mo, vo, pc, ids, g0, g1, offs, scal, a, T, tb, w);
  }
  return cudaSuccess;
}

// Calls F<MODE, PC>(args...) for a run-time (mode, pc_kind) that
// onehot_adam accepts.
#define ONEHOT_DISPATCH(F, ...)                                              \
  switch (mode) {                                                            \
    case COPY: e = F<COPY, PC_NONE>(__VA_ARGS__); break;                     \
    case SWEEP: e = F<SWEEP, PC_NONE>(__VA_ARGS__); break;                   \
    case WINDOW: e = F<WINDOW, PC_NONE>(__VA_ARGS__); break;                 \
    case ONEHOT: e = F<ONEHOT, PC_NONE>(__VA_ARGS__); break;                 \
    case DOT_BF16:                                                           \
      if (pc_kind == PC_F32) e = F<DOT_BF16, PC_F32>(__VA_ARGS__);           \
      else if (pc_kind == PC_BF16) e = F<DOT_BF16, PC_BF16>(__VA_ARGS__);    \
      else e = F<DOT_BF16, PC_NONE>(__VA_ARGS__);                            \
      break;                                                                 \
    case DOT_HI: e = F<DOT_HI, PC_NONE>(__VA_ARGS__); break;                 \
    default: e = F<NARROW, PC_NONE>(__VA_ARGS__); break;                     \
  }

static bool valid(int mode, int pc_kind, int w) {
  return mode >= 0 && mode < N_MODES && pc_kind >= 0 && pc_kind < N_COPIES &&
         (pc_kind == PC_NONE || mode == DOT_BF16) && w >= 1 &&
         (size_t)2 * w * sizeof(int) + STATIC_SMEM <= SMEM_LIMIT;
}

extern "C" {

// Launches the step on `stream`; returns cudaGetLastError() (0 = launched).
// mode: enum Mode; pc_kind: enum Copy (a copy only with DOT_BF16, as K5).
// scal: device float[>= 3] {lr, bc1, bc2}, or null to take lr/bc1/bc2.
// T tiles of tb packed rows; windows of w entries (2 w ids plus STATIC_SMEM
// within SMEM_LIMIT, so w <= 6140); n_ids entries in ids.  The outputs are
// fresh buffers, or (K5) the inputs themselves.
int onehot_adam(int mode, int pc_kind, const void* p, const void* m, const void* v,
                void* po, void* mo, void* vo, void* pc, const void* ids,
                const void* g0, const void* g1, const void* offs, const void* scal,
                float lr, float bc1, float bc2, float b1, float b2, float omb1,
                float omb2, float eps, float zero, int T, int tb, int w,
                long long n_ids, void* stream) {
  if (!valid(mode, pc_kind, w) || T < 0 || tb < 1) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  const Params a{lr, bc1, bc2, b1, b2, omb1, omb2, eps, zero, n_ids};
  cudaError_t e = cudaSuccess;
  ONEHOT_DISPATCH(launch_t, T, (cudaStream_t)stream, static_cast<const float*>(p),
                  static_cast<const float*>(m), static_cast<const float*>(v),
                  static_cast<float*>(po), static_cast<float*>(mo), static_cast<float*>(vo), pc,
                  static_cast<const int*>(ids), g0, g1, static_cast<const int*>(offs),
                  static_cast<const float*>(scal), a, tb, w)
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The CTAs of the persistent grid a launch of (mode, pc_kind) with windows
// of w entries takes on the current device when it has at least that many
// tiles, or -1 on an error.
int onehot_adam_ctas(int mode, int pc_kind, int w) {
  if (!valid(mode, pc_kind, w)) return -1;
  int ctas = 0;
  cudaError_t e = cudaSuccess;
  ONEHOT_DISPATCH(resident_ctas, w, &ctas)
  return e == cudaSuccess ? ctas : -1;
}

}  // extern "C"
