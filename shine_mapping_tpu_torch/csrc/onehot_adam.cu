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
// Design.  One CTA per tile, 8 warps.  The CTA stages the window's 2 w ids
// in shared memory (padding mapped past every row, so the window stays
// sorted), then each warp takes one packed row at a time: it binary-
// searches the row's run in the staged ids, sums the run's 128 lanes in f32
// with 4 lanes a thread (16-byte loads of f32, 8-byte loads of 4 bf16), and
// applies Adam to those 4 lanes of p, m and v with 16-byte loads and
// stores.  The TPU's one-hot product over a (tb, w) 0/1 matrix is a run
// lookup here: the entries are sorted, so a row's entries are contiguous.
//
// Bound.  Memory bandwidth: p, m, v read and written once (24 B per
// element, 805 MB at C = 4,194,304), plus the entries (36 B each for K3's
// narrow gradients; 512 B of hi + lo lanes per padded entry for the dot
// variants and K5) and K5's copy (4 or 2 B per element); ~15 flops per
// element, far below the f32 rate.  chip_smoke.py computes each bound from
// the shapes it runs.  Later work: the tensor-core form of the one-hot sum
// (a bf16 mma over a 0/1 A operand, exact) for windows much denser than
// the bench's, and a persistent grid with cp.async staging of the tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#define THREADS 256
#define WARPS (THREADS / 32)
// shared memory a launch may take without opting in: the 2 w window ids
// (dynamic) and s_red (static) must fit together
#define SMEM_LIMIT (48 * 1024)
#define STATIC_SMEM (WARPS * sizeof(float))

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

template <int MODE, int PC>
__global__ void __launch_bounds__(THREADS) onehot_adam_kernel(
    const float* p, const float* m, const float* v, float* po, float* mo, float* vo,
    void* pc, const int* __restrict__ ids, const void* __restrict__ g0,
    const void* __restrict__ g1, const int* __restrict__ offs,
    const float* __restrict__ scal, Params a, int tb, int w) {
  extern __shared__ int s_ids[];  // the window's 2 w ids, padding -> INT_MAX
  __shared__ float s_red[WARPS];
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = 2 * w;
  const long long base = (long long)offs[t] * w;  // the window's first entry
  float lr = a.lr, bc1 = a.bc1, bc2 = a.bc2;
  if (scal != nullptr) {
    lr = scal[0];
    bc1 = scal[1];
    bc2 = scal[2];
  }

  float gw = 0.f;  // WINDOW: the window's sum times zero
  if (MODE >= WINDOW) {
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

  for (int r = warp; r < tb; r += WARPS) {
    const long long row = (long long)t * tb + r;
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
    const float4 pi = *reinterpret_cast<const float4*>(p + off);
    const float4 mi = *reinterpret_cast<const float4*>(m + off);
    const float4 vi = *reinterpret_cast<const float4*>(v + off);
    float4 pn, mn, vn;
    if (MODE == COPY) {
      pn = pi;
      mn = mi;
      vn = vi;
    } else {
      adam(pi.x, mi.x, vi.x, g.x, lr, bc1, bc2, a, pn.x, mn.x, vn.x);
      adam(pi.y, mi.y, vi.y, g.y, lr, bc1, bc2, a, pn.y, mn.y, vn.y);
      adam(pi.z, mi.z, vi.z, g.z, lr, bc1, bc2, a, pn.z, mn.z, vn.z);
      adam(pi.w, mi.w, vi.w, g.w, lr, bc1, bc2, a, pn.w, mn.w, vn.w);
    }
    *reinterpret_cast<float4*>(po + off) = pn;
    *reinterpret_cast<float4*>(mo + off) = mn;
    *reinterpret_cast<float4*>(vo + off) = vn;
    if (PC == PC_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(pc) + off) = pn;
    } else if (PC == PC_BF16) {
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(pc) + off) =
          make_uint2(pack_bf16(pn.x, pn.y), pack_bf16(pn.z, pn.w));
    }
  }
}

template <int MODE, int PC>
static void launch_t(unsigned T, size_t smem, cudaStream_t s, const float* p,
                     const float* m, const float* v, float* po, float* mo, float* vo,
                     void* pc, const int* ids, const void* g0, const void* g1,
                     const int* offs, const float* scal, Params a, int tb, int w) {
  onehot_adam_kernel<MODE, PC><<<T, THREADS, smem, s>>>(p, m, v, po, mo, vo, pc, ids, g0,
                                                        g1, offs, scal, a, tb, w);
}

extern "C" {

// Launches the step on `stream`; returns cudaGetLastError() (0 = launched).
// mode: enum Mode; pc_kind: enum Copy (a copy only with DOT_BF16, as K5).
// scal: device float[>= 3] {lr, bc1, bc2}, or null to take lr/bc1/bc2.
// T tiles of tb packed rows; windows of w entries (2 w ids plus STATIC_SMEM
// within SMEM_LIMIT, so w <= 6140); n_ids entries in ids.
int onehot_adam(int mode, int pc_kind, const void* p, const void* m, const void* v,
                void* po, void* mo, void* vo, void* pc, const void* ids,
                const void* g0, const void* g1, const void* offs, const void* scal,
                float lr, float bc1, float bc2, float b1, float b2, float omb1,
                float omb2, float eps, float zero, int T, int tb, int w,
                long long n_ids, void* stream) {
  if (mode < 0 || mode >= N_MODES || pc_kind < 0 || pc_kind >= N_COPIES ||
      (pc_kind != PC_NONE && mode != DOT_BF16) || T < 0 || tb < 1 || w < 1 ||
      (size_t)2 * w * sizeof(int) + STATIC_SMEM > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  const Params a{lr, bc1, bc2, b1, b2, omb1, omb2, eps, zero, n_ids};
  const size_t smem = (size_t)2 * w * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  const float* pf = static_cast<const float*>(p);
  const float* mf = static_cast<const float*>(m);
  const float* vf = static_cast<const float*>(v);
  float* pof = static_cast<float*>(po);
  float* mof = static_cast<float*>(mo);
  float* vof = static_cast<float*>(vo);
  const int* idi = static_cast<const int*>(ids);
  const int* ofi = static_cast<const int*>(offs);
  const float* sc = static_cast<const float*>(scal);
#define ONEHOT_LAUNCH(MODE, PC)                                                  \
  launch_t<MODE, PC>((unsigned)T, smem, s, pf, mf, vf, pof, mof, vof, pc, idi, g0, \
                     g1, ofi, sc, a, tb, w)
  switch (mode) {
    case COPY: ONEHOT_LAUNCH(COPY, PC_NONE); break;
    case SWEEP: ONEHOT_LAUNCH(SWEEP, PC_NONE); break;
    case WINDOW: ONEHOT_LAUNCH(WINDOW, PC_NONE); break;
    case ONEHOT: ONEHOT_LAUNCH(ONEHOT, PC_NONE); break;
    case DOT_BF16:
      if (pc_kind == PC_F32) ONEHOT_LAUNCH(DOT_BF16, PC_F32);
      else if (pc_kind == PC_BF16) ONEHOT_LAUNCH(DOT_BF16, PC_BF16);
      else ONEHOT_LAUNCH(DOT_BF16, PC_NONE);
      break;
    case DOT_HI: ONEHOT_LAUNCH(DOT_HI, PC_NONE); break;
    default: ONEHOT_LAUNCH(NARROW, PC_NONE); break;
  }
#undef ONEHOT_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
