#!/usr/bin/env python3
"""K2's update kernel at row-shard size: designs of csrc/fused_adam.cu timed
on one card at chip_smoke.py phase 9's shapes (3 x 4,194,304-row tables,
phase 2's used heads, one step's 65,536 entries a level split over the
shards with ~10 % pads), at 2 and 4 shards and unsharded, for the three
variants (f32; f32 p with bf16 moments; bf16 p, m, v with stochastic
rounding).

    python3 scripts/probe_k2_shards.py [--designs kernel,parent,...] [--out PATH]

Designs (altered copies are written to and built in
``shine_mapping_tpu_torch/csrc/build/exp/<design>/``, git-ignored), from
three sources:

* ``parent``: the parent commit's ``csrc/fused_adam.cu`` when it was copied
  to ``shine_mapping_tpu_torch/csrc/build/parent/``;
* ``kernel``: this commit's ``csrc/fused_adam.cu`` (one CTA a tile, each
  thread's two groups loaded into registers before the tile's entries are
  summed; idle groups skip the arithmetic); ``kernel_p8`` ... ``kernel_p12``
  with launch bounds asking 8-12 CTAs an SM of bf16 p, ``kernel_m8`` 8 of
  bf16 moments; ``kernel_noidle`` without the idle groups' path;
* ``ring``: ``scripts/probes/fused_adam_ring.cu``, design (b): a persistent
  grid, each CTA walking tiles by a static stride with the next tiles' p,
  m and v in flight in a shared-memory ring of cp.async copies while the
  current tile is summed and stepped; ``ring_s2`` ... ``ring_s4`` with 2-4
  stages in every variant; ``ring_k1`` ... ``ring_k4`` on a grid of k CTAs
  an SM; ``ring_tile`` on one CTA a tile (the staging without the
  persistence);
* ``regs``: design (a), the ring's grid with the next tile's groups loaded
  into registers before the current tile is summed (common path only: no
  work list, no deterministic sum);
* ``tma``: design (c), the ring filled by one TMA 1-D bulk copy a table a
  tile (``cp.async.bulk`` completing on an ``mbarrier``, a barrier before
  each refill), results stored from registers;
* ``<base>_stripped``: Adam's arithmetic and Philox taken out, the same
  bytes streamed (p, m and v stored as loaded);
* ``<base>_arith``: the arithmetic alone (rounded quotients and root,
  Philox): loads replaced by values made from the address, stores kept
  only behind a test that never holds.

Every design but the stripped and arithmetic-only copies is first held
against the plain version (``fused_adam_shard_plain`` /
``fused_adam_multi_plain``): bit-equal on rows with at most one entry
(bf16 p's noise included), f32 tables within rtol 1e-5 / atol 1e-6
elsewhere.  Readings: each design's kernel alone (chip_smoke.py's
``graph_ms``: 20 launches in a CUDA graph, the replay timed), in turns with
the parent's where it was copied in (parent, design, design, parent); the
parent and the kernel at every shard, the others at the fullest (shard 0)
and unsharded; the bytes bound; each build's registers and spills
(``-Xptxas -v``) and CTAs an SM.  Prints the card's name and power limit
first; ``--out PATH`` also writes every reading there as JSON.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

C_ROWS = 1 << 22
CORNERS = (3_180_000, 3_070_000, 2_400_000)  # phase 2's bench-world corners
M = 65536  # entries a level
SHARDS = (2, 4)

# ------------------------------------------------------------------ alterations


def replace_function(text: str, signature: str, new: str) -> str:
    """``text`` with the definition that starts at the line ``signature``
    (its first characters) and ends at the next line ``}`` replaced by
    ``new``; raises KeyError when it is not there."""
    a = text.find(signature)
    if a < 0:
        raise KeyError(signature)
    b = text.index("\n}\n", a) + 3
    return text[:a] + new + text[b:]


def replace_text(text: str, old: str, new: str, optional: bool = False) -> str:
    if old not in text:
        if optional:
            return text
        raise KeyError(old)
    return text.replace(old, new)


STRIP_ADAM = r'''__device__ __forceinline__ void adam1(float& p, float& m, float& v, float g, float lr,
                                      const Hyper& h) {
  (void)g;
  (void)lr;
  (void)h;
}
'''
STRIP_PHILOX = r'''__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  return make_uint4(c.x ^ k.x, c.y, c.z, c.w);
}
'''
# values made from the address: positive, normal, of the tables' magnitudes
SYNTH_F32 = r'''__device__ __forceinline__ void load_raw(const float* a, int n, Raw8<float>& r) {
  (void)n;
  const float f = 1e-3f * (1.f + (float)(((unsigned long long)a >> 4) & 255) * (1.f / 256));
  r.a = make_float4(f, 0.5f * f, 0.25f * f, f);
  r.b = make_float4(2.f * f, f, 0.75f * f, 1.5f * f);
}
'''
SYNTH_BF16 = r'''__device__ __forceinline__ void load_raw(const __nv_bfloat16* a, int n, Raw8<__nv_bfloat16>& r) {
  (void)n;
  const float f = 1e-3f * (1.f + (float)(((unsigned long long)a >> 4) & 255) * (1.f / 256));
  const unsigned u = __float_as_uint(f) >> 16, w = __float_as_uint(0.5f * f) >> 16;
  r.a = make_uint4(u | (w << 16), w | (u << 16), u | (u << 16), w | (w << 16));
}
'''
# stores kept behind a test on every value that never holds
SINK_F32 = r'''__device__ __forceinline__ void store8(float* a, const float (&x)[8]) {
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= __float_as_uint(x[j]);
  if (s == 0x7FC00001u) a[0] = x[0];
}
'''
SINK_BF16 = r'''__device__ __forceinline__ void store8(__nv_bfloat16* a, const float (&x)[8]) {
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= __float_as_uint(x[j]);
  if (s == 0x7FC00001u) a[0] = __float2bfloat16_rn(x[0]);
}
'''
SINK_BITS = r'''__device__ __forceinline__ void store8(__nv_bfloat16* a, const unsigned short (&b)[8]) {
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= b[j];
  if (s == 0x7FC1u) a[0] = __ushort_as_bfloat16(b[0]);
}
'''

# design (c): the ring filled by TMA 1-D bulk copies completing on one
# mbarrier a stage
TMA_FILL = r'''__shared__ __align__(8) unsigned long long tma_bar[8];

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bulk(void* dst, const void* src, unsigned bytes,
                                     unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred q; mbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2; "
        "selp.u32 %0, 1, 0, q; }\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

template <typename P, typename Mt>
__device__ __forceinline__ void fill(char* st, const Levels& lv, int t, int tb, int D) {
  extern __shared__ float4 smem4[];
  const int s = (int)((st - reinterpret_cast<char*>(smem4 + ((tb * D) >> 2))) /
                      Ring<P, Mt>::bytes);
  __syncthreads();  // every thread's reads of this stage are done
  if (threadIdx.x == 0) {
    const Tile x = tile_at(lv, t, tb, D);
    const unsigned n8 = (unsigned)(x.nel & ~7);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(&tma_bar[s])),
                 "r"(n8 * (unsigned)(sizeof(P) + 2 * sizeof(Mt))) : "memory");
    if (n8) {
      bulk(st, static_cast<const P*>(lv.p[x.l]) + x.base, n8 * sizeof(P), &tma_bar[s]);
      bulk(st + TILE_MAX * sizeof(P), static_cast<const Mt*>(lv.m[x.l]) + x.base,
           n8 * sizeof(Mt), &tma_bar[s]);
      bulk(st + TILE_MAX * (sizeof(P) + sizeof(Mt)), static_cast<const Mt*>(lv.v[x.l]) + x.base,
           n8 * sizeof(Mt), &tma_bar[s]);
    }
  }
}
'''
TMA_INIT = r'''  if (threadIdx.x == 0) {
    for (int s = 0; s < R::stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&tma_bar[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int G = gridDim.x;
'''

# design (a): the next tile's groups in registers; the common path only
REGS_KERNEL = r'''template <typename P, typename Mt, bool GRADS_BF16>
__global__ void __launch_bounds__(THREADS, 4) fused_adam_kernel(
    const int* __restrict__ rows, const int* __restrict__ order,
    const int* __restrict__ tile_off, int D, int tb, Levels lv, Hyper h, unsigned seed,
    int det, Split sp) {
  extern __shared__ float4 smem4[];
  float* gtile = reinterpret_cast<float*>(smem4);
  const int n4 = (tb * D) >> 2;
  for (int e = threadIdx.x; e < n4; e += THREADS) smem4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (det || sp.chunk > 0 || D > 256) __trap();
  const int G = gridDim.x;
  Group<P, Mt> ra[GPT], rb[GPT];
  auto load = [&](Group<P, Mt>(&r)[GPT], int t) {
    if (t >= sp.T) return;
    const Tile x = tile_at(lv, t, tb, D);
    const P* p = static_cast<const P*>(lv.p[x.l]) + x.base;
    const Mt* m = static_cast<const Mt*>(lv.m[x.l]) + x.base;
    const Mt* v = static_cast<const Mt*>(lv.v[x.l]) + x.base;
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
      const int e0 = (threadIdx.x + k * THREADS) << 3;
      if (e0 < x.nel) load_group(r[k], p, m, v, e0, min(8, x.nel - e0));
    }
  };
  auto step = [&](const Group<P, Mt>(&r)[GPT], int t) {
    const Tile x = tile_at(lv, t, tb, D);
    const int lo = tile_off[t], hi = tile_off[t + 1];
    if (hi > lo) {
      __syncthreads();
      sum_atomic<GRADS_BF16>(gtile, rows, order, lv.g[x.l], (int)lv.ent_off[x.l],
                             (int)(lv.row_off[x.l] + x.k * tb), lo, hi, D);
      __syncthreads();
    }
    P* p = static_cast<P*>(lv.p[x.l]) + x.base;
    Mt* m = static_cast<Mt*>(lv.m[x.l]) + x.base;
    Mt* v = static_cast<Mt*>(lv.v[x.l]) + x.base;
    const long long grp0 = lv.grp_base[x.l] + (x.base >> 3);
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
      const int q = threadIdx.x + k * THREADS, e0 = q << 3;
      if (e0 < x.nel)
        finish_group(r[k], p, m, v, e0, min(8, x.nel - e0), hi > lo ? gtile : nullptr,
                     lv.lr[x.l], h, grp0 + q, x.l, seed);
    }
  };
  load(ra, blockIdx.x);
  for (int i = blockIdx.x; i < sp.T; i += 2 * G) {
    load(rb, i + G);
    step(ra, i);
    if (i + G >= sp.T) break;
    load(ra, i + 2 * G);
    step(rb, i + G);
  }
}
'''

STAGES_LINE = ("  static constexpr int stages = std::is_same<P, float>::value &&\n"
               "                                std::is_same<Mt, float>::value ? 2 : 3;\n")
GRID_LINE = "  const long long grid = items < ctas ? items : ctas;\n"
CTAS_LINE = "    c.ctas = (long long)per_sm * sms;\n"
SMEM_LINE = ("  return (size_t)tb * D * sizeof(float) + (size_t)Ring<P, Mt>::stages * "
             "Ring<P, Mt>::bytes;\n")
KERNEL_SIG = "template <typename P, typename Mt, bool GRADS_BF16>\n__global__ void"


def _stripped(text):
    text = replace_function(text, "__device__ __forceinline__ void adam1(", STRIP_ADAM)
    return replace_function(text, "__device__ __forceinline__ uint4 philox4x32_10(",
                            STRIP_PHILOX)


def _arith(text):
    text = replace_function(text, "__device__ __forceinline__ void load_raw(const float* a,",
                            SYNTH_F32)
    text = replace_function(
        text, "__device__ __forceinline__ void load_raw(const __nv_bfloat16* a,", SYNTH_BF16)
    text = replace_function(text, "__device__ __forceinline__ void store8(float* a,", SINK_F32)
    text = replace_function(
        text, "__device__ __forceinline__ void store8(__nv_bfloat16* a, const float", SINK_BF16)
    try:  # this commit's bits store; an earlier kernel stored them inline
        text = replace_function(
            text, "__device__ __forceinline__ void store8(__nv_bfloat16* a, const unsigned short",
            SINK_BITS)
    except KeyError:
        text = replace_text(text, "      *reinterpret_cast<uint4*>(p + e0) =\n",
                            "      if ((b[0] ^ b[1] ^ b[2] ^ b[3] ^ b[4] ^ b[5] ^ b[6] ^ b[7]) == 0x7FC1)\n"
                            "      *reinterpret_cast<uint4*>(p + e0) =\n")
    # the ring's copies: none
    return replace_function(text, "__device__ __forceinline__ void cp_async16(",
                            "__device__ __forceinline__ void cp_async16(void* dst, "
                            "const void* src) {}\n") if "cp_async16(" in text else text


def _regs(text):
    a = text.index(KERNEL_SIG)
    b = text.index("\n}\n", a) + 3
    text = text[:a] + REGS_KERNEL + text[b:]
    return replace_text(text, SMEM_LINE, "  return (size_t)tb * D * sizeof(float);\n")


def _tma(text):
    text = replace_function(text, "template <typename P, typename Mt>\n__device__ __forceinline__ "
                            "void fill(", TMA_FILL)
    text = replace_function(text, "__device__ __forceinline__ void cp_async_commit(",
                            "__device__ __forceinline__ void cp_async_commit() {}\n")
    text = replace_text(text, "  const int G = gridDim.x;\n", TMA_INIT)
    return replace_text(text, "    cp_async_wait<R::stages - 1>();",
                        "    tma_wait(&tma_bar[it % R::stages], (it / R::stages) & 1);")


def _stages(k):
    return lambda text: replace_text(text, STAGES_LINE,
                                     f"  static constexpr int stages = {k};\n")


def _per_sm(k):
    return lambda text: replace_text(text, CTAS_LINE,
                                     f"    c.ctas = (long long)(per_sm < {k} ? per_sm : {k}) "
                                     "* sms;\n")


MIN_CTAS = re.compile(r"static constexpr int value = std::is_same<P, __nv_bfloat16>::value \? "
                      r"(\d+)\n\s+: std::is_same<Mt, __nv_bfloat16>::value \? (\d+) : (\d+);")
IDLE_LINE = "  const bool idle = (gbits | bits_or(r.m) | bits_or(r.v)) == 0u;\n"


def _ctas(bf16p=None, bf16m=None):
    """The kernel's launch bounds asking ``bf16p`` / ``bf16m`` CTAs an SM
    of those variants (None: as in the source)."""
    def alter(text):
        m = MIN_CTAS.search(text)
        if m is None:
            raise KeyError(MIN_CTAS.pattern)
        p, mm, f = (bf16p or m.group(1)), (bf16m or m.group(2)), m.group(3)
        return text[:m.start()] + (
            f"static constexpr int value = std::is_same<P, __nv_bfloat16>::value ? {p}\n"
            f"                               : std::is_same<Mt, __nv_bfloat16>::value ? {mm} : "
            f"{f};") + text[m.end():]
    return alter


# design -> (base source: "parent", "kernel" or "ring", alteration, what it is)
DESIGNS = {
    "parent": ("parent", None, "the parent commit's kernel"),
    "kernel": ("kernel", None, "this commit's kernel"),
    **{f"kernel_p{k}": ("kernel", _ctas(bf16p=k), f"this commit's kernel, bf16 p at {k} CTAs an SM")
       for k in (8, 9, 10, 11, 12)},
    "kernel_m8": ("kernel", _ctas(bf16m=8), "this commit's kernel, bf16 moments at 8 CTAs an SM"),
    "kernel_noidle": ("kernel", lambda t: replace_text(t, IDLE_LINE,
                                                      "  const bool idle = false;\n"),
                      "this commit's kernel without the idle groups' path"),
    "ring": ("ring", None, "(b) persistent grid, cp.async ring"),
    "ring_s2": ("ring", _stages(2), "(b), 2 stages"),
    "ring_s3": ("ring", _stages(3), "(b), 3 stages"),
    "ring_s4": ("ring", _stages(4), "(b), 4 stages"),
    "ring_k1": ("ring", _per_sm(1), "(b), 132 x 1 CTAs"),
    "ring_k2": ("ring", _per_sm(2), "(b), 132 x 2 CTAs"),
    "ring_k3": ("ring", _per_sm(3), "(b), 132 x 3 CTAs"),
    "ring_k4": ("ring", _per_sm(4), "(b), 132 x 4 CTAs"),
    "ring_tile": ("ring", lambda t: replace_text(t, GRID_LINE, "  const long long grid = items;\n"),
                  "(b) on one CTA a tile"),
    "regs": ("ring", _regs, "(a) next tile's groups in registers"),
    "tma": ("ring", _tma, "(c) ring filled by TMA bulk copies"),
    **{f"{b}_stripped": (b, _stripped, f"{b}, no arithmetic (bytes alone)")
       for b in ("parent", "kernel", "ring")},
    **{f"{b}_arith": (b, _arith, f"{b}, arithmetic alone (no table bytes)")
       for b in ("parent", "kernel", "ring")},
}
UNCHECKED = ("_stripped", "_arith")
RING_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probes",
                           "fused_adam_ring.cu")


def design_source(name: str, texts: dict):
    """The CUDA source of ``name`` from its base's text in ``texts``
    (None: no parent)."""
    base, alter, _ = DESIGNS[name]
    text = texts.get(base)
    if text is None:
        return None
    return text if alter is None else alter(text)


def _libs(names):
    """Each design's library, the altered copies built at once (one nvcc
    each); None where its base is absent."""
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from shine_mapping_tpu_torch.ops import cuda_build

    texts = {}
    for base, path in (("kernel", os.path.join(cuda_build.CSRC_DIR, "fused_adam.cu")),
                       ("parent", os.path.join(cs.PARENT_DIR, "fused_adam.cu")),
                       ("ring", RING_SOURCE)):
        if os.path.exists(path):
            with open(path) as f:
                texts[base] = f.read()
    dirs = {}
    for name in names:
        if name == "parent":
            dirs[name] = (cs.PARENT_DIR,) * 2 if "parent" in texts else None
        else:
            text = design_source(name, texts)
            if text is None:
                dirs[name] = None
                continue
            d = os.path.join(cuda_build.BUILD_DIR, "exp", name)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "fused_adam.cu"), "w") as f:
                f.write(text)
            dirs[name] = d, d
    with ThreadPoolExecutor(max_workers=max(1, len(dirs))) as pool:
        futs = {n: pool.submit(cuda_build.build, "fused_adam", *d)
                for n, d in dirs.items() if d is not None}
        errors = {}
        for n, f in futs.items():
            try:
                f.result()
            except RuntimeError as e:
                errors[n] = str(e)[-3000:]
    libs = {}
    for n, d in dirs.items():
        libs[n] = None if d is None or n in errors else cuda_build.load("fused_adam", *d)
    return libs, errors, dirs


def _ctas_per_sm(lib, lines, variant):
    """CTAs an SM holds: the ring's own query (fused_adam_grid), else from
    the registers ptxas gave the variant (128 threads a CTA, registers
    allocated 8 at a time; the 8 KB of sums do not bind)."""
    import ctypes

    import torch

    try:
        fn = lib.fused_adam_grid
    except AttributeError:
        regs = [int(re.search(r"Used (\d+) registers", l).group(1)) for l in lines
                if l.startswith(variant + ":") and "registers" in l]
        return None if not regs else min(32, 65536 // (128 * (-(-regs[0] // 8) * 8)))
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = ctypes.c_longlong(0)
    code = {"f32": 0, "bf16m": 1, "bf16p": 2}[variant]
    assert fn(code, 0, 8, 256, 1 << 40, ctypes.byref(out)) == 0
    return out.value / torch.cuda.get_device_properties(0).multi_processor_count


def _ptxas(d):
    """The ptxas lines (registers, spills, shared memory) of a build."""
    from shine_mapping_tpu_torch.ops import cuda_build

    key = os.path.relpath(os.path.join(d[0], "fused_adam"), cuda_build.CSRC_DIR)
    log = cuda_build.BUILD_INFO.get(key, {}).get("log", "")
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = ("bf16p" if "I13__nv_bfloat16S0_" in m.group(1) else
                  "bf16m" if "If13__nv_bfloat16" in m.group(1) else "f32") + (
                " gb" if "Lb1E" in m.group(1) else "")
        elif fn and ("registers" in line or "spill" in line):
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    ap = argparse.ArgumentParser()
    ap.add_argument("--designs", default=",".join(DESIGNS))
    ap.add_argument("--out", default=None, help="a JSON file for every reading")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k2_shards: no CUDA device", file=sys.stderr)
        return 2
    print(f"[probe] nvidia-smi: {cs.nvidia_smi()}")
    names = [n for n in args.designs.split(",") if n]
    libs, errors, dirs = _libs(names)
    for n, e in errors.items():
        print(f"[probe] {n}: build failed:\n{e}")
    parent = libs.get("parent")
    print(f"[probe] parent kernel: {'timed in turns' if parent is not None else 'absent'}")
    report = {"nvidia_smi": cs.nvidia_smi(), "designs": {}, "times": []}
    for n in names:
        if libs.get(n) is None:
            continue
        lines = _ptxas(dirs[n])
        per_sm = {v: _ctas_per_sm(libs[n], lines, v) for v in ("f32", "bf16m", "bf16p")}
        report["designs"][n] = dict(what=DESIGNS[n][2], ctas_per_sm=per_sm, ptxas=lines)
        print(f"[probe] {n} ({DESIGNS[n][2]}): CTAs an SM {per_sm}; ptxas: {'; '.join(lines)}")

    dev = torch.device("cuda")
    D = 8
    sizes = [C_ROWS] * 3
    n_used = list(ak.used_rows_hint(CORNERS, sizes))
    lr, bc1, bc2 = 0.01, 1 - 0.9 ** 5, 1 - 0.99 ** 5
    scales = [1.0, 0.5, 0.25]
    lrs = [lr * s for s in scales]
    rng = np.random.default_rng(1)
    tabs0, rows_l, g_l = cs._kernel_inputs(rng, sizes, n_used, M, D, dev)
    single = cs._single_rows(rows_l, sizes, n_used)
    tb = ak.tile_rows(D)
    whole_pre = ak.window_prep(ak._prep_launch([r.reshape(1, -1) for r in rows_l], sizes,
                                               n_used, tb, chunk=0), 0)
    # the cases: (label, rows per block, shard k of n or None, entries)
    cases = [("unsharded", None, None)]
    shard_in = {}
    for n in SHARDS:
        for k in range(n):
            rows_loc, g_loc, _ = cs._shard_entries(rows_l, g_l, sizes, k, n, rng=rng)
            b = C_ROWS // n
            shard_in[(n, k)] = (g_loc, ak.entry_prep_local(rows_loc, [b] * 3, D),
                                ak.shard_row_base([(C_ROWS, D)] * 3, n, k))
            cases.append((f"{n} shards, shard {k}", n, k))
    dtypes = {"f32": (torch.float32, torch.float32), "bf16m": (torch.float32, torch.bfloat16),
              "bf16p": (torch.bfloat16, torch.bfloat16)}
    for variant, (pd, md) in dtypes.items():
        kw = dict(grads_bf16=variant != "f32", sr_seed=7 if variant == "bf16p" else None)
        seed = 7 if variant == "bf16p" else 0
        t0 = [[t.to(dt) for t in tabs0[i]] for i, dt in ((0, pd), (1, md), (2, md))]
        pb, mb = (torch.tensor([], dtype=dt).element_size() for dt in dtypes[variant])
        for label, n, k in cases:
            if n is None:
                loc0, used, single_k = t0, n_used, single
                g_args = (g_l, [0, M, 2 * M], whole_pre, n_used, [0, C_ROWS, 2 * C_ROWS], None)
                m_ent = 3 * M
                ref = [[t.clone() for t in lv] for lv in loc0]
                ak.fused_adam_multi_plain(*ref, rows_l, g_l, lr, bc1, bc2, scales, n_used, **kw)
            else:
                b = C_ROWS // n
                g_loc, pre, base = shard_in[(n, k)]
                loc0 = [[t[k * b:(k + 1) * b].clone() for t in lv] for lv in t0]
                used = [b] * 3
                single_k = [s_[k * b:(k + 1) * b] for s_ in single]
                g_args = ([g_loc] * 3, [0] * 3, pre, used, [0, b, 2 * b], base)
                m_ent = int(g_loc.shape[0])
                ref = [[t.clone() for t in lv] for lv in loc0]
                ak.fused_adam_shard_plain(*ref, None, g_loc, lr, bc1, bc2, scales, base, pre=pre,
                                          **kw)
            elems = sum(used) * D
            nbytes = 2 * (pb + 2 * mb) * elems + m_ent * (4 + 4 + 4 * D)
            bound = 1e3 * nbytes / cs.H100_BYTES_PER_S
            for name in names:
                lib = libs.get(name)
                if lib is None:
                    continue
                if name not in ("parent", "kernel") and n is not None and k != 0:
                    continue  # the other designs at the fullest shard
                tim = [[t.clone() for t in lv] for lv in loc0]

                def launch(lib=lib, ts=tim):
                    ak._launch(variant, *ts, g_args[0], g_args[1], g_args[2], g_args[3],
                               g_args[4], lrs, 0.9, 0.99, bc1, bc2, 1e-15, kw["grads_bf16"],
                               seed, lib=lib, row_base=g_args[5])

                launch()
                torch.cuda.synchronize()
                if not name.endswith(UNCHECKED):
                    for i in range(3):
                        for a, c, s_ in zip(tim[i], ref[i], single_k):
                            bits = torch.int16 if a.itemsize == 2 else torch.int32
                            diff = int((a[s_].view(bits) != c[s_].view(bits)).sum())
                            assert diff == 0, f"{name} {variant} {label}: {diff} single-row " \
                                              f"elements of table {i} differ from plain"
                            if a.dtype == torch.float32:
                                torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
                if parent is not None and name != "parent":
                    t_par, t_new = cs._in_turns(lambda: launch(parent), launch, cs.graph_ms)
                else:
                    t_par, t_new = None, cs.graph_ms(launch)
                rec = dict(design=name, variant=variant, case=label, ms=t_new, parent_ms=t_par,
                           bound_ms=bound, share=bound / t_new)
                report["times"].append(rec)
                par = "" if t_par is None else f", parent {t_par:.4f} ms in turns"
                print(f"[probe] {variant} {label}: {name} {t_new:.4f} ms{par}, bound "
                      f"{bound:.4f} ms, {bound / t_new:.0%} of bound", flush=True)
                del tim
            del ref, loc0
            torch.cuda.empty_cache()
        del t0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
