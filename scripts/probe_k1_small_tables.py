#!/usr/bin/env python3
"""K1's per-level step on small, hot tables (the RGB-D configs' 4 levels):
three designs of the update timed on one card, at run (k)'s and run (l)'s
tables of chip_smoke.py phase 11 (32,768 entries a level, chip_smoke.py's
kernel inputs).

    python3 scripts/probe_k1_small_tables.py [--chunks 256,512,1024]

Designs, each first held against the per-level plain steps (phase 2's
tolerance plus the sum-order spread, bit-equal on rows of at most one
entry):

* ``parent``: four per-level launches, one CTA a tile: the parent commit's
  ``csrc/fused_adam.cu`` when it was copied to
  ``shine_mapping_tpu_torch/csrc/build/parent/`` (its own C interface), and
  this commit's kernel on per-level preps without a work list (the same
  grid); the call: four ``fused_adam`` calls, each with its own live prep;
* ``balanced<c>``: this commit's design, one prep and one launch over the
  four levels, a tile of more than c entries split over ceil(n / c) CTAs
  (the prep's work list; c = ``ENTRY_CHUNK`` is ``fused_adam_levels``);
* ``sorted``: an altered copy of ``csrc/fused_adam.cu`` (built into
  ``csrc/build/exp/sorted/``, git-ignored) whose chunk sum needs the
  entries sorted by row: each warp takes 32 consecutive entries, one a
  lane, sums them by row with a segmented scan of shuffles, and the last
  lane of each run adds the run into the tile (no atomic per entry), on
  the plain prep (a stable sort on the card, with the work list at
  ``ENTRY_CHUNK``); beside it ``torch.sort`` of the keys alone, the least
  any sorted prep costs.

Readings: the kernel alone (chip_smoke.py's ``graph_ms``: 20 launches in a
CUDA graph, the replay timed; the parent's in turns with the balanced
design's), the step's call (prep and launch, events around back-to-back
calls: the host's time where it is the longer), the library call
(``index_add_`` + fused ``torch.optim.Adam``) and the bytes bound.  Prints
the card's name and power limit first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TABLES = {
    "(k)": ([524288, 65536, 65536, 65536], [286720, 22528, 21504, 21504]),
    "(l)": ([65536] * 4, [20480, 5120, 1024, 1024]),
}
M = 32768  # entries a level: bs 4,096 x 8 corners

# the segmented warp sum over entries sorted by row, in place of the
# atomics' sum of a chunk (csrc/fused_adam.cu's sum_atomic)
SORTED_SUM = r'''template <bool GRADS_BF16>
__device__ __forceinline__ void sum_atomic(float* gtile, const int* __restrict__ rows,
                                           const int* __restrict__ order,
                                           const float* __restrict__ g, long long eo,
                                           long long row0, int lo, int hi, int D) {
  const int lane = threadIdx.x & 31;
  for (int b0 = lo + (threadIdx.x & ~31); b0 < hi; b0 += THREADS) {
    const int j = b0 + lane;
    const bool ok = j < hi;
    const int r = ok ? rows[j] : -1;
    const long long src = ok ? ((long long)order[j] - eo) * D : 0;
    unsigned same = 0;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int ro = __shfl_up_sync(0xffffffffu, r, 1 << s);
      if (lane >= (1 << s) && ro == r) same |= 1u << s;
    }
    const int rn = __shfl_down_sync(0xffffffffu, r, 1);
    const bool tail = ok && (lane == 31 || rn != r);
    for (int d = 0; d < D; ++d) {
      float x = ok ? g[src + d] : 0.f;
      if (GRADS_BF16) x = __bfloat162float(__float2bfloat16_rn(x));
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const float y = __shfl_up_sync(0xffffffffu, x, 1 << s);
        if (same & (1u << s)) x += y;
      }
      if (tail) atomicAdd(&gtile[(int)(r - row0) * D + d], x);
    }
  }
}

'''


def _sorted_lib():
    """csrc/fused_adam.cu with SORTED_SUM for its chunk sum; its library."""
    from shine_mapping_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC_DIR, "fused_adam.cu")) as f:
        text = f.read()
    a = text.index("template <bool GRADS_BF16>\n__device__ __forceinline__ void sum_atomic(")
    b = text.index("// CTAs an SM must hold at once")
    text = text[:a] + SORTED_SUM + text[b:]
    lib_dir = os.path.join(cuda_build.BUILD_DIR, "exp", "sorted")
    os.makedirs(lib_dir, exist_ok=True)
    with open(os.path.join(lib_dir, "fused_adam.cu"), "w") as f:
        f.write(text)
    return cuda_build.load("fused_adam", lib_dir, lib_dir)


def probe(run, sizes, n_used, chunks, parent, sorted_lib):
    import numpy as np
    import torch

    import chip_smoke as cs
    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    D, L = 8, len(sizes)
    lr, bc1, bc2 = 0.01, 1 - 0.9 ** 5, 1 - 0.99 ** 5
    scales = [1.0] * L
    lrs = [lr] * L
    tabs0, rows_l, g_l = cs._kernel_inputs(np.random.default_rng(11), sizes, n_used, M, D,
                                           torch.device("cuda"))
    ent_off = [lv * M for lv in range(L)]
    offs = [sum(sizes[:lv]) for lv in range(L)]
    tb = ak.tile_rows(D)
    ref = [[t.clone() for t in lv] for lv in tabs0]
    for lv in range(L):
        ak.fused_adam_plain(*(t[lv] for t in ref), rows_l[lv], g_l[lv], lrs[lv], bc1, bc2,
                            n_used[lv])
    spreads = [cs._sum_order_spread([t[lv] for t in tabs0], rows_l[lv], g_l[lv], lrs[lv], bc1,
                                    bc2, n_used[lv]) for lv in range(L)]
    spread = [[sp[t][0] for sp in spreads] for t in range(3)]
    single = cs._single_rows(rows_l, sizes, n_used)

    def held(launch, label):
        kern = [[t.clone() for t in lv] for lv in tabs0]
        launch(kern)
        torch.cuda.synchronize()
        cs._check_f32(kern, ref, tabs0, n_used, single=single, moved_share=None, spread=spread)
        return kern

    out = {}
    per_level = [ak.window_prep(ak._prep_launch([r.reshape(1, -1)], [C], [nu], tb, chunk=0), 0)
                 for r, C, nu in zip(rows_l, sizes, n_used)]

    def four(ts, lib=None):
        for lv in range(L):
            args = ("f32", [ts[0][lv]], [ts[1][lv]], [ts[2][lv]], [g_l[lv]], [0], per_level[lv],
                    [n_used[lv]], [0], [lrs[lv]], 0.9, 0.99, bc1, bc2, 1e-15)
            if lib is None:
                ak._launch(*args)
            else:
                cs._launch_parent(lib, *args)

    kern = held(four, "four")
    out["four launches, one CTA a tile (this commit's kernel), alone"] = cs.graph_ms(
        lambda: four(kern))
    out["four fused_adam calls, each with its live prep"] = cs.cuda_ms(lambda: [
        ak.fused_adam(kern[0][lv], kern[1][lv], kern[2][lv], rows_l[lv], g_l[lv], lrs[lv], bc1,
                      bc2, n_used[lv]) for lv in range(L)])
    for c in chunks:
        pre = ak.window_prep(ak._prep_launch([r.reshape(1, -1) for r in rows_l], sizes, n_used,
                                             tb, chunk=c), 0)

        def one(ts, pre=pre):
            ak._launch("f32", *ts, g_l, ent_off, pre, n_used, offs, lrs, 0.9, 0.99, bc1, bc2,
                       1e-15)

        kern = held(one, f"balanced{c}")
        name = f"balanced{c}: one launch, {int(pre.n_split)} extra items"
        if parent is not None and c == ak.ENTRY_CHUNK:
            held(lambda ts: four(ts, parent), "parent")
            t_par, t_new = cs._in_turns(lambda: four(kern, parent), lambda: one(kern),
                                        cs.graph_ms)
            out["parent: four launches (the parent commit's kernel), alone, in turns"] = t_par
            out[name + ", alone, in turns"] = t_new
        else:
            out[name + ", alone"] = cs.graph_ms(lambda: one(kern))
        out[f"balanced{c}: the step's call (prep + launch)"] = cs.cuda_ms(
            lambda c=c: one(kern, ak.window_prep(ak._prep_launch(
                [r.reshape(1, -1) for r in rows_l], sizes, n_used, tb, chunk=c), 0)))
    out["fused_adam_levels (balanced512): the step's call"] = cs.cuda_ms(
        lambda: ak.fused_adam_levels(*kern, rows_l, g_l, lr, bc1, bc2, scales, n_used))
    if sorted_lib is not None:
        def sprep():
            return ak.window_prep(ak.entry_prep_stack_plain(
                [r.reshape(1, -1) for r in rows_l], sizes, n_used, tb), 0)

        spre = sprep()

        def srt(ts, pre=spre):
            ak._launch("f32", *ts, g_l, ent_off, pre, n_used, offs, lrs, 0.9, 0.99, bc1, bc2,
                       1e-15, lib=sorted_lib)

        kern = held(srt, "sorted")
        out[f"sorted: one launch on the sorted prep, {int(spre.n_split)} extra items, alone"] = \
            cs.graph_ms(lambda: srt(kern))
        out["sorted: the step's call (plain sorted prep + launch)"] = cs.cuda_ms(
            lambda: srt(kern, sprep()), iters=10)
        keys = torch.cat([r.reshape(-1) + o for r, o in zip(rows_l, offs)])
        out["sorted: torch.sort of the keys alone"] = cs.graph_ms(
            lambda: torch.sort(keys, stable=True))
    out["library: index_add_ + fused torch.optim.Adam"] = cs._library_ms(
        tabs0[0], rows_l, g_l, n_used, lrs)
    bound, by = cs._bound_ms(n_used, L * M, D)
    out[f"bound ({by})"] = bound
    for k, v in out.items():
        print(f"[probe] run {run}'s tables {sizes} used {n_used}: {k}: {v:.4f} ms")
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", default="256,512,1024")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k1_small_tables: no CUDA device", file=sys.stderr)
        return 2
    print(f"[probe] nvidia-smi: {cs.nvidia_smi()}")
    chunks = [int(c) for c in args.chunks.split(",")]
    assert ak.ENTRY_CHUNK in chunks
    parent = cs._parent_lib()
    print(f"[probe] parent kernel: {'timed in turns' if parent is not None else 'absent'}")
    sorted_lib = _sorted_lib()
    for run, (sizes, n_used) in TABLES.items():
        probe(run, sizes, n_used, chunks, parent, sorted_lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
