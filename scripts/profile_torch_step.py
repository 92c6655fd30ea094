#!/usr/bin/env python3
"""Where the port's training step spends its time on the card.

    python3 scripts/profile_torch_step.py [--mode iid|bf16map|bf16m-level]
        [--steps 20] [--fuse 1] [--trace DIR]
    python3 scripts/profile_torch_step.py --mode update-kernel
        [--variants threads256,threads64,no_philox,fast_div]

Builds chip_smoke.py's bench world (bench.py's recipe) with the ICRA MaiCity
config, warms up, then records ``--steps`` steps of ``train_chunk`` under
``torch.profiler`` (CPU + CUDA).  ``--mode``: ``iid`` (iid batches, live
hash lookups, float32 tables and moments; ``--fuse`` 1 runs the multi-level
update K2, 0 the per-level K1), ``bf16map`` (the bf16 map mode: pool
lookups, fused epoch windows, bf16 tables and moments, K2 with stochastic
rounding) or ``bf16m-level`` (pool lookups, per-level epoch windows, bf16
moments, K1).  Prints the host time per step (with and without the
profiler), the device busy time per step (sum of kernel and memcpy
durations on the one stream), the idle share (1 - busy / host step time
without the profiler), the device ops per step, the peak device memory of
the precompute (from a reset after the world is built) and of the training
(from a reset after the precompute), the precompute's seconds, the update's device ops per step (its kernel,
the entry prep's kernels and memsets), and the kernels that take the most
device time, grouped into the step's layers.  ``--trace`` also writes a Chrome trace there.

``--mode update-kernel`` instead shows what the update kernel's own time is
made of: it builds altered copies of ``csrc/fused_adam.cu`` (text
substitutions, each into ``csrc/build/exp/<variant>/``, git-ignored) and
times each beside the unaltered kernel in turns (base, variant, variant,
base), kernel alone, at ``chip_smoke.py`` phase 2's shapes (3 levels of
4M-row tables, ~3M used rows each, D 8, 65,536 entries per level), for the
K2 variants f32, bf16 moments and bf16 p + stochastic rounding:
``threads256`` (256 threads a CTA, one group of 8 elements each),
``threads64`` (64 threads, four groups each), ``no_philox`` (the Philox
rounds removed) and ``fast_div`` (``__fdividef`` for the correctly rounded
quotients); the last two give wrong results and only probe the cost.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# kernel-name fragments -> the step's layers (first match wins)
LAYERS = (
    ("fused_adam_kernel", "update kernel (csrc/fused_adam.cu)"),
    ("prep_", "update prep (csrc/entry_prep.cu)"),
    ("gemm", "decoder matmuls"), ("gemv", "decoder matmuls"), ("Gemm", "decoder matmuls"),
    ("bmm", "interpolation matmuls"),
    ("index", "gathers / scatters"), ("gather", "gathers / scatters"),
    ("scatter", "gathers / scatters"),
    ("reduce", "reductions"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("Memcpy", "copies"), ("Memset", "copies"),
)


# --mode update-kernel: altered copies of csrc/fused_adam.cu
PROBES = {
    "threads256": (("#define THREADS 128", "#define THREADS 256"), ("#define GPT 2", "#define GPT 1")),
    "threads64": (("#define THREADS 128", "#define THREADS 64"), ("#define GPT 2", "#define GPT 4")),
    "no_philox": (("for (int r = 0; r < 10; ++r)", "for (int r = 0; r < 0; ++r)"),),
    "fast_div": (("__fdiv_rn(", "__fdividef("),),
}


def probe_update_kernel(variants) -> None:
    """Each altered copy of the update kernel beside the unaltered one."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from shine_mapping_tpu_torch.ops import adam_kernel as ak
    from shine_mapping_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC_DIR, "fused_adam.cu")) as f:
        src = f.read()
    C, D, M = 1 << 22, 8, 65536
    sizes = [C] * 3
    n_used = list(ak.used_rows_hint((3_180_000, 3_070_000, 2_400_000), sizes))
    tabs0, rows_l, g_l = cs._kernel_inputs(np.random.default_rng(0), sizes, n_used, M, D,
                                           "cuda")
    pre = ak.entry_prep(rows_l, sizes, n_used, D)
    offs, ent_off, lrs = [0, C, 2 * C], [0, M, 2 * M], [0.01, 0.005, 0.0025]
    dtypes = {"f32": (torch.float32, torch.float32), "bf16m": (torch.float32, torch.bfloat16),
              "bf16p": (torch.bfloat16, torch.bfloat16)}
    tables = {v: [[t.to(dt) for t in tabs0[k]] for k, dt in ((0, pd), (1, md), (2, md))]
              for v, (pd, md) in dtypes.items()}

    def timed(variant, lib_dir):
        lib = None if lib_dir is None else cuda_build.load("fused_adam", lib_dir, lib_dir)
        return cs.cuda_ms(lambda: ak._launch(
            variant, *tables[variant], g_l, ent_off, pre, n_used, offs, lrs, 0.9, 0.99,
            1 - 0.9 ** 5, 1 - 0.99 ** 5, 1e-15, variant != "f32", 7, lib=lib))

    print(f"{torch.cuda.get_device_name(0)}; K2 kernel alone, 3 levels, used rows {n_used}")
    for name in variants:
        text = src
        for a, b in PROBES[name]:
            assert a in text, f"{name}: '{a}' not in fused_adam.cu"
            text = text.replace(a, b)
        lib_dir = os.path.join(cuda_build.BUILD_DIR, "exp", name)
        os.makedirs(lib_dir, exist_ok=True)
        with open(os.path.join(lib_dir, "fused_adam.cu"), "w") as f:
            f.write(text)
        for variant in dtypes:
            base = [timed(variant, None)]
            alt = [timed(variant, lib_dir), timed(variant, lib_dir)]
            base.append(timed(variant, None))
            b, a = sum(base) / 2, sum(alt) / 2
            print(f"[probe] {name:10s} {variant:5s}: base {b:.4f} ms, altered {a:.4f} ms "
                  f"({a / b - 1:+.1%})")


def layer_of(name: str) -> str:
    for frag, layer in LAYERS:
        if frag in name:
            return layer
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("iid", "bf16map", "bf16m-level", "update-kernel"),
                    default="iid")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--fuse", type=int, default=1,
                    help="iid mode: 1 multi-level update (K2), 0 per level (K1)")
    ap.add_argument("--trace", default="")
    ap.add_argument("--variants", default=",".join(PROBES),
                    help="update-kernel mode: the altered copies to time")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 2
    if args.mode == "update-kernel":
        probe_update_kernel(args.variants.split(","))
        return 0
    from chip_smoke import ICRA_CONFIG, build_bench_world
    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.optimizer import init_opt_state

    cfg = SHINEConfig().load(ICRA_CONFIG)
    grid, pool, _ = build_bench_world(cfg, "cuda")
    iid = args.mode == "iid"
    s = trainer.TrainSettings.from_config(
        cfg, grid.levels, feature_update="pallas", fuse_update_levels=iid and bool(args.fuse),
        n_used=trainer.used_rows_for(grid))
    pool_dev, n_valid = trainer.pool_to_device(pool, len(pool), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.mode == "bf16map":  # the JAX batch driver's cast (shine_batch.py:245-248)
        grid.cast_features(torch.bfloat16)
    params = trainer.init_params(cfg, grid, torch.Generator(device="cuda").manual_seed(0))
    opt = init_opt_state(params, moments_bf16=not iid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kw, pre_s = {}, 0.0
    if not iid:
        t0 = time.perf_counter()
        pre = trainer.precompute_pool_lookups(grid.tables, pool_dev["coord"], grid.levels,
                                              [f.shape[0] for f in grid.features])
        win = trainer.precompute_batch_windows(
            pre, n_valid, torch.Generator(device="cuda").manual_seed(0), s,
            [tuple(f.shape) for f in grid.features], fused=args.mode == "bf16map")
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        kw = dict(pre_lookups=pre, batch_windows=win)
    pre_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()

    def run(n, start):
        return trainer.train_chunk(params, opt, grid.tables, pool_dev, n_valid,
                                   start, gen, s, n, **kw)

    run(10, 0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(args.steps, 10)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.steps, 10 + args.steps)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        tag = f"fuse{args.fuse}" if iid else args.mode
        prof.export_chrome_trace(os.path.join(args.trace, f"step_{tag}.json"))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name][0] += e.device_time_total / 1e3  # us -> ms
            by_kernel[e.name][1] += 1
    busy_ms = sum(t for t, _ in by_kernel.values()) / args.steps
    launches = sum(n for _, n in by_kernel.values()) / args.steps
    by_layer = collections.defaultdict(float)
    for name, (t, _) in by_kernel.items():
        by_layer[layer_of(name)] += t / args.steps

    what = {"iid": "iid batches, f32, " + ("multi-level update (K2)" if args.fuse
                                           else "per-level update (K1)"),
            "bf16map": "bf16 map mode (pool lookups, fused windows, bf16 tables + "
                       "moments, K2 with SR)",
            "bf16m-level": "pool lookups, per-level windows, bf16 moments (K1)"}[args.mode]
    print(f"{torch.cuda.get_device_name(0)}; {what}; bs {cfg.bs}; {args.steps} profiled steps")
    print(f"host {plain_ms:.3f} ms/step (profiler off), {host_ms:.3f} ms/step (on); device busy {busy_ms:.3f} ms/step; "
          f"idle share {1 - busy_ms / plain_ms:.3f}; {launches:.0f} device ops/step; peak device "
          f"memory {peak_gib:.3f} GiB training, {pre_peak_gib:.3f} GiB precompute; precompute "
          f"(pool lookups + windows) {pre_s:.3f} s")
    # the update's device ops: its kernel, the prep's kernels and, per live
    # prep (one prep_bin_kernel launch each), the memset of its counts
    upd = {layer: sum(n for name, (_, n) in by_kernel.items() if layer_of(name) == layer)
           / args.steps for layer in ("update kernel (csrc/fused_adam.cu)",
                                      "update prep (csrc/entry_prep.cu)")}
    live_preps = sum(n for name, (_, n) in by_kernel.items()
                     if "prep_bin_kernel" in name) / args.steps
    print(f"update device ops/step: {sum(upd.values()) + live_preps:.0f} (update kernel "
          f"{upd['update kernel (csrc/fused_adam.cu)']:.0f}, prep kernels "
          f"{upd['update prep (csrc/entry_prep.cu)']:.0f}, prep memsets {live_preps:.0f})")
    print("device ms/step by layer:")
    for layer, t in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        print(f"  {t:8.4f}  {layer}")
    print("top kernels (device ms/step, calls/step):")
    for name, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t / args.steps:8.4f}  {n / args.steps:6.1f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
