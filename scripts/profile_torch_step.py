#!/usr/bin/env python3
"""Where the port's training step spends its time on the card.

    python3 scripts/profile_torch_step.py [--mode iid|bf16map|bf16m-level]
        [--steps 20] [--fuse 1] [--trace DIR]

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
(from a reset after the precompute), the precompute's seconds, and the kernels that take the most device time, grouped into the
step's layers.  ``--trace`` also writes a Chrome trace there.  Needs one
CUDA card.
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
    ("sort", "update prep (sort)"),
    ("gemm", "decoder matmuls"), ("gemv", "decoder matmuls"), ("Gemm", "decoder matmuls"),
    ("bmm", "interpolation matmuls"),
    ("index", "gathers / scatters"), ("gather", "gathers / scatters"),
    ("scatter", "gathers / scatters"),
    ("reduce", "reductions"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("Memcpy", "copies"), ("Memset", "copies"),
)


def layer_of(name: str) -> str:
    for frag, layer in LAYERS:
        if frag in name:
            return layer
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("iid", "bf16map", "bf16m-level"), default="iid")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--fuse", type=int, default=1,
                    help="iid mode: 1 multi-level update (K2), 0 per level (K1)")
    ap.add_argument("--trace", default="")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 2
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
    print("device ms/step by layer:")
    for layer, t in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        print(f"  {t:8.4f}  {layer}")
    print("top kernels (device ms/step, calls/step):")
    for name, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t / args.steps:8.4f}  {n / args.steps:6.1f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
