"""Batch (offline) mapping driver on one card.

Port of ``shine_mapping_tpu/cli/shine_batch.py`` (reference
shine_batch.py:23-270): accumulate and sample all frames, grow the map
structure, then optimize for ``iters`` steps with periodic checkpoints and
mesh reconstruction, and a final checkpoint.  The ``tpu:`` section's knobs
map onto the training API: ``precompute_lookups`` ->
``trainer.precompute_pool_lookups``, ``batch_windows`` / ``windows_fused``
-> ``trainer.precompute_batch_windows(fused=...)``, ``moments_bf16`` ->
``init_opt_state(moments_bf16=...)``, ``params_bf16`` ->
``grid.cast_features(torch.bfloat16)``.  It runs on ``setting.device``
(the card unless the config says ``cpu``).

Every single-card training option of the JAX driver runs: the semantic
head (vertex semantics on the meshes), the ray-major pool of the rendering
losses (which does not rotate), and time-conditioned maps, meshed once per
even frame at that frame's timestamp.  Not ported yet (raise
NotImplementedError naming their ROADMAP item): multi-host, data-parallel
and row-sharded runs (Queue A item 14); the visualizer (``o3d_vis_on``,
item 15).

Usage:
    python -m shine_mapping_tpu_torch.cli.shine_batch <config.yaml>
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import torch

from ..config import SHINEConfig
from ..data.dataset import LiDARDataset
from ..mesher import Mesher
from ..train import trainer
from ..train.optimizer import FEATURES, init_opt_state
from ..utils import checkpoint as ckpt
from ..utils import profiling
from ..utils.experiment import get_time, setup_experiment
from ..utils.metrics_logger import MetricsLogger
from ..utils.profiling import HbmMonitor, PhaseTimer, device_trace
from .common import (
    build_grid,
    check_supported,
    event_boundaries,
    maybe_load_model,
    pad_opt_state_features,
    pool_capacity_for,
    seed_for,
    sync_features_to_grid,
    torch_device_of,
)


class _Staged:
    """A pool rotation's host gather + pad + upload, run on a daemon thread
    while the current chunk trains; :meth:`result` joins it and re-raises
    its error on the caller's thread."""

    def __init__(self, fn, *args):
        self._out = self._err = None
        self._t = threading.Thread(target=self._run, args=(fn,) + args, daemon=True)
        self._t.start()

    def _run(self, fn, *args):
        try:
            self._out = fn(*args)
        except BaseException as e:  # re-raised on the main thread
            self._err = e

    def result(self):
        self._t.join()
        if self._err is not None:
            raise self._err
        return self._out


def run_shine_mapping_batch(config_path: str | None = None, cfg: SHINEConfig | None = None):
    """Run the batch pipeline; returns (run_path, grid, params)."""
    if cfg is None:
        if config_path is None:
            sys.exit("Please provide the path to the config file.\n"
                     "Try: python -m shine_mapping_tpu_torch.cli.shine_batch xxx_config.yaml")
        cfg = SHINEConfig().load(config_path)
    device = torch_device_of(cfg)
    check_supported(cfg)

    run_path = setup_experiment(cfg, config_path)
    logger = MetricsLogger(run_path, cfg.wandb_vis_on, run_name=cfg.name)

    grid = build_grid(cfg)
    # load pretrained decoders / resume a full map checkpoint BEFORE the
    # data phase so new frames grow the restored structure
    grid, loaded_decoders, freeze, loaded_opt, start_iter = maybe_load_model(cfg, grid)
    dataset = LiDARDataset(cfg, grid)

    # ---------------------------------------------------------------- data phase
    print("Load, preprocess and sample data")
    timer = PhaseTimer()
    with timer.phase("data"):
        if cfg.num_workers > 1:
            dataset.process_frames_pipelined(dataset.frame_ids(), cfg.num_workers)
        else:
            for frame_id in dataset.frame_ids():
                dataset.process_frame(frame_id)
    print(f"data phase: {timer.totals['data']:.1f} s, pool={len(dataset.pool)} samples")
    # release the accumulate buffers' doubling headroom (up to 2x pool RAM)
    dataset.finalize_pool()
    grid.print_detail()

    params = trainer.init_params(cfg, grid, torch.Generator(device).manual_seed(cfg.seed))
    if loaded_decoders:
        params.update(loaded_decoders)
    # decoders frozen only when loading a pretrained decoder; a full
    # checkpoint resume keeps training them
    resume = loaded_opt is not None
    settings = trainer.TrainSettings.from_config(
        cfg, grid.levels, freeze_decoder=freeze and not resume,
        # the structure is frozen after the data phase: near-exact used-row
        # heads let the update skip the tables' headroom
        n_used=trainer.used_rows_for(grid, granularity=64),
    )

    mesher = Mesher(cfg, grid, params["geo"], params["sem"])
    mesher.global_transform = np.linalg.inv(dataset.begin_pose_inv)
    with timer.phase("map-export"):
        dataset.write_merged_pc(run_path + "/map/pc_map_down.ply")

    if resume:
        opt_state = pad_opt_state_features(loaded_opt, params)
        print(f"Resuming from iter {start_iter} (optimizer state restored)")
    else:
        # bf16 moments only when the resolved update is the kernel's
        opt_state = init_opt_state(
            params, moments_bf16=(cfg.moments_bf16 and
                                  trainer.resolve_feature_update(settings) == "pallas"))
    pool_rng = np.random.default_rng(cfg.seed + 1)
    rotate_pool = len(dataset.pool) > cfg.max_device_pool and not cfg.ray_loss
    with timer.phase("upload", sync=device):
        if rotate_pool:
            capacity = cfg.max_device_pool
            sub = pool_rng.integers(0, len(dataset.pool), capacity)
            dev_pool, n_valid = trainer.pool_to_device(dataset.pool, capacity, device, sub,
                                                       settings)
            print(f"pool {len(dataset.pool)} > device budget {capacity}: rotating "
                  f"sub-pools every {cfg.pool_rotate_iters} iters")
        else:
            capacity = pool_capacity_for(len(dataset.pool), cfg.init_pool_capacity)
            dev_pool, n_valid = trainer.pool_to_device(dataset.pool, capacity, device,
                                                       settings=settings)
    iters_since_rotate = n_rotations = 0
    hbm = HbmMonitor(device)
    profiling.last_hbm_monitor = hbm
    hbm.sample("upload")

    # ---------------------------------------------------------------- training
    print("Begin mapping")
    feat_shapes = [tuple(f.shape) for f in grid.features]
    use_winx = cfg.windows_fused
    use_windows = (cfg.batch_windows and cfg.precompute_lookups
                   and trainer.batch_windows_ok(settings, feat_shapes, use_winx))
    if cfg.batch_windows and not use_windows:
        print("tpu.batch_windows requested but prerequisites unmet "
              "(needs the pallas update, point loss, no consistency, "
              "precompute_lookups) — falling back to iid batches")
    # device-memory guard: the windows live for the whole run beside the map
    # and the pool (with rotation also the staged next pool); the estimate
    # is the per-level layout's, which holds at least the fused one's bytes,
    # so an over-budget run goes straight to iid batches
    n_live = capacity if rotate_pool else len(dataset.pool)
    est = trainer.estimate_windows_bytes(n_live, settings, feat_shapes)
    if rotate_pool:
        est += sum(a.nbytes for a in dev_pool.values())
    if use_windows and est > cfg.windows_hbm_budget_gb * (1 << 30):
        print(f"window precompute would hold ~{est / 2**30:.1f} GiB (> "
              f"tpu.windows_hbm_budget_gb {cfg.windows_hbm_budget_gb}) — falling back "
              "to iid batches")
        use_windows = False
    # bf16 map mode: tables stored bfloat16, stochastic-rounding update.  A
    # resume casts the checkpoint's tables (their exact f32 upcast) back
    # bit for bit; the moments come back bf16 as saved.
    use_params_bf16 = (cfg.params_bf16 and use_windows and use_winx
                       and opt_state.m[FEATURES][0].dtype == torch.bfloat16)
    if cfg.params_bf16 and not use_params_bf16:
        print("tpu.params_bf16 requested but prerequisites unmet (needs "
              "batch_windows + windows_fused, moments_bf16) — keeping f32 tables")
    if use_params_bf16:
        grid.cast_features(torch.bfloat16)
        params[FEATURES] = list(grid.features)
        print("bf16 map mode: feature tables stored bfloat16 "
              "(stochastic-rounding Adam; half map memory)")

    def make_pre():
        if not cfg.precompute_lookups:
            return None
        return trainer.precompute_pool_lookups(
            grid.tables, dev_pool["coord"], grid.levels, [f.shape[0] for f in grid.features])

    def make_windows(pre):
        # epoch windows over the current device pool; the permutation's seed
        # is fixed, so a resumed run rebuilds the same windows
        if pre is None or not use_windows:
            return None
        win = trainer.precompute_batch_windows(
            pre, n_live, torch.Generator(device).manual_seed(seed_for(cfg.seed, 0x5157)),
            settings, [tuple(f.shape) for f in params[FEATURES]], fused=use_winx)
        print(f"{'fused' if use_winx else 'per-level'} windows: W={win.n_windows}")
        return win

    chunks = list(event_boundaries(cfg.iters, (cfg.save_freq_iters, cfg.vis_freq_iters),
                                   cfg.scan_chunk))
    chunk_starts = [start for start, _ in chunks]

    def stage_rotation(iters_done: int):
        # stage the next rotation only when a chunk boundary with
        # pool_rotate_iters done lies ahead; the pool_rng draws keep their
        # order (one a rotation), so the staged subsets are the unstaged ones
        if not rotate_pool or not any(s >= iters_done + cfg.pool_rotate_iters
                                      for s in chunk_starts):
            return None
        sub = pool_rng.integers(0, len(dataset.pool), capacity)
        return _Staged(trainer.pool_to_device, dataset.pool, capacity, device, sub, settings)

    next_rotation = stage_rotation(start_iter)
    with timer.phase("precompute", sync=device):
        pre_lookups = make_pre()
        batch_windows = make_windows(pre_lookups)
    hbm.sample("precompute")
    t_train0 = time.time()
    done_iters = start_iter
    profiled = False
    for start, n in chunks:
        if start + n <= start_iter:
            continue  # already completed before the resume point
        if start < start_iter:  # straddling chunk: run only the remainder
            n -= start_iter - start
            start = start_iter
        if rotate_pool and iters_since_rotate >= cfg.pool_rotate_iters:
            with timer.phase("rotate", sync=device):
                if next_rotation is None:  # a resume that landed past the staging
                    next_rotation = _Staged(trainer.pool_to_device, dataset.pool, capacity,
                                            device, pool_rng.integers(0, len(dataset.pool),
                                                                      capacity), settings)
                dev_pool, n_valid = next_rotation.result()
                next_rotation = stage_rotation(start)
                iters_since_rotate = 0
                n_rotations += 1
                pre_lookups = make_pre()  # the pool changed
                batch_windows = make_windows(pre_lookups)
        # the chunk's batches depend only on its start iteration, so a resumed
        # run draws the batches an uninterrupted run would
        gen = torch.Generator(device).manual_seed(seed_for(cfg.seed, start))
        # a torch.profiler trace of one steady-state chunk (the second; a
        # one-chunk run traces its only chunk)
        trace_this = bool(cfg.profile_dir and not profiled
                          and (start > start_iter or start + n >= cfg.iters))
        t0 = get_time(device)
        with timer.phase("train"), device_trace(cfg.profile_dir if trace_this else None):
            params, opt_state, aux = trainer.train_chunk(
                params, opt_state, grid.tables, dev_pool, n_valid, start, gen, settings, n,
                pre_lookups=pre_lookups, batch_windows=batch_windows)
            t1 = get_time(device)
        if trace_this:
            profiled = True
            print(f"profiler trace written to {cfg.profile_dir}")
        iters_since_rotate += n
        done_iters = start + n
        hbm.sample("train")
        rec = {("loss/" + k): float(v) for k, v in aux["mean"].items()}
        rec.update({
            "iter": done_iters,
            "timing(s)/chunk": t1 - t0,
            "timing(s)/per_iter": (t1 - t0) / n,
            "samples_per_s": n * cfg.bs / max(t1 - t0, 1e-9),
            "pool_samples": len(dataset.pool),
            "pool/rotations": n_rotations,
        })
        print(f"iter {done_iters}/{cfg.iters} loss {rec['loss/total_loss']:.4f} "
              f"({rec['samples_per_s'] / 1e6:.2f}M samples/s)")

        if cfg.save_freq_iters > 0 and done_iters % cfg.save_freq_iters == 0 \
                and done_iters < cfg.iters:
            sync_features_to_grid(grid, params)
            name = f"{run_path}/model/model_iter_{done_iters}"
            ckpt.save_checkpoint(f"{name}.npz", grid, params, opt_state, done_iters)
            ckpt.save_decoders(f"{name}_decoders.npz", params)
        if cfg.vis_freq_iters > 0 and done_iters % cfg.vis_freq_iters == 0:
            sync_features_to_grid(grid, params)
            print("Begin mesh reconstruction from the implicit map")
            # a time-conditioned map gives one mesh per even frame, at that
            # frame's timestamp (shine_batch.py:248-264)
            stamps = ([None] if not cfg.time_conditioned
                      else [f for f in dataset.frame_ids() if f % 2 == 0])
            for ts in stamps:
                tag = f"iter_{done_iters}" + ("" if ts is None else f"_ts_{ts}")
                mesh_path = f"{run_path}/mesh/mesh_{tag}.ply"
                map_path = f"{run_path}/map/sdf_map_{tag}.ply"
                mesher.ts = 0 if ts is None else ts
                with timer.phase("mesh"):
                    if cfg.mc_with_octree:
                        mesh = mesher.recon_octree_mesh(cfg.mc_query_level, cfg.mc_res_m,
                                                        mesh_path, map_path, cfg.save_map,
                                                        cfg.semantic_on)
                    else:
                        mesh = mesher.recon_bbx_mesh(dataset.map_bbx, cfg.mc_res_m,
                                                     mesh_path, map_path, cfg.save_map,
                                                     cfg.semantic_on)
            peak = hbm.sample("mesh")
            rec.update({"mesh/vertices": mesh.vertices.shape[0],
                        "mesh/triangles": mesh.triangles.shape[0],
                        "mesh/peak_gb": round(peak / 2**30, 3)})
            rec.update({f"mesh(s)/{k}": v for k, v in mesher.timing.items()})
            print(f"mesh: {mesh.vertices.shape[0]} vertices, {mesh.triangles.shape[0]} "
                  "triangles; " + ", ".join(f"{k} {v:.3f} s" for k, v in mesher.timing.items())
                  + f"; peak device memory {peak / 2**30:.3f} GiB")
        rec.update({f"phase(s)/{p}": v for p, v in timer.summary().items()})
        rec["hbm/peak_live_gb"] = round(hbm.peak_live / 2**30, 3)
        logger.log(rec)

    print(f"training: {time.time() - t_train0:.1f} s for {done_iters} iters")
    sync_features_to_grid(grid, params)
    with timer.phase("checkpoint"):
        ckpt.save_checkpoint(f"{run_path}/model/model_final.npz", grid, params, opt_state,
                             done_iters)
        ckpt.save_decoders(f"{run_path}/model/model_final_decoders.npz", params)
    print("phase totals(s): " + ", ".join(f"{p}={v:.1f}" for p, v in timer.summary().items()))
    hrep = hbm.report()
    print(f"peak device memory: {hrep['peak_live_gb']} GiB {hrep['samples_gb']}")
    logger.close()
    return run_path, grid, params


if __name__ == "__main__":
    run_shine_mapping_batch(sys.argv[1] if len(sys.argv) > 1 else None)
