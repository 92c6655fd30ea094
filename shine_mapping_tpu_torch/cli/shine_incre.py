"""Incremental (online) mapping driver, on one card or several.

Port of ``shine_mapping_tpu/cli/shine_incre.py`` (reference
shine_incre.py:22-247).  Per frame: grow the map (with last-frame snapshots
under continual learning), rebuild the optimizer over the grown structure
(Adam state reset, shine_incre.py:108-109), run ``iters`` steps with either
the window replay pool or the continual-learning regularizer, update the
feature importance, and periodically reconstruct the mesh.  The decoders
freeze after ``freeze_after_frame`` frames.  It runs on ``setting.device``
(the card unless the config says ``cpu``).

The path choices are the JAX driver's predicates: per-frame pool lookups
when the frame's steps outweigh ``PRECOMPUTE_WORK_RATIO`` pool sweeps,
fused epoch windows (with the reg owner flags under continual learning)
when ``tpu.batch_windows`` and ``windows_fused`` ask for them and they fit
``windows_hbm_budget_gb``, bf16 moments only where the resolved update is
``pallas``.  ``tpu.params_bf16`` is not read, as in the JAX driver.

Several ranks (JAX shine_incre.py:64-66, :128-178): ``tpu.mesh_shape: n``
spawns n ranks; ``tpu.num_processes: P`` joins P processes launched apart,
each running ``mesh_shape / P`` ranks or one a card it sees, and torchrun's
environment one rank a process (``cli.common.spawn_ranks`` / ``join_ranks``,
as the batch driver).  Every rank processes every frame and trains its share of each
batch.  Per frame the grown tables, a fresh Adam state and the shadow
tables are placed again (``parallel.mesh.place_training_state``):
``tpu.table_sharding: replicated`` keeps them whole (pool lookups and fused
windows as on one card, their preps sorted for the update's deterministic
sum), ``rows`` cuts each rank's row blocks again, which train on iid
batches routed live each step (no windows, as in JAX) and are gathered
whole after the frame.  The importance sweep splits its batches over the
ranks, the meshing its queries; rank 0 alone writes ``metrics.jsonl``,
the meshes and ``model_final.npz``.  ``eval.o3d_vis_on`` renders each
frame's scan, pose and latest mesh into ``run_path/vis``
(``visualizer.MapVisualizer`` without Open3D; rank 0).

Usage:
    python -m shine_mapping_tpu_torch.cli.shine_incre <config.yaml>
    torchrun --nproc_per_node 2 -m shine_mapping_tpu_torch.cli.shine_incre <config.yaml>
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import SHINEConfig
from ..data.dataset import LiDARDataset
from ..mesher import Mesher
from ..parallel import comm
from ..parallel import mesh as pmesh
from ..train import trainer
from ..train.importance import cal_feature_importance
from ..train.optimizer import FEATURES, init_opt_state
from ..utils import checkpoint as ckpt
from ..utils import profiling
from ..utils.experiment import get_time, setup_experiment
from ..utils.metrics_logger import MetricsLogger
from ..utils.profiling import HbmMonitor
from ..visualizer import MapVisualizer
from .common import (
    build_grid,
    join_ranks,
    maybe_load_model,
    pool_capacity_for,
    refresh_params_features,
    seed_for,
    spawn_ranks,
    sync_features_to_grid,
    torch_device_of,
)

# Pool lookups (and fused windows) per frame only when a frame's steps
# outweigh the pool: the precompute costs about a pool sweep (JAX
# shine_incre.py:44-49; the same gate here)
PRECOMPUTE_WORK_RATIO = 4.0


def run_shine_mapping_incremental(config_path: str | None = None,
                                  cfg: SHINEConfig | None = None, group=None,
                                  backend: str | None = None):
    """Run the incremental pipeline; returns (run_path, grid, params).

    ``group``: this rank's ``parallel.mesh.DataGroup`` when the caller
    joined the ranks.  Otherwise ``tpu.mesh_shape`` > 1 spawns that many
    ranks and returns (rank 0's run_path, None, None), with ``backend``
    (``nccl`` / ``gloo``; by default NCCL when each rank has a card, else
    gloo); and ``tpu.num_processes`` or torchrun's environment join this
    process to its ranks."""
    if cfg is None:
        if config_path is None:
            sys.exit("Please provide the path to the config file.\n"
                     "Try: python -m shine_mapping_tpu_torch.cli.shine_incre xxx_config.yaml")
        cfg = SHINEConfig().load(config_path)
    device = torch_device_of(cfg)
    if group is None:
        launch = pmesh.launch_plan(cfg, backend)
        if launch is not None and launch.local > 1:
            return (spawn_ranks(run_shine_mapping_incremental, cfg, config_path, launch),
                    None, None)
        group = join_ranks(cfg, launch, backend)
    if group is not None and group.world == 1:
        group = None
    dp = group is not None
    if dp:
        device = group.device
    primary = not dp or group.primary
    rows = dp and cfg.table_sharding == "rows"
    say = print if primary else (lambda *a, **k: None)
    if dp:
        say(f"{group.world} ranks over {group.backend} (tables {cfg.table_sharding})")

    if primary:
        run_path = setup_experiment(cfg, config_path)
    if dp:  # the others take rank 0's run directory
        run_path = comm.gather_bytes(group, run_path.encode() if primary else b"")[0].decode()
    logger = MetricsLogger(run_path, cfg.wandb_vis_on, run_name=cfg.name) if primary else None

    grid = build_grid(cfg)
    # the optimizer is rebuilt every frame, so only the map and decoders of
    # a saved model restore
    grid, loaded_decoders, freeze, _, _ = maybe_load_model(cfg, grid)
    dataset = LiDARDataset(cfg, grid)
    # without Open3D the visualizer renders offscreen PNG frames into the
    # run directory instead of opening a window
    vis = (MapVisualizer(snapshot_dir=os.path.join(run_path, "vis"))
           if cfg.o3d_vis_on and primary else None)

    params = trainer.init_params(cfg, grid, torch.Generator(device).manual_seed(cfg.seed))
    if loaded_decoders:
        params.update(loaded_decoders)
    reg = cfg.continual_learning_reg
    if reg:
        # shine_incre.py:77-78; over several ranks each rank's part of the
        # sum is added, never divided by the world
        cfg.loss_reduction = "sum"

    # the ranks share the meshing's queries; rank 0 marches and writes
    mesher = Mesher(cfg, grid, params["geo"], params["sem"], group=group)
    mesher.global_transform = np.linalg.inv(dataset.begin_pose_inv)

    total_iter = 0
    hbm = HbmMonitor(device)
    profiling.last_hbm_monitor = hbm
    for processed_frame, frame_id in enumerate(dataset.frame_ids()):
        if processed_frame == cfg.freeze_after_frame and not freeze:
            say("Freeze the decoder")
            freeze = True

        T0 = get_time(device)
        dataset.process_frame(frame_id, incremental_on=reg)
        params = refresh_params_features(grid, params)
        settings = trainer.TrainSettings.from_config(
            cfg, grid.levels, continual_reg_on=reg, freeze_decoder=freeze,
            n_used=trainer.used_rows_for(grid, granularity=4))
        feat_shapes = [tuple(f.shape) for f in params[FEATURES]]
        capacity = pool_capacity_for(len(dataset.pool), 1 << 17)
        dev_pool, n_valid = trainer.pool_to_device(dataset.pool, capacity, device,
                                                   settings=settings)

        # the window decision comes before the optimizer: fused windows keep
        # the kernel update under reg, which is what bf16 moments need;
        # row-sharded tables train on iid batches (JAX shine_incre.py:141)
        use_pre = (cfg.precompute_lookups
                   and cfg.iters * cfg.bs >= PRECOMPUTE_WORK_RATIO * capacity
                   and trainer.resolve_feature_update(settings) in ("fused", "pallas"))
        use_winx = (use_pre and cfg.batch_windows and cfg.windows_fused and not rows
                    and trainer.batch_windows_ok(settings, feat_shapes, fused=True)
                    and trainer.estimate_windows_bytes(n_valid, settings, feat_shapes,
                                                       reg_cover=reg)
                    <= cfg.windows_hbm_budget_gb * (1 << 30))
        opt_state = init_opt_state(params, moments_bf16=(
            cfg.moments_bf16
            and trainer.resolve_feature_update(settings, fused_windows=use_winx) == "pallas"))
        # importance and the last-frame snapshot (a copy since update():
        # training never writes it)
        shadow = ({"importance": list(grid.importance_weight),
                   "last_frame": list(grid.features_last_frame)} if reg else None)
        if dp:
            # the grown tables, fresh moments and shadow placed again (rows:
            # each rank's blocks of the doubled capacities cut anew)
            params, opt_state, shadow = pmesh.place_training_state(
                group, params, opt_state, shadow, table_sharding=cfg.table_sharding)

        pre_lookups = batch_windows = None
        if use_pre:
            pre_lookups = trainer.precompute_pool_lookups(
                grid.tables, dev_pool["coord"], grid.levels, [sh[0] for sh in feat_shapes])
            if use_winx:
                batch_windows = trainer.precompute_batch_windows(
                    pre_lookups, n_valid,
                    torch.Generator(device).manual_seed(seed_for(cfg.seed, frame_id, 0x5157)),
                    settings, feat_shapes, fused=True, reg_cover=reg, deterministic=dp)
                if processed_frame == 0:
                    say(f"per-frame fused epoch windows on ({batch_windows.n_windows} "
                        "windows)" + (" with reg fold" if reg else ""))
        T1 = get_time(device)
        gen = torch.Generator(device).manual_seed(seed_for(cfg.seed, frame_id))
        params, opt_state, aux = trainer.train_chunk(
            params, opt_state, grid.tables, dev_pool, n_valid, 0, gen, settings, cfg.iters,
            group=group, pre_lookups=pre_lookups, batch_windows=batch_windows, shadow=shadow)
        total_iter += cfg.iters
        hbm.sample("train")
        sync_features_to_grid(grid, params, group)  # rows: the blocks gathered whole

        T_imp = get_time(device)
        if reg:
            cal_feature_importance(
                grid, params["geo"], dev_pool["coord"][:n_valid],
                dev_pool["sdf_label"][:n_valid], sigma=settings.sigma_sigmoid, bs=cfg.bs,
                down_rate=cfg.cal_importance_weight_down_rate,
                loss_reduction=cfg.loss_reduction, group=group)
            hbm.sample("importance")
        T2 = get_time(device)

        cur_mesh = None  # rank 0's mesh of this frame
        if processed_frame == 0 or (processed_frame + 1) % cfg.mesh_freq_frame == 0:
            say("Begin mesh reconstruction from the implicit map")
            mesh_path = f"{run_path}/mesh/mesh_frame_{frame_id + 1}.ply"
            map_path = f"{run_path}/map/sdf_map_frame_{frame_id + 1}.ply"
            if cfg.mc_with_octree:
                cur_mesh = mesher.recon_octree_mesh(cfg.mc_query_level, cfg.mc_res_m,
                                                    mesh_path, map_path, cfg.save_map,
                                                    cfg.semantic_on)
            else:
                bbx = dataset.cur_bbx if cfg.mc_local else dataset.map_bbx
                cur_mesh = mesher.recon_bbx_mesh(bbx, cfg.mc_res_m, mesh_path, map_path,
                                                 cfg.save_map, cfg.semantic_on)
            hbm.sample("mesh")
        T3 = get_time(device)

        rec = {("loss/" + k): float(v) for k, v in aux["mean"].items()}
        rec.update({
            "frame": processed_frame,
            "iter": total_iter,
            "pool_samples": int(n_valid),
            "timing(s)/preprocess": T1 - T0,
            "timing(s)/mapping": T2 - T1,  # training and importance, as in JAX
            "timing(s)/importance": T2 - T_imp,
            "timing(s)/reconstruct": T3 - T2,
            "hbm/peak_live_gb": round(hbm.peak_live / 2**30, 3),
        })
        if logger is not None:
            logger.log(rec)
        say(f"frame {frame_id}: loss {rec['loss/total_loss']:.4f} "
            f"pre {T1 - T0:.2f}s map {T2 - T1:.2f}s recon {T3 - T2:.2f}s")
        if vis is not None:
            vis.update(dataset.cur_frame_pc, dataset.cur_pose_ref, cur_mesh)

    # the grid holds the last frame's trained tables (synced after its chunk)
    ckpt.save_checkpoint(f"{run_path}/model/model_final.npz", grid, params,
                         init_opt_state(params), total_iter, group)
    say(f"peak device memory: {hbm.report()['peak_live_gb']} GiB")
    if logger is not None:
        logger.close()
    if vis is not None:
        vis.stop()
    return run_path, grid, params


if __name__ == "__main__":
    run_shine_mapping_incremental(sys.argv[1] if len(sys.argv) > 1 else None)
