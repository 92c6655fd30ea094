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
even frame at that frame's timestamp.

Several ranks (JAX shine_batch.py:54-60, :85-92, :165-181, :206-300), one
process a card: ``tpu.mesh_shape: n`` in one launch spawns n ranks
(``torch.multiprocessing``, start method spawn; NCCL when there are n
cards, else gloo on the cards there are, or gloo on the CPU), and
``tpu.num_processes`` / ``coordinator`` / ``process_id`` or torchrun's
``RANK`` / ``WORLD_SIZE`` join ranks launched apart.  Each rank preprocesses
its share of the frames (``tpu.shard_ingest``) and trains its share of each
batch; ``tpu.table_sharding: replicated`` keeps the whole tables on every
rank, ``rows`` a row block of each: on routed fused windows through K2's
row-sharded caller, else on iid batches whose entries route live each step
(``feature_update: fused`` through the same kernel; ``sparse``, ``dense``
and SGD summing the routed entries by row).  ``pallas`` on rows without
routed windows is refused, as in the JAX driver.  The ranks share the
meshing's queries.  Rank 0 alone writes the run directory: checkpoints,
meshes, ``metrics.jsonl``.  ``tpu.num_processes: P`` joins P processes
launched apart (``tpu.coordinator``, ``process_id``), each running
``mesh_shape / P`` ranks, or one a card it sees (``parallel.mesh.launch_plan``);
unlike the JAX driver, whose every process writes a ``_rank{k}`` run
directory, the other processes write nothing.  ``eval.o3d_vis_on`` renders
a snapshot of each mesh into ``run_path/vis`` (``visualizer.MapVisualizer``
without Open3D; rank 0).

Usage:
    python -m shine_mapping_tpu_torch.cli.shine_batch <config.yaml>
    torchrun --nproc_per_node 4 -m shine_mapping_tpu_torch.cli.shine_batch <config.yaml>
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import torch

from ..config import SHINEConfig
from ..data.dataset import LiDARDataset
from ..mesher import Mesher
from ..parallel import comm
from ..parallel import mesh as pmesh
from ..train import trainer
from ..train.optimizer import FEATURES, init_opt_state
from ..utils import checkpoint as ckpt
from ..utils import profiling
from ..utils.experiment import get_time, setup_experiment
from ..utils.metrics_logger import MetricsLogger
from ..utils.profiling import HbmMonitor, PhaseTimer, device_trace
from ..visualizer import MapVisualizer
from .common import (
    build_grid,
    event_boundaries,
    join_ranks,
    maybe_load_model,
    pad_opt_state_features,
    pool_capacity_for,
    seed_for,
    spawn_ranks,
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


def run_shine_mapping_batch(config_path: str | None = None, cfg: SHINEConfig | None = None,
                            group=None, backend: str | None = None):
    """Run the batch pipeline; returns (run_path, grid, params).

    ``group``: this rank's ``parallel.mesh.DataGroup`` when the caller
    joined the ranks.  Otherwise ``tpu.mesh_shape`` > 1 spawns that many
    ranks and returns (rank 0's run_path, None, None), with ``backend``
    (``nccl`` / ``gloo``; by default NCCL when each rank has a card, else
    gloo); and ``tpu.num_processes`` or torchrun's environment join this
    process to its ranks."""
    if cfg is None:
        if config_path is None:
            sys.exit("Please provide the path to the config file.\n"
                     "Try: python -m shine_mapping_tpu_torch.cli.shine_batch xxx_config.yaml")
        cfg = SHINEConfig().load(config_path)
    torch_device_of(cfg)  # raises here when the card is asked for and absent
    if group is None:
        launch = pmesh.launch_plan(cfg, backend)
        if launch is not None and launch.local > 1:
            return spawn_ranks(run_shine_mapping_batch, cfg, config_path, launch), None, None
        group = join_ranks(cfg, launch, backend)
    if group is not None and group.world == 1:
        group = None
    device = torch_device_of(cfg) if group is None else group.device
    primary = group is None or group.primary
    say = print if primary else (lambda *a, **k: None)
    if group is not None:
        say(f"{group.world} ranks over {group.backend} (tables {cfg.table_sharding})")

    if primary:
        run_path = setup_experiment(cfg, config_path)
    if group is not None:  # the others take rank 0's run directory
        run_path = comm.gather_bytes(group, run_path.encode() if primary else b"")[0].decode()
    logger = MetricsLogger(run_path, cfg.wandb_vis_on, run_name=cfg.name) if primary else None

    grid = build_grid(cfg)
    # load pretrained decoders / resume a full map checkpoint BEFORE the
    # data phase so new frames grow the restored structure
    grid, loaded_decoders, freeze, loaded_opt, start_iter = maybe_load_model(cfg, grid)
    dataset = LiDARDataset(cfg, grid)
    # without Open3D the visualizer renders offscreen PNG frames into the
    # run directory instead of opening a window
    vis = (MapVisualizer(snapshot_dir=os.path.join(run_path, "vis"))
           if cfg.o3d_vis_on and primary else None)

    # ---------------------------------------------------------------- data phase
    say("Load, preprocess and sample data")
    timer = PhaseTimer()
    with timer.phase("data"):
        if group is not None and cfg.shard_ingest:
            # each rank preprocesses its share of the frames; every rank
            # integrates all (bit-identical to a one-process data phase)
            from ..parallel.ingest import process_frames_sharded

            process_frames_sharded(dataset, dataset.frame_ids(), group)
        elif cfg.num_workers > 1:
            dataset.process_frames_pipelined(dataset.frame_ids(), cfg.num_workers)
        else:
            for frame_id in dataset.frame_ids():
                dataset.process_frame(frame_id)
    say(f"data phase: {timer.totals['data']:.1f} s, pool={len(dataset.pool)} samples")
    # release the accumulate buffers' doubling headroom (up to 2x pool RAM)
    dataset.finalize_pool()
    if primary:
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

    # the ranks share the meshing's queries; rank 0 marches and writes
    mesher = Mesher(cfg, grid, params["geo"], params["sem"], group=group)
    mesher.global_transform = np.linalg.inv(dataset.begin_pose_inv)
    if primary:
        with timer.phase("map-export"):
            dataset.write_merged_pc(run_path + "/map/pc_map_down.ply")

    if resume:
        opt_state = pad_opt_state_features(loaded_opt, params)
        say(f"Resuming from iter {start_iter} (optimizer state restored)")
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
            say(f"pool {len(dataset.pool)} > device budget {capacity}: rotating "
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
    say("Begin mapping")
    feat_shapes = [tuple(f.shape) for f in grid.features]
    use_winx = cfg.windows_fused
    use_windows = (cfg.batch_windows and cfg.precompute_lookups
                   and trainer.batch_windows_ok(settings, feat_shapes, use_winx))
    if cfg.batch_windows and not use_windows:
        say("tpu.batch_windows requested but prerequisites unmet "
            "(needs the pallas update, point loss, no consistency, "
            "precompute_lookups) — falling back to iid batches")
    # row-sharded tables train through routed fused windows (each rank
    # gathers and updates its row blocks, K2's row-sharded caller) where
    # they can run, else on iid batches routed live each step (fused:
    # the same kernel; sparse, dense, sgd: the routed entries summed by row)
    rows = group is not None and cfg.table_sharding == "rows"
    if rows and use_windows and not (use_winx and trainer.shard_windows_ok(
            settings, feat_shapes, group.world)):
        say("row-sharded tables: routed windows need the fused layout and tables and a "
            f"batch that split evenly over {group.world} ranks — training on iid batches")
        use_windows = False
    n_shards = group.world if rows and use_windows else 0
    # device-memory guard: the windows live for the whole run beside the map
    # and the pool (with rotation also the staged next pool); the estimate
    # is the per-level layout's, which holds at least the fused one's bytes,
    # so an over-budget run goes straight to iid batches
    n_live = capacity if rotate_pool else len(dataset.pool)
    # one rank's bytes (routed windows: its share)
    est = trainer.estimate_windows_bytes(n_live, settings, feat_shapes, shards=n_shards)
    if rotate_pool:
        est += sum(a.nbytes for a in dev_pool.values())
    if use_windows and est > cfg.windows_hbm_budget_gb * (1 << 30):
        if rows:
            raise ValueError(f"routed windows would hold ~{est / 2**30:.1f} GiB a rank (> "
                             f"tpu.windows_hbm_budget_gb {cfg.windows_hbm_budget_gb})")
        say(f"window precompute would hold ~{est / 2**30:.1f} GiB (> "
            f"tpu.windows_hbm_budget_gb {cfg.windows_hbm_budget_gb}) — falling back "
            "to iid batches")
        use_windows = False
    # bf16 map mode: tables stored bfloat16, stochastic-rounding update.  A
    # resume casts the checkpoint's tables (their exact f32 upcast) back
    # bit for bit; the moments come back bf16 as saved.
    use_params_bf16 = (cfg.params_bf16 and use_windows and use_winx
                       and opt_state.m[FEATURES][0].dtype == torch.bfloat16)
    if cfg.params_bf16 and not use_params_bf16:
        say("tpu.params_bf16 requested but prerequisites unmet (needs "
            "batch_windows + windows_fused, moments_bf16) — keeping f32 tables")
    if use_params_bf16:
        grid.cast_features(torch.bfloat16)
        params[FEATURES] = list(grid.features)
        say("bf16 map mode: feature tables stored bfloat16 "
            "(stochastic-rounding Adam; half map memory)")
    if group is not None:
        # every rank built the same state; rows keeps each rank's blocks
        params, opt_state, _ = pmesh.place_training_state(
            group, params, opt_state, table_sharding=cfg.table_sharding)

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
            settings, feat_shapes, fused=use_winx, shards=n_shards,
            rank=group.rank if rows else None, deterministic=group is not None and not rows)
        if rows:
            rt = win.route
            held = sum(t.nbytes for t in (win.idx, rt.serve, rt.recv_inv, rt.owner_sel,
                                          rt.pre.rows, rt.pre.order, rt.pre.tile_off))
            say(f"routed row-sharded windows over {n_shards} ranks: W={win.n_windows} "
                f"E={rt.E}, {held / 2**30:.3f} GiB a rank")
        else:
            say(f"{'fused' if use_winx else 'per-level'} windows: W={win.n_windows}")
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
        # one-chunk run traces its only chunk), with the phase and the step's
        # stage spans as its annotations
        trace_this = bool(cfg.profile_dir and not profiled
                          and (start > start_iter or start + n >= cfg.iters))
        t0 = get_time(device)
        with device_trace(cfg.profile_dir if trace_this else None), timer.phase("train"):
            params, opt_state, aux = trainer.train_chunk(
                params, opt_state, grid.tables, dev_pool, n_valid, start, gen, settings, n,
                group=group, pre_lookups=pre_lookups, batch_windows=batch_windows)
            t1 = get_time(device)
        if trace_this:
            profiled = True
            say(f"profiler trace written to {cfg.profile_dir}")
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
        say(f"iter {done_iters}/{cfg.iters} loss {rec['loss/total_loss']:.4f} "
            f"({rec['samples_per_s'] / 1e6:.2f}M samples/s)")

        if cfg.save_freq_iters > 0 and done_iters % cfg.save_freq_iters == 0 \
                and done_iters < cfg.iters:
            sync_features_to_grid(grid, params, group)
            name = f"{run_path}/model/model_iter_{done_iters}"
            ckpt.save_checkpoint(f"{name}.npz", grid, params, opt_state, done_iters, group)
            if primary:
                ckpt.save_decoders(f"{name}_decoders.npz", params)
        if cfg.vis_freq_iters > 0 and done_iters % cfg.vis_freq_iters == 0:
            sync_features_to_grid(grid, params, group)
            say("Begin mesh reconstruction from the implicit map")
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
                if vis is not None and ts is None:
                    vis.update_mesh(mesh)
            peak = hbm.sample("mesh")
            if mesh is not None:  # rank 0's
                rec.update({"mesh/vertices": mesh.vertices.shape[0],
                            "mesh/triangles": mesh.triangles.shape[0],
                            "mesh/peak_gb": round(peak / 2**30, 3)})
                rec.update({f"mesh(s)/{k}": v for k, v in mesher.timing.items()})
                say(f"mesh: {mesh.vertices.shape[0]} vertices, {mesh.triangles.shape[0]} "
                    "triangles; " + ", ".join(f"{k} {v:.3f} s"
                                              for k, v in mesher.timing.items())
                    + f"; peak device memory {peak / 2**30:.3f} GiB")
        rec.update({f"phase(s)/{p}": v for p, v in timer.summary().items()})
        rec["hbm/peak_live_gb"] = round(hbm.peak_live / 2**30, 3)
        if logger is not None:
            logger.log(rec)

    say(f"training: {time.time() - t_train0:.1f} s for {done_iters} iters")
    sync_features_to_grid(grid, params, group)
    with timer.phase("checkpoint"):
        ckpt.save_checkpoint(f"{run_path}/model/model_final.npz", grid, params, opt_state,
                             done_iters, group)
        if primary:
            ckpt.save_decoders(f"{run_path}/model/model_final_decoders.npz", params)
    say("phase totals(s): " + ", ".join(f"{p}={v:.1f}" for p, v in timer.summary().items()))
    hrep = hbm.report()
    say(f"peak device memory: {hrep['peak_live_gb']} GiB {hrep['samples_gb']}")
    if logger is not None:
        logger.close()
    if vis is not None:
        vis.stop()
    return run_path, grid, params


if __name__ == "__main__":
    run_shine_mapping_batch(sys.argv[1] if len(sys.argv) > 1 else None)
