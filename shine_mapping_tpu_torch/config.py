"""Configuration for the PyTorch / CUDA SHINE mapping port.

The port's own copy of ``shine_mapping_tpu/config.py``: same fields, same
YAML section schema (setting / process / sampler / octree / decoder / loss /
continual / optimizer / eval) and the same derived quantities
(``calculate_world_scale``, ``infer_bs``, ``mc_query_level``), so every
config under ``config/`` loads to the same values in both packages.

Differences: ``setting.device`` is mapped to a torch device (``tpu``,
``cuda`` and ``gpu`` -> ``cuda``; ``cpu`` -> ``cpu``).  The optional ``tpu:``
section is accepted with the same unknown-key check; of its knobs the port
reads ``feature_update``, ``fuse_update_levels`` and ``sort_batch``
(``TrainSettings.from_config``).  The bf16 map mode's knobs are arguments
of the training API (see the comment on the section below); the rest
belong to paths not ported yet and are loaded but unused.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import yaml


@dataclasses.dataclass
class SHINEConfig:
    # ------------------------------------------------------------------ setting
    name: str = "dummy"
    output_root: str = ""
    pc_path: str = ""
    pose_path: str = ""
    calib_path: str = ""
    label_path: str = ""  # point-wise semantic label folder

    load_model: bool = False
    model_path: str = "/"

    first_frame_ref: bool = True
    begin_frame: int = 0
    end_frame: int = 0
    every_frame: int = 1

    seed: int = 42
    num_workers: int = 12
    device: str = "cuda"  # torch device of the entry points (see torch_device)
    gpu_id: str = "0"  # accepted for config parity, unused
    dtype: str = "float32"
    pc_count_gpu_limit: int = 500  # frames kept device-side before host pools

    # z-shift used to dodge octree-boundary marching-cube artifacts on
    # synthetic data (reference utils/config.py:38)
    global_shift_default: float = 0.0

    # ------------------------------------------------------------------ process
    min_range: float = 2.75
    pc_radius: float = 20.0
    min_z: float = -10.0
    max_z: float = 30.0

    rand_downsample: bool = True
    vox_down_m: float = 0.03
    rand_down_r: float = 1.0

    filter_noise: bool = False
    sor_nn: int = 25
    sor_std: float = 2.5
    estimate_normal: bool = False
    normal_radius_m: float = 0.2
    normal_max_nn: int = 20

    # ------------------------------------------------------------------ semantic
    semantic_on: bool = False
    sem_class_count: int = 20
    sem_label_decimation: int = 1
    filter_moving_object: bool = False

    map_vox_down_m: float = 0.05

    # ------------------------------------------------------------------ octree
    tree_level_world: int = 10
    tree_level_feat: int = 4
    leaf_vox_size: float = 0.5
    feature_dim: int = 8
    feature_std: float = 0.05
    poly_int_on: bool = True
    octree_from_surface_samples: bool = True

    # ------------------------------------------------------------------ sampler
    surface_sample_range_m: float = 0.5
    surface_sample_n: int = 5
    free_sample_begin_ratio: float = 0.3
    free_sample_end_dist_m: float = 0.5
    free_sample_n: int = 2
    clearance_dist_m: float = 0.3
    clearance_sample_n: int = 0

    # ------------------------------------------------------------------ continual
    continual_learning_reg: bool = True
    lambda_forget: float = 1e5
    cal_importance_weight_down_rate: int = 2
    window_replay_on: bool = True
    window_radius: float = 50.0

    occu_update_on: bool = False

    # ------------------------------------------------------------------ decoder
    geo_mlp_level: int = 2
    geo_mlp_hidden_dim: int = 32
    geo_mlp_bias_on: bool = True
    sem_mlp_level: int = 2
    sem_mlp_hidden_dim: int = 32
    sem_mlp_bias_on: bool = True
    freeze_after_frame: int = 20

    # ------------------------------------------------------------------ loss
    ray_loss: bool = False
    main_loss_type: str = "sdf_bce"  # sdf_bce | sdf_l1 | sdf_l2 | dr | dr_neus
    loss_reduction: str = "mean"  # mean | sum
    sigma_sigmoid_m: float = 0.1
    sigma_scale_constant: float = 0.0
    logistic_gaussian_ratio: float = 0.55
    proj_correction_on: bool = False
    predict_sdf: bool = False
    neus_loss_on: bool = False
    loss_weight_on: bool = False
    behind_dropoff_on: bool = False
    dropoff_min_sigma: float = 1.0
    dropoff_max_sigma: float = 5.0
    normal_loss_on: bool = False
    weight_n: float = 0.01
    ekional_loss_on: bool = False
    weight_e: float = 0.1
    consistency_loss_on: bool = False
    weight_c: float = 1.0
    consistency_count: int = 1000
    consistency_range: float = 0.1
    history_weight: float = 1.0
    weight_s: float = 1.0
    time_conditioned: bool = False

    # ------------------------------------------------------------------ optimizer
    iters: int = 200
    opt_adam: bool = True
    bs: int = 4096
    lr: float = 1e-3
    weight_decay: float = 0.0
    adam_eps: float = 1e-15
    lr_level_reduce_ratio: float = 1.0
    lr_iters_reduce_ratio: float = 0.1
    lr_decay_step: List[int] = dataclasses.field(
        default_factory=lambda: [10000, 50000, 100000]
    )
    dropout: float = 0.0

    # ------------------------------------------------------------------ eval / vis
    wandb_vis_on: bool = False
    o3d_vis_on: bool = False  # headless by default
    eval_on: bool = False
    eval_outlier_thre: float = 0.5
    eval_freq_iters: int = 100
    vis_freq_iters: int = 100
    save_freq_iters: int = 100
    mesh_freq_frame: int = 1

    mc_res_m: float = 0.1
    pad_voxel: int = 1
    mc_with_octree: bool = True
    mc_query_level: int = 8
    mc_vis_level: int = 1
    mc_mask_on: bool = True
    mc_local: bool = False
    min_cluster_vertices: int = 50

    infer_bs: int = 4096
    occ_binary_mc: bool = False
    grid_loss_vis_on: bool = False
    mesh_vis_on: bool = True
    save_map: bool = False

    # ------------------------------------------------------------------ derived
    scale: float = 1.0
    world_size: float = 1.0

    # ------------------------------------------------------------------ "tpu:" section
    # Knobs of the JAX package's device paths, loaded with the same names and
    # defaults so both packages read a YAML to equal fields (meanings:
    # shine_mapping_tpu/config.py).  TrainSettings.from_config reads
    # feature_update ("fused" | "pallas": both run the dense Adam step of
    # ops/adam_kernel.py on the feature tables), fuse_update_levels (one
    # kernel launch over all levels instead of one per level) and
    # sort_batch.  The bf16 map mode's knobs select train.trainer arguments,
    # which the batch CLI (not ported yet) will set from them:
    # precompute_lookups -> precompute_pool_lookups, batch_windows /
    # windows_fused -> precompute_batch_windows(fused=...), moments_bf16 ->
    # init_opt_state(moments_bf16=...), params_bf16 ->
    # HashGridHost.cast_features(bfloat16).  windows_split_k selects nothing
    # on the card: on the TPU it only reorders the samples inside a window
    # for the gathers.
    scan_chunk: int = 100
    init_node_capacity: int = 1 << 15
    init_corner_capacity: int = 1 << 16
    mesh_shape: int = 1
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1
    table_sharding: str = "replicated"
    shard_ingest: bool = True
    feature_update: str = "fused"
    fuse_update_levels: bool = False
    sort_batch: bool = False
    moments_bf16: bool = False
    precompute_lookups: bool = True
    params_bf16: bool = False
    batch_windows: bool = False
    windows_fused: bool = True
    windows_split_k: bool = True
    windows_hbm_budget_gb: float = 4.0
    profile_dir: str = ""
    init_pool_capacity: int = 1 << 20
    max_device_pool: int = 1 << 25
    pool_rotate_iters: int = 2000

    # ------------------------------------------------------------------ loading
    def load(self, config_file: str) -> "SHINEConfig":
        """Load a YAML config with the reference's section schema.

        Mirrors reference utils/config.py:206-369: required keys are read with
        direct indexing into the same sections; keys the reference comments
        out are optional here too.
        """
        with open(os.path.abspath(config_file)) as f:
            args = yaml.safe_load(f)

        def opt(section: str, key: str, default):
            return args.get(section, {}).get(key, default)

        setting = args["setting"]
        self.name = setting["name"]
        self.output_root = setting["output_root"]
        self.pc_path = setting["pc_path"]
        self.pose_path = setting["pose_path"]
        self.calib_path = setting["calib_path"]
        if self.semantic_on:
            self.label_path = setting.get("label_path", self.label_path)
        self.load_model = setting["load_model"]
        self.model_path = setting["model_path"]
        self.first_frame_ref = setting["first_frame_ref"]
        self.begin_frame = setting["begin_frame"]
        self.end_frame = setting["end_frame"]
        self.every_frame = setting["every_frame"]
        self.device = torch_device(setting.get("device", self.device))
        self.gpu_id = setting.get("gpu_id", self.gpu_id)

        self.min_range = args["process"]["min_range_m"]
        self.pc_radius = args["process"]["pc_radius_m"]
        self.rand_downsample = args["process"]["rand_downsample"]
        self.vox_down_m = args["process"]["vox_down_m"]
        self.rand_down_r = args["process"]["rand_down_r"]
        self.min_z = args["process"]["min_z_m"]
        self.estimate_normal = opt("process", "estimate_normal", self.estimate_normal)
        self.filter_noise = opt("process", "filter_noise", self.filter_noise)
        self.semantic_on = opt("process", "semantic_on", self.semantic_on)
        # read here, not in the JAX package (ROADMAP Queue C item 3)
        self.filter_moving_object = opt("process", "filter_moving_object",
                                        self.filter_moving_object)
        if self.semantic_on:
            self.label_path = setting.get("label_path", self.label_path)

        self.surface_sample_range_m = args["sampler"]["surface_sample_range_m"]
        self.surface_sample_n = args["sampler"]["surface_sample_n"]
        self.free_sample_begin_ratio = args["sampler"]["free_sample_begin_ratio"]
        self.free_sample_end_dist_m = args["sampler"]["free_sample_end_dist_m"]
        self.free_sample_n = args["sampler"]["free_sample_n"]
        self.clearance_dist_m = opt("sampler", "clearance_dist_m", self.clearance_dist_m)
        self.clearance_sample_n = opt("sampler", "clearance_sample_n", self.clearance_sample_n)

        self.tree_level_world = args["octree"]["tree_level_world"]
        self.tree_level_feat = args["octree"]["tree_level_feat"]
        self.leaf_vox_size = args["octree"]["leaf_vox_size"]
        self.feature_dim = args["octree"]["feature_dim"]
        self.feature_std = opt("octree", "feature_std", self.feature_std)
        self.poly_int_on = args["octree"]["poly_int_on"]
        self.octree_from_surface_samples = args["octree"]["octree_from_surface_samples"]

        self.geo_mlp_level = args["decoder"]["mlp_level"]
        self.geo_mlp_hidden_dim = args["decoder"]["mlp_hidden_dim"]
        self.freeze_after_frame = args["decoder"]["freeze_after_frame"]
        self.time_conditioned = opt("decoder", "time_conditioned", self.time_conditioned)

        self.ray_loss = args["loss"]["ray_loss"]
        self.main_loss_type = args["loss"]["main_loss_type"]
        self.sigma_sigmoid_m = args["loss"]["sigma_sigmoid_m"]
        self.loss_weight_on = args["loss"]["loss_weight_on"]
        self.behind_dropoff_on = args["loss"]["behind_dropoff_on"]
        self.normal_loss_on = opt("loss", "normal_loss_on", self.normal_loss_on)
        self.weight_n = float(opt("loss", "weight_n", self.weight_n))
        self.ekional_loss_on = args["loss"]["ekional_loss_on"]
        self.weight_e = float(args["loss"]["weight_e"])

        self.continual_learning_reg = args["continual"]["continual_learning_reg"]
        self.lambda_forget = float(args["continual"]["lambda_forget"])
        self.window_replay_on = args["continual"]["window_replay_on"]
        self.window_radius = args["continual"]["window_radius_m"]

        self.iters = args["optimizer"]["iters"]
        self.bs = args["optimizer"]["batch_size"]
        self.lr = float(args["optimizer"]["learning_rate"])
        self.weight_decay = float(args["optimizer"]["weight_decay"])
        self.adam_eps = float(opt("optimizer", "adam_eps", self.adam_eps))

        self.wandb_vis_on = args["eval"]["wandb_vis_on"]
        self.o3d_vis_on = args["eval"]["o3d_vis_on"]
        self.vis_freq_iters = args["eval"]["vis_freq_iters"]
        self.save_freq_iters = args["eval"]["save_freq_iters"]
        self.mesh_freq_frame = args["eval"]["mesh_freq_frame"]
        self.mc_with_octree = args["eval"]["mc_with_octree"]
        self.mc_res_m = args["eval"]["mc_res_m"]
        self.mc_vis_level = args["eval"]["mc_vis_level"]
        self.mc_local = args["eval"]["mc_local"]
        self.save_map = args["eval"]["save_map"]
        self.mc_mask_on = opt("eval", "mc_mask_on", self.mc_mask_on)

        # data-phase workers (the reference declares this knob but never
        # reads it from YAML or uses it, utils/config.py:31; here it drives
        # process_frames_pipelined so it must be configurable)
        self.num_workers = int(
            opt("setting", "num_workers", self.num_workers))

        # extras of the optional "tpu" section.  This section is
        # entirely ours, so unknown keys are certainly typos — and a typoed
        # perf knob (e.g. feature_updat) would silently bench the default.
        known_tpu = {
            "scan_chunk", "mesh_shape", "feature_update",
            "fuse_update_levels", "moments_bf16", "sort_batch",
            "precompute_lookups", "batch_windows", "windows_fused",
            "windows_split_k", "params_bf16", "windows_hbm_budget_gb",
            "profile_dir",
            "coordinator", "num_processes", "process_id", "table_sharding",
            "shard_ingest", "init_node_capacity", "init_corner_capacity",
            "init_pool_capacity", "max_device_pool", "pool_rotate_iters",
        }
        unknown = set(args.get("tpu", {}) or {}) - known_tpu
        if unknown:
            raise ValueError(
                f"unknown keys in the tpu config section: {sorted(unknown)} "
                f"(known: {sorted(known_tpu)})"
            )
        self.scan_chunk = opt("tpu", "scan_chunk", self.scan_chunk)
        self.mesh_shape = opt("tpu", "mesh_shape", self.mesh_shape)
        self.feature_update = opt("tpu", "feature_update", self.feature_update)
        self.fuse_update_levels = opt(
            "tpu", "fuse_update_levels", self.fuse_update_levels)
        self.moments_bf16 = opt("tpu", "moments_bf16", self.moments_bf16)
        self.sort_batch = opt("tpu", "sort_batch", self.sort_batch)
        self.precompute_lookups = opt(
            "tpu", "precompute_lookups", self.precompute_lookups)
        self.batch_windows = opt("tpu", "batch_windows", self.batch_windows)
        self.windows_fused = opt("tpu", "windows_fused", self.windows_fused)
        self.windows_split_k = opt(
            "tpu", "windows_split_k", self.windows_split_k)
        self.params_bf16 = opt("tpu", "params_bf16", self.params_bf16)
        self.windows_hbm_budget_gb = float(opt(
            "tpu", "windows_hbm_budget_gb", self.windows_hbm_budget_gb))
        self.profile_dir = opt("tpu", "profile_dir", self.profile_dir)
        self.coordinator = opt("tpu", "coordinator", self.coordinator)
        self.num_processes = opt("tpu", "num_processes", self.num_processes)
        self.process_id = opt("tpu", "process_id", self.process_id)
        self.table_sharding = opt("tpu", "table_sharding", self.table_sharding)
        self.shard_ingest = opt("tpu", "shard_ingest", self.shard_ingest)
        self.init_node_capacity = opt("tpu", "init_node_capacity", self.init_node_capacity)
        self.init_corner_capacity = opt("tpu", "init_corner_capacity", self.init_corner_capacity)
        self.init_pool_capacity = opt("tpu", "init_pool_capacity", self.init_pool_capacity)
        self.max_device_pool = opt("tpu", "max_device_pool", self.max_device_pool)
        self.pool_rotate_iters = opt("tpu", "pool_rotate_iters", self.pool_rotate_iters)

        self.derive()
        return self

    def derive(self) -> None:
        """Compute derived quantities (reference utils/config.py:364-374)."""
        self.calculate_world_scale()
        self.infer_bs = self.bs * 16
        self.mc_query_level = self.tree_level_world - self.tree_level_feat + 1
        if self.window_radius <= 0:
            self.window_radius = self.pc_radius * 2.0

    def calculate_world_scale(self) -> None:
        """World-to-[-1,1] scale: reference utils/config.py:372-374."""
        self.world_size = self.leaf_vox_size * (2 ** (self.tree_level_world - 1))
        self.scale = 1.0 / self.world_size


def torch_device(name: str) -> str:
    """A YAML ``setting.device`` -> the torch device the port runs on."""
    name = str(name).lower()
    if name in ("tpu", "cuda", "gpu") or name.startswith("cuda:"):
        return "cuda" if name in ("tpu", "gpu") else name
    if name == "cpu":
        return "cpu"
    raise ValueError(f"unknown setting.device {name!r} (tpu, cuda, gpu or cpu)")
