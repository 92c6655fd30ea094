"""LiDAR frame dataset: I/O, preprocessing, sampling, training pools.

Parity target: reference ``LiDARDataset`` (dataset/lidar_dataset.py:22-450):
pose/calib loading with first-frame re-referencing, per-frame preprocessing
(crop / normals / downsample / SOR), world->[-1,1] scaling, ray sampling,
feature-grid growth hook, and the training-data pool with the sliding-window
replay filter.

While tracing is on (``utils.profiling``), each frame's ``load_and_sample``
is the span ``data.prep`` (on whichever thread runs it), the pipelined data
phase's wait for a frame ``data.wait``, the octree's growth ``data.octree``
and the pool's append ``data.pool``.

Device-first differences: the pools live host-side in numpy (cheap concat /
filter) and are uploaded to the device once per training phase; random
batch gathering then happens on the device inside the train loop (see
train/trainer.py) instead of per-iteration host indexing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields as dataclass_fields
from typing import List, Optional

import numpy as np
from numpy.linalg import inv

from ..config import SHINEConfig
from ..utils.profiling import span
from . import io, pose as pose_io, preprocess, semantic_kitti
from .sampler import SamplerParams, sample_rays


def natural_sort_key(name: str):
    """natsort replacement: split digit runs so scan10 > scan9.

    Tokens are homogeneous (kind, value) tuples — mixed int/str lists
    raise TypeError when names diverge at a digit/non-digit boundary
    ('scan.bin' vs 'scan1.bin' would compare 1 < '.bin')."""
    import re

    return [
        (0, int(t)) if t.isdigit() else (1, t)
        for t in re.split(r"(\d+)", name)
    ]


@dataclass
class SamplePool:
    """Host-side accumulating training pool (numpy)."""

    coord: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    sdf_label: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    normal_label: Optional[np.ndarray] = None
    sem_label: Optional[np.ndarray] = None
    weight: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    sample_depth: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    ray_depth: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    origin: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    time: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))

    def __len__(self) -> int:
        return self.coord.shape[0]


class _GrowBuf:
    """Amortized append buffer (doubling capacity, zero-copy views).

    The batch data phase appends every frame's samples to the pool; a
    per-frame ``np.concatenate`` of the WHOLE pool is O(total^2) copying
    (~125 GB of memcpy for the 150-frame / 34.8M-sample city demo, the
    dominant superlinear term of its data phase).  Appending into a
    doubling buffer is amortized O(total); the exposed ``buf[:n]`` views
    are read-only by convention (every consumer copies or re-indexes)."""

    def __init__(self, arr: np.ndarray):
        self.n = arr.shape[0]
        cap = 1024
        while cap < self.n:
            cap *= 2
        self.buf = np.empty((cap,) + arr.shape[1:], arr.dtype)
        self.buf[: self.n] = arr

    def append(self, arr: np.ndarray) -> np.ndarray:
        need = self.n + arr.shape[0]
        if need > self.buf.shape[0]:
            cap = self.buf.shape[0]
            while cap < need:
                cap *= 2
            nb = np.empty((cap,) + self.buf.shape[1:], self.buf.dtype)
            nb[: self.n] = self.buf[: self.n]
            self.buf = nb
        self.buf[self.n: need] = arr
        self.n = need
        return self.view()

    def view(self) -> np.ndarray:
        return self.buf[: self.n]


class LiDARDataset:
    def __init__(self, config: SHINEConfig, grid=None):
        self.config = config
        self.grid = grid  # HashGridHost or None

        # calibration + poses (dataset/lidar_dataset.py:32-44)
        self.calib = {"Tr": np.eye(4)}
        if config.calib_path:
            self.calib = pose_io.read_calib_file(config.calib_path)
        if config.pose_path.endswith("txt"):
            self.poses_w = pose_io.read_poses_file(config.pose_path, self.calib)
        elif config.pose_path.endswith("csv"):
            self.poses_w = pose_io.csv_odom_to_transforms(config.pose_path)
        else:
            raise ValueError(
                "Wrong pose file format. Use *.txt (KITTI) or *.csv (xyz+quat)."
            )

        self.pc_filenames = sorted(os.listdir(config.pc_path), key=natural_sort_key)
        self.total_pc_count = len(self.pc_filenames)

        self.sampler_params = SamplerParams.from_config(config)
        self.rng = np.random.default_rng(config.seed)
        # samples per ray in the ray-major pool layout (surface + clearance
        # + free; trainer.py TrainSettings.ray_sample_count must agree)
        self.ray_sample_count = (
            config.surface_sample_n + config.clearance_sample_n + config.free_sample_n
        )

        # first-frame re-referencing (dataset/lidar_dataset.py:68-91)
        self.poses_ref = [np.array(p) for p in self.poses_w]
        self.begin_pose_inv = np.eye(4)
        self.used_pc_count = 0
        begin_flag = False
        for frame_id in range(self.total_pc_count):
            if (
                frame_id < config.begin_frame
                or frame_id > config.end_frame
                or frame_id % config.every_frame != 0
            ):
                continue
            if not begin_flag:
                begin_flag = True
                if config.first_frame_ref:
                    self.begin_pose_inv = inv(self.poses_w[frame_id])
                else:
                    self.begin_pose_inv[2, 3] += config.global_shift_default
            self.poses_ref[frame_id] = self.begin_pose_inv @ self.poses_w[frame_id]
            self.used_pc_count += 1

        self.pool = SamplePool()
        # amortized accumulate buffers (invalidated whenever self.pool is
        # replaced wholesale — incremental / window-replay paths)
        self._pool_bufs = None
        # merged downsampled map + bounding boxes (dataset/lidar_dataset.py:63-66).
        # The map accumulates as a per-frame LIST, concatenated lazily on
        # first read (a per-frame whole-map concat is O(total^2) copying;
        # nothing reads the merged map mid-run — only write_merged_pc);
        # map_bbx is a running min/max, identical to the whole-map scan
        self._map_pcs = [io.PointCloud(points=np.zeros((0, 3)))]
        self._map_pc_cache: Optional[io.PointCloud] = None
        self._map_len = 0
        self.map_bbx = (np.zeros(3), np.zeros(3))
        self.cur_bbx = (np.zeros(3), np.zeros(3))
        self.cur_frame_pc: Optional[io.PointCloud] = None
        self.cur_pose_ref = np.eye(4)

    @property
    def map_down_pc(self) -> io.PointCloud:
        if self._map_pc_cache is None:
            pcs = self._map_pcs
            if len(pcs) == 1:
                self._map_pc_cache = pcs[0]
            else:
                # same field semantics as pairwise PointCloud.concat:
                # an optional column survives only if EVERY piece has it
                def cat(arrs):
                    return (None if any(a is None for a in arrs)
                            else np.concatenate(arrs, axis=0))

                self._map_pc_cache = io.PointCloud(
                    points=np.concatenate([p.points for p in pcs], axis=0),
                    normals=cat([p.normals for p in pcs]),
                    colors=cat([p.colors for p in pcs]),
                    intensity=cat([p.intensity for p in pcs]),
                )
                self._map_pcs = [self._map_pc_cache]
        return self._map_pc_cache

    @map_down_pc.setter
    def map_down_pc(self, pc: io.PointCloud) -> None:
        self._map_pcs = [pc]
        self._map_pc_cache = pc
        self._map_len = len(pc)

    # ------------------------------------------------------------------ frames
    def frame_ids(self) -> List[int]:
        cfg = self.config
        return [
            f
            for f in range(self.total_pc_count)
            if cfg.begin_frame <= f <= cfg.end_frame and f % cfg.every_frame == 0
        ]

    def read_frame(self, frame_id: int):
        """Load + label a frame (dataset/lidar_dataset.py:129-136)."""
        cfg = self.config
        path = os.path.join(cfg.pc_path, self.pc_filenames[frame_id])
        sem_labels = None
        if cfg.semantic_on:
            label_path = os.path.join(
                cfg.label_path, self.pc_filenames[frame_id].replace("bin", "label")
            )
            raw = io.read_kitti_label(label_path)
            pc = io.read_kitti_bin(path)
            pts, sem_labels = semantic_kitti.preprocess_sem_kitti(
                pc.points, raw, cfg.min_range,
                filter_outlier=True, filter_moving=cfg.filter_moving_object,
            )
            pc = io.PointCloud(points=pts)
        else:
            pc = io.read_point_cloud(path)
            pc = preprocess.filter_min_range(pc, cfg.min_range, cfg.min_z)
        return pc, sem_labels

    def load_and_sample(self, frame_id: int, rng: Optional[np.random.Generator] = None):
        """Order-independent half of frame processing: I/O, preprocessing,
        scaling and ray sampling (no shared-state mutation).

        Used by the pipelined data phase; ``rng`` defaults to a
        deterministic per-frame generator so parallel workers don't race on
        the shared stream.
        """
        with span("data.prep"):
            cfg = self.config
            if rng is None:
                rng = np.random.default_rng((cfg.seed, frame_id))
            pose_ref = self.poses_ref[frame_id]
            pc, sem_labels = self.read_frame(frame_id)

            bbx_min = np.array([-cfg.pc_radius, -cfg.pc_radius, cfg.min_z])
            bbx_max = np.array([cfg.pc_radius, cfg.pc_radius, cfg.max_z])
            if sem_labels is not None:
                p = pc.points
                mask = np.all((p >= bbx_min) & (p <= bbx_max), axis=1)
                pc = pc.select(mask)
                sem_labels = sem_labels[mask]
            else:
                pc = preprocess.crop_bbx(pc, bbx_min, bbx_max)

            if cfg.estimate_normal:
                pc = preprocess.estimate_normals(
                    pc, cfg.normal_radius_m, cfg.normal_max_nn,
                    orient_towards=np.zeros(3),
                )
            if cfg.rand_downsample:
                n_before = len(pc)
                k = int(round(n_before * cfg.rand_down_r))
                idx = np.sort(rng.choice(n_before, size=min(k, n_before), replace=False))
                pc = pc.select(idx)
                if sem_labels is not None:
                    sem_labels = sem_labels[idx]
            else:
                if sem_labels is not None and len(pc) > 0:
                    vmin = pc.points.min(axis=0)
                    keys = np.floor((pc.points - vmin) / cfg.vox_down_m).astype(np.int64)
                    packed = (keys[:, 0] << 42) | (keys[:, 1] << 21) | keys[:, 2]
                    _, first = np.unique(packed, return_index=True)
                    pc = pc.select(np.sort(first))
                    sem_labels = sem_labels[np.sort(first)]
                else:
                    pc = preprocess.voxel_downsample(pc, cfg.vox_down_m)
            if cfg.filter_noise:
                pc = preprocess.statistical_outlier_removal(pc, cfg.sor_nn, cfg.sor_std)

            frame_origin = pose_ref[:3, 3] * cfg.scale
            pc_ref = pc.transform(pose_ref)
            frame_down = preprocess.voxel_downsample(pc_ref, cfg.map_vox_down_m)
            points_s = (pc_ref.points * cfg.scale).astype(np.float64)
            normals = pc_ref.normals if cfg.estimate_normal else None
            sampled = sample_rays(
                points_s, frame_origin, self.sampler_params, rng,
                normals=normals, sem_labels=sem_labels,
            )
            return {
                "frame_id": frame_id,
                "origin": frame_origin,
                "points_s": points_s,
                "frame_down": frame_down,
                "sampled": sampled,
            }

    def process_frames_pipelined(self, frame_ids, workers: int = 4,
                                 incremental_on: bool = False) -> int:
        """Data phase with overlapped I/O+preprocess+sampling.

        Worker threads run :meth:`load_and_sample` ahead of time; the main
        thread consumes results IN FRAME ORDER and applies the sequential
        parts (grid growth, pool accumulation).  Realizes the reference's
        unused ``num_workers`` intent (utils/config.py:31).
        """
        import concurrent.futures as cf

        total = 0
        frame_ids = list(frame_ids)
        # bounded lookahead: submitting everything up front lets workers
        # race thousands of frames ahead of the sequential consumer, pinning
        # every completed frame's sampled arrays (tens of MB each) in RAM
        window = 2 * max(1, workers)
        with cf.ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
            futures = {}
            next_i = 0
            for i, f in enumerate(frame_ids):
                while next_i < len(frame_ids) and next_i < i + window:
                    nf = frame_ids[next_i]
                    futures[nf] = ex.submit(self.load_and_sample, nf)
                    next_i += 1
                with span("data.wait"):
                    prep = futures.pop(f).result()
                total += self._integrate_frame(prep, incremental_on)
                del prep  # the frame's samples, freed before the next wait
        return total

    def finalize_pool(self) -> None:
        """Trim the accumulate buffers to exact size (one O(n) copy).

        The doubling buffers can pin up to 2x the final pool in host RAM
        (several GB at city scale); the batch driver calls this once the
        data phase ends.  Appending later transparently rebuilds buffers
        from the trimmed pool."""
        if self._pool_bufs is None:
            return
        p = self.pool
        # force a REAL copy: the pool fields are buf[:n] views whose .base
        # keeps the full doubling buffer alive (np.ascontiguousarray on an
        # already-contiguous view returns the same view and frees nothing)
        self.pool = SamplePool(**{
            f.name: (None if getattr(p, f.name) is None
                     else getattr(p, f.name).copy())
            for f in dataclass_fields(SamplePool)
        })
        self._pool_bufs = None

    def _integrate_frame(self, prep: dict, incremental_on: bool) -> int:
        """Sequential half: grid growth + pool bookkeeping for one frame."""
        cfg = self.config
        frame_id = prep["frame_id"]
        self.cur_pose_ref = self.poses_ref[frame_id]
        frame_origin = prep["origin"]
        self._map_pcs.append(prep["frame_down"])
        self._map_pc_cache = None
        had_map = self._map_len > 0
        self._map_len += len(prep["frame_down"])
        self.cur_frame_pc = prep["frame_down"]
        if len(prep["frame_down"]) > 0:
            self.cur_bbx = (
                prep["frame_down"].points.min(axis=0),
                prep["frame_down"].points.max(axis=0),
            )
            # running min/max == the reference's whole-map scan
            self.map_bbx = (
                np.minimum(self.map_bbx[0], self.cur_bbx[0]) if had_map
                else self.cur_bbx[0],
                np.maximum(self.map_bbx[1], self.cur_bbx[1]) if had_map
                else self.cur_bbx[1],
            )
        coord, sdf_label, normal_label, sem_label, weight, sample_depth, ray_depth = prep["sampled"]
        if self.grid is not None:
            with span("data.octree"):
                if cfg.octree_from_surface_samples:
                    self.grid.update(coord[weight > 0, :], incremental_on)
                else:
                    self.grid.update(prep["points_s"], incremental_on)
        with span("data.pool"):
            self._append_pool(
                frame_id, frame_origin, coord, sdf_label, normal_label,
                sem_label, weight, sample_depth, ray_depth, incremental_on,
            )
        return coord.shape[0]

    def process_frame(self, frame_id: int, incremental_on: bool = False) -> int:
        """Preprocess one frame, sample rays, grow the grid, update the pool.

        Mirrors dataset/lidar_dataset.py:115-281.  Returns the number of new
        samples.  ONE implementation with the pipelined path: this is
        load_and_sample (on the dataset's shared rng stream, preserving
        sequential-mode determinism) followed by _integrate_frame.
        """
        return self._integrate_frame(
            self.load_and_sample(frame_id, rng=self.rng), incremental_on
        )

    def _append_pool(
        self, frame_id, frame_origin, coord, sdf_label, normal_label,
        sem_label, weight, sample_depth, ray_depth, incremental_on,
    ) -> int:
        cfg = self.config
        origin_rep = np.tile(frame_origin[None, :], (coord.shape[0], 1)).astype(np.float32)
        time_rep = np.full(coord.shape[0], frame_id, np.float32)

        if incremental_on:
            # continual-learning mode keeps only the current frame
            # (dataset/lidar_dataset.py:223-233)
            self._pool_bufs = None
            self.pool = SamplePool(
                coord=coord.astype(np.float32),
                sdf_label=sdf_label.astype(np.float32),
                normal_label=None if normal_label is None else normal_label.astype(np.float32),
                sem_label=None if sem_label is None else sem_label.astype(np.int32),
                weight=weight.astype(np.float32),
                sample_depth=sample_depth.astype(np.float32),
                ray_depth=ray_depth.astype(np.float32),
                origin=origin_rep,
                time=time_rep,
            )
            return coord.shape[0]

        # sliding-window replay filter (dataset/lidar_dataset.py:236-258).
        # In ray mode the pool is ray-major and the depth arrays must stay
        # aligned, so whole rays are kept/dropped together (a ray survives if
        # its first — on-surface — sample lies inside the window).  The
        # reference filters per point and leaves its depth arrays desynced
        # (its own "FIX ME", dataset/lidar_dataset.py:247-250); this fixes
        # that rather than reproducing it.
        if cfg.window_replay_on and len(self.pool) > 0:
            rel = np.linalg.norm(self.pool.coord - frame_origin[None, :].astype(np.float32), axis=-1)
            keep = rel < cfg.window_radius * cfg.scale
            p = self.pool
            if cfg.ray_loss:
                rsc = self.ray_sample_count
                keep_ray = keep.reshape(-1, rsc)[:, 0]
                keep = np.repeat(keep_ray, rsc)
                new_sample_depth = p.sample_depth[keep]
                new_ray_depth = p.ray_depth[keep_ray]
            else:
                new_sample_depth = p.sample_depth[keep]
                new_ray_depth = p.ray_depth  # unused in point mode
            self._pool_bufs = None
            self.pool = SamplePool(
                coord=p.coord[keep],
                sdf_label=p.sdf_label[keep],
                normal_label=None if p.normal_label is None else p.normal_label[keep],
                sem_label=None if p.sem_label is None else p.sem_label[keep],
                weight=p.weight[keep],
                sample_depth=new_sample_depth,
                ray_depth=new_ray_depth,
                origin=p.origin[keep],
                time=p.time[keep],
            )

        # accumulate (dataset/lidar_dataset.py:262-281) — amortized append
        # buffers instead of a whole-pool np.concatenate per frame (O(n^2)
        # copying; see _GrowBuf)
        p = self.pool
        if self._pool_bufs is None:
            self._pool_bufs = {
                "coord": _GrowBuf(p.coord),
                "sdf_label": _GrowBuf(p.sdf_label),
                "normal_label": (None if p.normal_label is None
                                 else _GrowBuf(p.normal_label)),
                "sem_label": (None if p.sem_label is None
                              else _GrowBuf(p.sem_label)),
                "weight": _GrowBuf(p.weight),
                "sample_depth": _GrowBuf(p.sample_depth),
                "ray_depth": _GrowBuf(p.ray_depth),
                "origin": _GrowBuf(p.origin),
                "time": _GrowBuf(p.time),
            }
        b = self._pool_bufs

        def opt_append(name, arr, dtype):
            # None-propagation mirrors the reference: a frame without the
            # field resets it to None; the first frame WITH it (re)starts
            # the column
            if arr is None:
                b[name] = None
                return None
            arr = arr.astype(dtype)
            if b[name] is None:
                b[name] = _GrowBuf(arr)
                return b[name].view()
            return b[name].append(arr)

        self.pool = SamplePool(
            coord=b["coord"].append(coord.astype(np.float32)),
            sdf_label=b["sdf_label"].append(sdf_label.astype(np.float32)),
            normal_label=opt_append("normal_label", normal_label, np.float32),
            sem_label=opt_append("sem_label", sem_label, np.int32),
            weight=b["weight"].append(weight.astype(np.float32)),
            sample_depth=b["sample_depth"].append(
                sample_depth.astype(np.float32)),
            ray_depth=b["ray_depth"].append(ray_depth.astype(np.float32)),
            origin=b["origin"].append(origin_rep),
            time=b["time"].append(time_rep),
        )
        return coord.shape[0]

    # ------------------------------------------------------------------ export
    def write_merged_pc(self, out_path: str) -> None:
        """Merged downsampled map back in world coords
        (dataset/lidar_dataset.py:364-368)."""
        out = self.map_down_pc.transform(inv(self.begin_pose_inv))
        io.write_ply(out_path, out)

    def __len__(self) -> int:
        """Pool size: ray count in ray mode, else point-sample count
        (dataset/lidar_dataset.py:370-374)."""
        if self.config.ray_loss:
            return self.pool.ray_depth.shape[0]
        return len(self.pool)

    def get_batch_np(self, bs: int):
        """Host-side random batch (debug / small runs); the hot path samples
        on the device inside the train loop (train/trainer.py)."""
        n = len(self.pool)
        idx = self.rng.integers(0, n, bs)
        p = self.pool
        return (
            p.coord[idx],
            p.sdf_label[idx],
            p.origin[idx],
            p.time[idx],
            None if p.normal_label is None else p.normal_label[idx],
            None if p.sem_label is None else p.sem_label[idx],
            p.weight[idx],
        )
