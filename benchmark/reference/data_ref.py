"""Plain NumPy reference of the data stage: what a scan should give the
training pool.

For a frame it reads the scan file that both sides read, keeps the points
above ``min_z`` and at least ``min_range`` from the sensor, crops them to
the box of half-width ``pc_radius`` (z up to ``max_z``), averages them per
voxel of ``vox_down_m`` (voxels anchored at the frame's lowest corner, in
ascending (x, y, z) voxel order), moves them by the frame's pose into the
world and scales them into the map's [-1, 1] cube (SHINE-Mapping's
dataset/lidar_dataset.py and utils/data_sampler.py).  Every pool sample of
that frame lies on the ray from the sensor through one of those points, at
the signed distance its label gives (behind the surface positive), the
rays in the points' order, each with ``surface_n`` samples of positive
weight and then its free-space samples of negative weight.  The check
rebuilds each sample's surface point from its coordinate and label and
measures how far it lies from the point this reference expects.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "generators"))
from plyio import read_kitti_poses, read_ply_xyz  # noqa: E402


def frame_points(path: str, pose: np.ndarray, c: dict) -> np.ndarray:
    p = read_ply_xyz(path)
    p = p[p[:, 2] > c["min_z"]]
    p = p[np.linalg.norm(p, axis=1) >= c["min_range"]]
    lo = np.array([-c["pc_radius"], -c["pc_radius"], c["min_z"]])
    hi = np.array([c["pc_radius"], c["pc_radius"], c["max_z"]])
    p = p[np.all((p >= lo) & (p <= hi), axis=1)]
    keys = np.floor((p - p.min(axis=0)) / c["vox_down_m"]).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    mean = np.stack([np.bincount(inv, weights=p[:, k]) for k in range(3)], axis=1)
    mean /= counts[:, None]
    return (mean @ pose[:3, :3].T + pose[:3, 3]) * c["scale"]


def check_frames(pool, frame_files: list, pose_path: str, frames, c: dict) -> dict:
    """Worst gap (metres) between a rebuilt surface point and the expected
    one, and counts of samples and of weight signs that differ, over
    ``frames``.  ``pool``: coord, sdf_label, weight, time (host arrays)."""
    poses = read_kitti_poses(pose_path)
    a_n = c["surface_n"] + c["clearance_n"] + c["free_n"]
    gap, count_gap, sign_gap = 0.0, 0, 0
    for f in frames:
        expect = frame_points(frame_files[f], poses[f], c)
        sel = np.nonzero(pool["time"] == f)[0]
        count_gap += abs(len(sel) - len(expect) * a_n)
        if len(sel) != len(expect) * a_n:
            continue
        o = poses[f][:3, 3] * c["scale"]
        x = pool["coord"][sel].astype(np.float64) - o
        dx = np.linalg.norm(x, axis=1)
        q = o + x * ((dx - pool["sdf_label"][sel]) / dx)[:, None]
        gap = max(gap, float(np.abs(q - np.repeat(expect, a_n, axis=0)).max()) / c["scale"])
        w = pool["weight"][sel].reshape(-1, a_n)
        sign_gap += int((w[:, :c["surface_n"]] <= 0).sum() + (w[:, c["surface_n"]:] >= 0).sum())
    return {"data_gap_m": gap, "data_count_gap": count_gap, "data_sign_gap": sign_gap}
