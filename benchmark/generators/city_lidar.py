"""A city street scanned by a rotating LiDAR, written as MaiCity's sequences
ship: one binary PLY a scan in the sensor frame, KITTI poses and an identity
calibration.

The scene (a street grid of building blocks, parked cars and poles; boxes on
a ground plane) is fixed by the traffic file's ``scene_seed``, so every run
maps the same city.  The range noise comes from the traffic file's
``data_seed`` where it gives one (every run then maps the same scans and
grows the same tables), else from the run's seed.  The scanner is
``beams`` x ``columns`` rays between two elevations, driven along the main
street with a turn at a crossing.  The rays are cast on ``device`` in
float64, ``chunk_rays`` at a time.

A seeded copy of the repository's synthetic city test world (its geometry
and trajectory), without its labels and moving actors.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from plyio import write_identity_calib, write_kitti_poses, write_ply


def build_city(p: dict):
    """Static boxes (min (B, 3), max (B, 3)) of the street grid."""
    rng = np.random.default_rng(p["scene_seed"])
    pitch, street = p["block_pitch_m"], p["street_w_m"]
    half = (pitch - street) / 2.0
    bmin, bmax = [], []
    for bx in range(p["blocks_x"]):
        for by in range(-(p["blocks_y"] // 2) - 1, p["blocks_y"] // 2 + 1):
            cx, cy = (bx + 0.5) * pitch, (by + 0.5) * pitch
            for _ in range(rng.integers(1, 4)):  # buildings
                w = rng.uniform(8.0, half * 2 - 2.0)
                d = rng.uniform(8.0, half * 2 - 2.0)
                h = rng.uniform(5.0, 22.0)
                ox = rng.uniform(-(half - w / 2), half - w / 2)
                oy = rng.uniform(-(half - d / 2), half - d / 2)
                bmin.append([cx + ox - w / 2, cy + oy - d / 2, 0.0])
                bmax.append([cx + ox + w / 2, cy + oy + d / 2, h])
            for _ in range(rng.integers(1, 4)):  # parked cars at the curb
                px = cx + rng.uniform(-half + 3, half - 3)
                py = cy - half + 1.2
                bmin.append([px - 2.1, py - 0.9, 0.0])
                bmax.append([px + 2.1, py + 0.9, 1.55])
            px, py = cx - half + 0.5, cy - half + 0.5  # a pole at the corner
            bmin.append([px - 0.15, py - 0.15, 0.0])
            bmax.append([px + 0.15, py + 0.15, 5.0])
    return np.asarray(bmin, np.float64), np.asarray(bmax, np.float64)


def trajectory(p: dict) -> list:
    """East along the main street, then north at the crossing nearest to
    ``turn_after`` of the frames."""
    poses, x, y, north = [], 2.0, 0.0, False
    n, step, pitch = p["frames"], p["step_m"], p["block_pitch_m"]
    n_turn = int(n * p["turn_after"])
    turn_x = round((2.0 + n_turn * step) / pitch) * pitch
    for i in range(n):
        T = np.eye(4)
        if not north and x >= turn_x and i >= n_turn:
            north = True
        if north:
            y += step
            T[:3, :3] = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        else:
            x += step
        T[:3, 3] = [x, y, p["sensor_height_m"]]
        poses.append(T)
    return poses


def _first_hit(o, dirs, bmin, bmax, chunk):
    """Nearest ground or box hit of rays from ``o`` (3,) along ``dirs``
    (N, 3); inf where none."""
    dz = dirs[:, 2]
    t_best = torch.where(dz < 0, -o[2] / torch.where(dz < 0, dz, -1.0), torch.inf)
    inv = 1.0 / torch.where(dirs.abs() < 1e-12, 1e-12, dirs)
    for a in range(0, dirs.shape[0], chunk):
        iv = inv[a:a + chunk, None, :]
        t1, t2 = (bmin[None] - o) * iv, (bmax[None] - o) * iv
        tn = torch.minimum(t1, t2).amax(dim=2)
        tf = torch.maximum(t1, t2).amin(dim=2)
        tn = torch.where((tn <= tf) & (tn > 0.1), tn, torch.inf).amin(dim=1)
        t_best[a:a + chunk] = torch.minimum(t_best[a:a + chunk], tn)
    return t_best


def generate(root: str, p: dict, seed: int, device) -> dict:
    """Write the sequence under ``root``; returns the config's data paths."""
    pc_dir = os.path.join(root, "velodyne")
    os.makedirs(pc_dir, exist_ok=True)
    f64 = dict(dtype=torch.float64, device=device)
    bmin, bmax = (torch.tensor(b, **f64) for b in build_city(p))
    az = torch.linspace(-np.pi, np.pi, p["columns"] + 1, **f64)[:-1]
    el = torch.deg2rad(torch.linspace(p["elev_min_deg"], p["elev_max_deg"], p["beams"], **f64))
    aa, ee = torch.meshgrid(az, el, indexing="ij")
    dirs_s = torch.stack([ee.cos() * aa.cos(), ee.cos() * aa.sin(), ee.sin()], -1).reshape(-1, 3)
    gen = torch.Generator(device).manual_seed(p.get("data_seed", seed))
    poses = trajectory(p)
    for i, T in enumerate(poses):
        R, o = torch.tensor(T[:3, :3], **f64), torch.tensor(T[:3, 3], **f64)
        dirs = dirs_s @ R.T
        t = _first_hit(o, dirs, bmin, bmax, p["chunk_rays"])
        keep = t < p["max_range_m"]
        noise = torch.randn(dirs.shape, generator=gen, **f64) * p["noise_m"]
        pts_w = o + dirs[keep] * t[keep, None] + noise[keep]
        write_ply(os.path.join(pc_dir, f"{i:06d}.ply"), ((pts_w - o) @ R).cpu().numpy())
    write_kitti_poses(os.path.join(root, "poses.txt"), poses)
    write_identity_calib(os.path.join(root, "calib.txt"))
    return {"pc_path": pc_dir, "pose_path": os.path.join(root, "poses.txt"),
            "calib_path": os.path.join(root, "calib.txt")}
