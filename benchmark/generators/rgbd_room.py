"""A room seen by an RGB-D camera, written as NeuralRGBD's sequences are
after the repository's RGB-D converter: one binary PLY a frame (camera
frame, OpenGL axes, coloured by surface), KITTI poses of the
camera-to-world transforms.

The room is a closed box with a table, a cabinet and a ball; the camera
turns once around the room's middle on an ellipse, 20 degrees down.  Each
pixel's depth is the exact hit plus Gaussian noise drawn from the run's
seed, rounded to millimetres as a 16-bit depth image holds it, and
back-projected with the focal length and the image centre.  A seeded copy
of the synthetic room of the repository's RGB-D converter tests.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from plyio import write_kitti_poses, write_ply

PALETTE = np.array([[200, 180, 150], [240, 240, 240], [180, 60, 60], [60, 160, 80],
                    [70, 90, 190], [210, 190, 60], [120, 80, 40], [90, 90, 90],
                    [230, 110, 30]], np.uint8)
FLIP_YZ = np.diag([1.0, -1.0, -1.0])  # OpenCV camera axes <-> OpenGL


def room_pose(k: int, n: int) -> np.ndarray:
    """Camera k of n: 4x4 camera-to-world, OpenGL axes (looking down -z)."""
    th = 2 * np.pi * k / n
    c = np.array([0.45 * np.cos(th), 0.35 * np.sin(th), 1.35 + 0.1 * np.sin(2 * th)])
    yaw, pitch = th + 0.3, -0.35
    f = np.array([np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw), np.sin(pitch)])
    right = np.cross(f, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    T = np.eye(4)
    T[:3, :3] = np.stack([right, np.cross(right, f), -f], axis=1)
    T[:3, 3] = c
    return T


def _slabs(o, d, lo, hi):
    inv = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def room_hits(p: dict, o, d):
    """Depth (the ray parameter) and surface id of the first hit of each
    ray ``o + t d`` inside the closed room."""
    f64 = dict(dtype=torch.float64, device=d.device)
    _, far = _slabs(o, d, torch.tensor(p["room_min"], **f64), torch.tensor(p["room_max"], **f64))
    t, axis = far.min(dim=1)
    side = (d.gather(1, axis[:, None])[:, 0] > 0).long()
    sid = torch.where(axis == 2, side, 2 + 2 * axis + side)  # floor, ceiling, walls
    for j, (lo, hi) in enumerate(p["boxes"]):
        near, far = _slabs(o, d, torch.tensor(lo, **f64), torch.tensor(hi, **f64))
        tn, tf = near.amax(dim=1), far.amin(dim=1)
        hit = (tn <= tf) & (tn > 1e-6) & (tn < t)
        t, sid = torch.where(hit, tn, t), torch.where(hit, 6 + j, sid)
    oc = o - torch.tensor(p["ball_center"], **f64)
    b, a = d @ oc, (d * d).sum(1)
    disc = b * b - a * (oc @ oc - p["ball_radius"] ** 2)
    tb = (-b - disc.clamp(min=0).sqrt()) / a
    hit = (disc > 0) & (tb > 1e-6) & (tb < t)
    return torch.where(hit, tb, t), torch.where(hit, 8, sid)


def generate(root: str, p: dict, seed: int, device) -> dict:
    """Write the sequence under ``root``; returns the config's data paths."""
    pc_dir = os.path.join(root, "rgbd_ply")
    os.makedirs(pc_dir, exist_ok=True)
    f64 = dict(dtype=torch.float64, device=device)
    W, H, focal, n = p["width"], p["height"], p["focal"], p["frames"]
    v, u = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64), indexing="ij")
    x_n, y_n = (u.reshape(-1) - (W - 1) / 2) / focal, (v.reshape(-1) - (H - 1) / 2) / focal
    d_cv = torch.stack([x_n, y_n, torch.ones_like(x_n)], dim=1)
    gen = torch.Generator(device).manual_seed(seed)
    poses = [room_pose(k, n) for k in range(n)]
    for k, T in enumerate(poses):
        R = torch.tensor(T[:3, :3] @ FLIP_YZ, **f64)
        t, sid = room_hits(p, torch.tensor(T[:3, 3], **f64), d_cv @ R.T)
        noisy = t + torch.randn(t.shape, generator=gen, **f64) * p["depth_noise_m"]
        z = torch.round(noisy * 1000.0) / 1000.0  # a 16-bit millimetre depth image
        pts_gl = torch.stack([x_n * z, -(y_n * z), -z], dim=1)
        write_ply(os.path.join(pc_dir, f"{k:06d}.ply"), pts_gl.cpu().numpy(),
                  PALETTE[sid.cpu().numpy()])
    write_kitti_poses(os.path.join(root, "poses.txt"), poses)
    return {"pc_path": pc_dir, "pose_path": os.path.join(root, "poses.txt"), "calib_path": ""}
