"""RGB-D dataset -> KITTI-layout converter.

Port of ``shine_mapping_tpu/data/rgbd_converter.py`` (numpy and PIL; it
writes the same bytes through this package's ``data/io.py``).  Parity
target: reference dataset/rgbd_to_kitti_format.py:10-170 — turn
depth(+RGB) image sequences with camera intrinsics into per-frame colored
.ply scans plus a KITTI-format poses.txt, so the LiDAR pipeline consumes
RGB-D datasets (NeuralRGBD focal-file intrinsics, Replica json intrinsics,
default PrimeSense) unchanged.  Images are read with PIL instead of Open3D.

Usage:
    python -m shine_mapping_tpu_torch.data.rgbd_converter \
        --depth_img_folder D --rgb_img_folder C --pose_file P \
        --output_root OUT [--intrinsic_file F [--is_focal_file {true,false}]]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
from dataclasses import dataclass

import numpy as np

from . import io


def alphanum_key(s: str):
    return [int(x) if x.isdigit() else x for x in re.split(r"([0-9]+)", s)]


@dataclass
class Intrinsics:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    depth_scale: float = 1000.0


PRIMESENSE = Intrinsics(640, 480, 525.0, 525.0, 319.5, 239.5, 1000.0)

# RealSense/NeuralRGBD frames are captured upside down (reference
# dataset/rgbd_to_kitti_format.py:41-55)
FLIP_YZ = np.diag([1.0, -1.0, -1.0])


def load_focal_length(path: str) -> float:
    with open(path) as f:
        return float(f.readline())


def load_poses(path: str, with_head: bool = False):
    """4x4-matrix-per-block pose file (NeuralRGBD format)."""
    with open(path) as f:
        lines = [l for l in f.readlines()]
    per = 5 if with_head else 4
    skip = 1 if with_head else 0
    poses = []
    for i in range(0, len(lines), per):
        block = lines[i + skip: i + per]
        if len(block) < 4 or not block[0].strip():
            break
        poses.append(
            np.array([[float(x) for x in line.split()] for line in block])
        )
    return poses


def write_poses_kitti_format(poses, path: str) -> None:
    rows = [p.flatten()[:12] for p in poses]
    np.savetxt(path, rows, delimiter=" ")


def depth_to_points(
    depth_m: np.ndarray,
    intr: Intrinsics,
    rgb: np.ndarray | None,
    max_depth_m: float,
    flip: bool,
):
    """Back-project a depth image to a (colored) camera-frame point cloud."""
    H, W = depth_m.shape
    u, v = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    valid = (depth_m > 0) & (depth_m <= max_depth_m)
    z = depth_m[valid]
    x = (u[valid] - intr.cx) * z / intr.fx
    y = (v[valid] - intr.cy) * z / intr.fy
    pts = np.stack([x, y, z], axis=1)
    if flip:
        pts = pts @ FLIP_YZ.T
    colors = None
    if rgb is not None:
        colors = rgb[valid].astype(np.float64) / 255.0
    return io.PointCloud(points=pts, colors=colors)


def rgbd_to_kitti_format(args) -> None:
    from PIL import Image

    ply_path = os.path.join(args.output_root, "rgbd_ply")
    os.makedirs(ply_path, exist_ok=True)

    pose_out = os.path.join(args.output_root, "poses.txt")
    if args.already_kitti_format_pose:
        shutil.copyfile(args.pose_file, pose_out)
    else:
        write_poses_kitti_format(load_poses(args.pose_file), pose_out)

    depth_files = sorted(os.listdir(args.depth_img_folder), key=alphanum_key)
    rgb_files = sorted(os.listdir(args.rgb_img_folder), key=alphanum_key) if args.rgb_img_folder else []

    first_depth = np.asarray(
        Image.open(os.path.join(args.depth_img_folder, depth_files[0]))
    )
    H, W = first_depth.shape[:2]
    print(f"Image size: {H} x {W}")

    flip = True
    if args.intrinsic_file == "":
        intr = PRIMESENSE
        print("Default intrinsic for PrimeSense used")
    elif args.is_focal_file:  # NeuralRGBD: txt with focal length only
        focal = load_focal_length(args.intrinsic_file)
        print("Focal length:", focal)
        intr = Intrinsics(W, H, focal, focal, (W - 1.0) / 2.0, (H - 1.0) / 2.0, 1000.0)
    else:  # Replica: json with full intrinsics
        with open(args.intrinsic_file) as f:
            cam = json.load(f)["camera"]
        intr = Intrinsics(
            cam["w"], cam["h"], cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["scale"]
        )
        flip = False

    for i, depth_name in enumerate(depth_files):
        depth = np.asarray(
            Image.open(os.path.join(args.depth_img_folder, depth_name))
        ).astype(np.float64)
        depth_m = depth / intr.depth_scale
        rgb = None
        if i < len(rgb_files):
            rgb = np.asarray(
                Image.open(os.path.join(args.rgb_img_folder, rgb_files[i])).convert("RGB")
            )
        pc = depth_to_points(depth_m, intr, rgb, args.max_depth_m, flip)
        io.write_ply(os.path.join(ply_path, f"{i:06d}.ply"), pc)

    print(f"The rgbd dataset in KITTI format has been saved at {args.output_root}")


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--depth_img_folder")
    p.add_argument("--rgb_img_folder", default="")
    p.add_argument("--intrinsic_file", default="")
    p.add_argument("--pose_file")
    p.add_argument("--output_root")
    p.add_argument("--max_depth_m", type=float, default=5.0)
    p.add_argument("--is_focal_file", type=str2bool, nargs="?", default=True)
    p.add_argument("--already_kitti_format_pose", type=str2bool, nargs="?", default=False)
    rgbd_to_kitti_format(p.parse_args())


if __name__ == "__main__":
    main()
