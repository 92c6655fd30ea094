"""Scan files as the datasets ship them: binary little-endian PLY point
clouds (MaiCity's scans, NeuralRGBD's frames after the RGB-D converter) and
KITTI-format pose and calibration text files."""

from __future__ import annotations

import numpy as np


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """``points`` (N, 3) as float32 x, y, z; ``colors`` (N, 3) uint8 or None."""
    pts = np.asarray(points, np.float32)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.empty(len(pts), dtype=fields)
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
    props = "".join(f"property {'float' if t == '<f4' else 'uchar'} {n}\n" for n, t in fields)
    header = f"ply\nformat binary_little_endian 1.0\nelement vertex {len(pts)}\n{props}end_header\n"
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def read_ply_xyz(path: str) -> np.ndarray:
    """The x, y, z columns of a PLY that :func:`write_ply` wrote, float64."""
    with open(path, "rb") as f:
        props, count = [], 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                count = int(line.split()[2])
            elif line.startswith("property"):
                _, t, name = line.split()
                props.append((name, "<f4" if t == "float" else "u1"))
            elif line == "end_header":
                break
        rec = np.frombuffer(f.read(), dtype=props, count=count)
    return np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float64)


def write_kitti_poses(path: str, poses) -> None:
    """One 3 x 4 row-major pose a line (KITTI odometry layout)."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(repr(float(v)) for v in np.asarray(T)[:3].reshape(-1)) + "\n")


def read_kitti_poses(path: str) -> list:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                T = np.eye(4)
                T[:3] = np.array([float(v) for v in line.split()]).reshape(3, 4)
                out.append(T)
    return out


def write_identity_calib(path: str) -> None:
    with open(path, "w") as f:
        f.write("Tr: " + " ".join(str(v) for v in np.eye(4)[:3].reshape(-1)) + "\n")
