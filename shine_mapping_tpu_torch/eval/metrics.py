"""Offline mesh evaluation against a ground-truth point cloud.

The port's copy of ``shine_mapping_tpu/eval/metrics.py`` (numpy and scipy
only, on the port's own ``data.io`` and ``data.preprocess``).

Parity target: reference eval/eval_utils.py:24-141 — uniform mesh sampling,
voxel downsampling of both clouds, two-way truncated nearest-neighbor
distances, MAE accuracy/completeness, Chamfer-L1/L2, precision/recall/
F-score at an inlier threshold; plus the intersection-crop utility
(eval/eval_utils.py:180-216) and depth-map metrics (eval/eval_utils.py:
144-178).  KD-trees come from scipy (C implementation) instead of Open3D.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..data import io
from ..data.preprocess import voxel_downsample


def sample_points_uniformly(mesh: io.TriangleMesh, n_points: int,
                            rng: np.random.Generator | None = None) -> np.ndarray:
    """Area-weighted uniform sampling on mesh triangles
    (o3d sample_points_uniformly equivalent)."""
    if rng is None:
        rng = np.random.default_rng(0)
    v0 = mesh.vertices[mesh.triangles[:, 0]]
    v1 = mesh.vertices[mesh.triangles[:, 1]]
    v2 = mesh.vertices[mesh.triangles[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = areas.sum()
    if total <= 0 or mesh.triangles.shape[0] == 0:
        return np.zeros((0, 3))
    probs = areas / total
    tri_idx = rng.choice(areas.size, size=n_points, p=probs)
    u = rng.random(n_points)
    v = rng.random(n_points)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    return (
        v0[tri_idx]
        + u[:, None] * (v1[tri_idx] - v0[tri_idx])
        + v[:, None] * (v2[tri_idx] - v0[tri_idx])
    )


def nn_correspondence(
    verts1: np.ndarray,
    verts2: np.ndarray,
    truncation_dist: float,
    ignore_outlier: bool = True,
) -> np.ndarray:
    """For each vertex in verts2, distance to its NN in verts1, truncated.

    Parity: eval/eval_utils.py:110-141 — outliers are dropped when
    ``ignore_outlier`` (accuracy direction) or clamped to the truncation
    distance otherwise (completeness direction).
    """
    from scipy.spatial import cKDTree

    if len(verts1) == 0 or len(verts2) == 0:
        return np.zeros(0)
    tree = cKDTree(verts1)
    # workers=-1: parallel NN queries (identical results; the city-scale
    # eval's two-way 10M-point query was 137 s single-threaded)
    dist, _ = tree.query(verts2, k=1, workers=-1)
    if ignore_outlier:
        return dist[dist < truncation_dist]
    return np.minimum(dist, truncation_dist)


def eval_mesh(
    file_pred: str,
    file_trgt: str,
    down_sample_res: float = 0.02,
    threshold: float = 0.05,
    truncation_acc: float = 0.50,
    truncation_com: float = 0.50,
    gt_bbx_mask_on: bool = True,
    mesh_sample_point: int = 10_000_000,
    possion_sample_init_factor: int = 5,
) -> Dict[str, float]:
    """Mesh-vs-GT metric suite (eval/eval_utils.py:24-107)."""
    mesh_pred = io.read_ply(file_pred)
    assert isinstance(mesh_pred, io.TriangleMesh), "prediction must be a mesh"
    pcd_trgt = io.read_point_cloud(file_trgt)

    if gt_bbx_mask_on:
        mn = pcd_trgt.points.min(axis=0).copy()
        mx = pcd_trgt.points.max(axis=0).copy()
        mn[2] -= down_sample_res
        mx[2] += down_sample_res
        keep = np.all((mesh_pred.vertices >= mn) & (mesh_pred.vertices <= mx), axis=1)
        mesh_pred = _crop_mesh(mesh_pred, keep)

    pts_pred = sample_points_uniformly(mesh_pred, mesh_sample_point)
    if down_sample_res > 0:
        before = pts_pred.shape[0]
        pts_pred = voxel_downsample(io.PointCloud(points=pts_pred), down_sample_res).points
        pts_trgt = voxel_downsample(pcd_trgt, down_sample_res).points
        print(
            f"Predicted mesh uniform sample: {before} --> {pts_pred.shape[0]} "
            f"({down_sample_res} m)"
        )
    else:
        pts_trgt = pcd_trgt.points

    dist_p = nn_correspondence(pts_trgt, pts_pred, truncation_acc, True)
    dist_r = nn_correspondence(pts_pred, pts_trgt, truncation_com, False)

    dist_p_mean = float(np.mean(dist_p)) if dist_p.size else float("nan")
    dist_r_mean = float(np.mean(dist_r)) if dist_r.size else float("nan")
    chamfer_l1 = 0.5 * (dist_p_mean + dist_r_mean)
    chamfer_l2 = float(
        np.sqrt(0.5 * (np.mean(dist_p ** 2) + np.mean(dist_r ** 2)))
    )
    precision = float(np.mean((dist_p < threshold).astype(float)) * 100.0)
    recall = float(np.mean((dist_r < threshold).astype(float)) * 100.0)
    fscore = 2 * precision * recall / max(precision + recall, 1e-12)

    return {
        "MAE_accuracy (m)": dist_p_mean,
        "MAE_completeness (m)": dist_r_mean,
        "Chamfer_L1 (m)": chamfer_l1,
        "Chamfer_L2 (m)": chamfer_l2,
        "Precision [Accuracy] (%)": precision,
        "Recall [Completeness] (%)": recall,
        "F-score (%)": fscore,
        "Spacing (m)": down_sample_res,
        "Inlier_threshold (m)": threshold,
        "Outlier_truncation_acc (m)": truncation_acc,
        "Outlier_truncation_com (m)": truncation_com,
    }


def eval_depth(depth_pred: np.ndarray, depth_trgt: np.ndarray) -> Dict[str, float]:
    """2D depth-map metrics (eval/eval_utils.py:144-178)."""
    mask1 = depth_pred > 0
    mask = (depth_trgt < 10) * (depth_trgt > 0) * mask1
    dp, dt = depth_pred[mask], depth_trgt[mask]
    abs_diff = np.abs(dp - dt)
    abs_rel = abs_diff / dt
    sq_diff = abs_diff ** 2
    sq_rel = sq_diff / dt
    sq_log_diff = (np.log(dp) - np.log(dt)) ** 2
    thresh = np.maximum(dt / dp, dp / dt)
    return {
        "AbsRel": float(np.mean(abs_rel)),
        "AbsDiff": float(np.mean(abs_diff)),
        "SqRel": float(np.mean(sq_rel)),
        "RMSE": float(np.sqrt(np.mean(sq_diff))),
        "LogRMSE": float(np.sqrt(np.mean(sq_log_diff))),
        "r1": float(np.mean((thresh < 1.25).astype(float))),
        "r2": float(np.mean((thresh < 1.25 ** 2).astype(float))),
        "r3": float(np.mean((thresh < 1.25 ** 3).astype(float))),
        "complete": float(np.mean(mask1.astype(float))),
    }


def crop_intersection(
    file_gt: str,
    files_pred: List[str],
    out_file_crop: str,
    dist_thre: float = 0.1,
    mesh_sample_point: int = 1_000_000,
) -> None:
    """Crop the GT cloud to the intersection of several predictions
    (eval/eval_utils.py:180-216) for fair cross-method comparison."""
    from scipy.spatial import cKDTree

    pcd_gt = io.read_point_cloud(file_gt)
    pts = pcd_gt.points
    for path in files_pred:
        mesh = io.read_ply(path)
        assert isinstance(mesh, io.TriangleMesh)
        sample = sample_points_uniformly(mesh, mesh_sample_point)
        tree = cKDTree(sample)
        d, _ = tree.query(pts, k=1, workers=-1)
        pts = pts[d < dist_thre]
    io.write_ply(out_file_crop, io.PointCloud(points=pts))


def _crop_mesh(mesh: io.TriangleMesh, keep: np.ndarray) -> io.TriangleMesh:
    remap = -np.ones(mesh.vertices.shape[0], dtype=np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    tri_keep = keep[mesh.triangles].all(axis=1)
    tri = remap[mesh.triangles[tri_keep]]
    return io.TriangleMesh(
        vertices=mesh.vertices[keep],
        triangles=tri.astype(np.int32),
        vertex_normals=None if mesh.vertex_normals is None else mesh.vertex_normals[keep],
        vertex_colors=None if mesh.vertex_colors is None else mesh.vertex_colors[keep],
    )
