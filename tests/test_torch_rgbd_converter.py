"""The port's RGB-D converter (shine_mapping_tpu_torch/data/rgbd_converter.py)
and the RGB-D path through the port, on a synthetic room.

* tests/test_rgbd_converter.py's three cases on the port;
* the files the port's converter writes (its ``python -m`` entry) are
  byte-equal to the JAX converter's on the same sequence;
* the port's sample pool equals JAX's ``LiDARDataset`` pool, both built
  from the converted room under ``config/rgbd/rgbd_batch.yaml`` (reduced:
  3 frames of 160 x 120);
* a short batch run of the port on the converted room is within 5 F-score
  points of the JAX driver's (reductions in :func:`small_rgbd_cfg`).

The room (numpy and PIL only, so ``chip_smoke.py`` loads this module on a
host without jax): a 3.6 x 3.0 x 2.5 m box with a table, a cabinet and a
ball inside, seen by a pinhole camera that turns once around the room's
middle.  It is written as NeuralRGBD writes a sequence: 16-bit millimetre
depth PNGs, RGB PNGs, a focal-length file and 4x4 camera-to-world poses
(OpenGL camera axes).  Its ground truth is the exact ray hits of the same
cameras (no millimetre rounding), the surface the frames see.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROOM_MIN = np.array([-1.8, -1.5, 0.0])
ROOM_MAX = np.array([1.8, 1.5, 2.5])
BOXES = (  # (min, max): a table and a cabinet against two walls
    (np.array([0.4, -1.2, 0.0]), np.array([1.3, -0.4, 0.75])),
    (np.array([-1.8, 0.7, 0.0]), np.array([-1.3, 1.5, 1.6])),
)
BALL_C, BALL_R = np.array([-0.3, 0.6, 0.45]), 0.45
PALETTE = np.array([[200, 180, 150], [240, 240, 240], [180, 60, 60], [60, 160, 80],
                    [70, 90, 190], [210, 190, 60], [120, 80, 40], [90, 90, 90],
                    [230, 110, 30]], np.uint8)
FLIP_YZ = np.diag([1.0, -1.0, -1.0])  # OpenCV camera axes <-> OpenGL


def room_pose(k: int, n: int) -> np.ndarray:
    """Camera k of n (4x4 camera-to-world, OpenGL axes: x right, y up,
    looking down -z): on an ellipse around the room's middle at ~1.35 m,
    turning once, 20 degrees down."""
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
    with np.errstate(divide="ignore", invalid="ignore"):
        t1, t2 = (lo - o) / d, (hi - o) / d
    return np.minimum(t1, t2), np.maximum(t1, t2)


def room_hits(o: np.ndarray, d: np.ndarray):
    """First hit of rays ``o + t d`` (d: (N, 3)) inside the room: (t, surface
    id); every ray hits (the room is closed)."""
    near, far = _slabs(o, d, ROOM_MIN, ROOM_MAX)
    far = np.where(np.isnan(far), np.inf, far)
    axis = far.argmin(axis=1)
    t = far[np.arange(len(d)), axis]
    side = (d[np.arange(len(d)), axis] > 0).astype(np.int64)
    sid = np.where(axis == 2, side, 2 + 2 * axis + side)  # floor 0, ceiling 1, walls 2-5
    for j, (lo, hi) in enumerate(BOXES):
        near, far = _slabs(o, d, lo, hi)
        tn = np.nanmax(near, axis=1)
        tf = np.nanmin(far, axis=1)
        hit = (tn <= tf) & (tn > 1e-6) & (tn < t)
        t, sid = np.where(hit, tn, t), np.where(hit, 6 + j, sid)
    oc = o - BALL_C
    b = d @ oc
    a = np.einsum("ij,ij->i", d, d)
    disc = b * b - a * (oc @ oc - BALL_R ** 2)
    tb = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
    hit = (disc > 0) & (tb > 1e-6) & (tb < t)
    return np.where(hit, tb, t), np.where(hit, 8, sid)


def _camera_rays(T, W, H, focal, stride=1):
    """World directions of the pixels' rays, scaled so that the ray
    parameter is the depth (the camera-frame distance along the axis)."""
    u, v = np.meshgrid(np.arange(0, W, stride), np.arange(0, H, stride), indexing="xy")
    d_cv = np.stack([(u - (W - 1) / 2) / focal, (v - (H - 1) / 2) / focal, np.ones(u.shape)],
                    axis=-1).reshape(-1, 3)
    return d_cv @ (T[:3, :3] @ FLIP_YZ).T, u.shape


def write_rgbd_room(root: str, n_frames: int, W: int = 640, H: int = 480,
                    focal: float = 554.0) -> dict:
    """The room's sequence in NeuralRGBD's layout under ``root``: depth/ and
    rgb/ PNGs, focal.txt, poses.txt (4x4 blocks).  Returns the paths."""
    paths = {k: os.path.join(root, k) for k in ("depth", "rgb")}
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    paths["focal"] = os.path.join(root, "focal.txt")
    paths["poses"] = os.path.join(root, "poses.txt")
    with open(paths["focal"], "w") as f:
        f.write(f"{focal}\n")
    with open(paths["poses"], "w") as f:
        for k in range(n_frames):
            T = room_pose(k, n_frames)
            d, shape = _camera_rays(T, W, H, focal)
            t, sid = room_hits(T[:3, 3], d)
            depth = np.round(t * 1000.0).astype(np.uint16).reshape(shape)
            Image.fromarray(depth).save(os.path.join(paths["depth"], f"{k}.png"))
            Image.fromarray(PALETTE[sid].reshape(shape + (3,))).save(
                os.path.join(paths["rgb"], f"{k}.png"))
            for row in T:
                f.write(" ".join(repr(float(x)) for x in row) + "\n")
    return paths


def room_gt_points(n_frames: int, W: int = 640, H: int = 480, focal: float = 554.0,
                   stride: int = 2, frames=None) -> np.ndarray:
    """The exact surface points that the sequence's frames (or those of
    them listed in ``frames``) see: every ``stride``-th pixel's ray hit,
    unrounded, world frame."""
    out = []
    for k in range(n_frames) if frames is None else frames:
        T = room_pose(k, n_frames)
        d, _ = _camera_rays(T, W, H, focal, stride)
        t, _ = room_hits(T[:3, 3], d)
        out.append(T[:3, 3] + t[:, None] * d)
    return np.concatenate(out)


def convert_room(paths: dict, out: str, entry: bool = True) -> None:
    """The port's converter on the room: its ``python -m`` entry, or the
    function in this process."""
    argv = ["--depth_img_folder", paths["depth"], "--rgb_img_folder", paths["rgb"],
            "--intrinsic_file", paths["focal"], "--pose_file", paths["poses"],
            "--output_root", out]
    if entry:
        subprocess.run([sys.executable, "-m", "shine_mapping_tpu_torch.data.rgbd_converter"]
                       + argv, cwd=REPO, check=True, capture_output=True, timeout=300)
    else:
        from shine_mapping_tpu_torch.data.rgbd_converter import rgbd_to_kitti_format

        rgbd_to_kitti_format(_args(paths, out))


def _args(paths, out):
    return types.SimpleNamespace(
        depth_img_folder=paths["depth"], rgb_img_folder=paths["rgb"],
        intrinsic_file=paths["focal"], pose_file=paths["poses"], output_root=out,
        max_depth_m=5.0, is_focal_file=True, already_kitti_format_pose=False)


def rgbd_cfg(cls, kitti_root: str, out: str, device=None, **over):
    """``config/rgbd/rgbd_batch.yaml`` loaded by ``cls`` (either package's
    SHINEConfig) with the data paths of the converted room and ``over``
    applied."""
    cfg = cls().load(os.path.join(REPO, "config", "rgbd", "rgbd_batch.yaml"))
    cfg.pc_path = os.path.join(kitti_root, "rgbd_ply")
    cfg.pose_path = os.path.join(kitti_root, "poses.txt")
    cfg.output_root = out
    if device is not None:
        cfg.device = device
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


# ---------------------------------------------------------------- the tests

def test_depth_to_points_plane():
    from shine_mapping_tpu_torch.data.rgbd_converter import Intrinsics, depth_to_points

    intr = Intrinsics(width=64, height=48, fx=50.0, fy=50.0, cx=31.5, cy=23.5)
    depth = np.full((48, 64), 2.0)
    pc = depth_to_points(depth, intr, None, max_depth_m=5.0, flip=False)
    assert len(pc) == 48 * 64
    np.testing.assert_allclose(pc.points[:, 2], 2.0)
    center = pc.points[np.argmin(np.abs(pc.points[:, :2]).sum(axis=1))]
    assert abs(center[0]) < 0.05 and abs(center[1]) < 0.05
    depth[0, 0] = 10.0
    pc2 = depth_to_points(depth, intr, None, max_depth_m=5.0, flip=False)
    assert len(pc2) == 48 * 64 - 1


def test_full_conversion(tmp_path):
    from shine_mapping_tpu_torch.data import io
    from shine_mapping_tpu_torch.data.rgbd_converter import rgbd_to_kitti_format

    depth_dir, rgb_dir = tmp_path / "depth", tmp_path / "rgb"
    depth_dir.mkdir()
    rgb_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        depth_mm = (rng.uniform(500, 3000, (48, 64))).astype(np.uint16)
        Image.fromarray(depth_mm).save(depth_dir / f"{i}.png")
        rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        Image.fromarray(rgb).save(rgb_dir / f"{i}.png")
    focal_file = tmp_path / "focal.txt"
    focal_file.write_text("50.0\n")
    pose_file = tmp_path / "poses_in.txt"
    with open(pose_file, "w") as f:
        for i in range(3):
            T = np.eye(4)
            T[0, 3] = i * 0.1
            for row in T:
                f.write(" ".join(str(v) for v in row) + "\n")
    paths = dict(depth=str(depth_dir), rgb=str(rgb_dir), focal=str(focal_file),
                 poses=str(pose_file))
    rgbd_to_kitti_format(_args(paths, str(tmp_path / "out")))
    out = tmp_path / "out"
    assert sorted(os.listdir(out / "rgbd_ply")) == ["000000.ply", "000001.ply", "000002.ply"]
    pc = io.read_point_cloud(str(out / "rgbd_ply" / "000000.ply"))
    assert len(pc) > 1000
    assert pc.colors is not None
    poses = np.loadtxt(out / "poses.txt")
    assert poses.shape == (3, 12)
    np.testing.assert_allclose(poses[2, 3], 0.2, atol=1e-9)


def test_load_poses_blocks(tmp_path):
    from shine_mapping_tpu_torch.data.rgbd_converter import load_poses

    p = tmp_path / "p.txt"
    T1, T2 = np.eye(4), np.eye(4)
    T2[1, 3] = 5.0
    with open(p, "w") as f:
        for T in (T1, T2):
            for row in T:
                f.write(" ".join(str(v) for v in row) + "\n")
    poses = load_poses(str(p))
    assert len(poses) == 2
    np.testing.assert_allclose(poses[1][1, 3], 5.0)


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """3 frames of the room at 160 x 120 (focal scaled), converted by the
    port's ``python -m`` entry and by the JAX converter."""
    from shine_mapping_tpu.data.rgbd_converter import rgbd_to_kitti_format as jax_convert

    base = tmp_path_factory.mktemp("room")
    paths = write_rgbd_room(str(base / "raw"), 3, W=160, H=120, focal=138.5)
    convert_room(paths, str(base / "port"))
    jax_convert(_args(paths, str(base / "jax")))
    return str(base)


def test_room_views_the_room(room):
    """The synthetic sequence itself: depths within the room's reach, every
    surface class seen, the converted points on the room's surfaces."""
    from shine_mapping_tpu_torch.data import io

    depth = np.asarray(Image.open(os.path.join(room, "raw", "depth", "0.png")))
    assert depth.dtype == np.uint16 and depth.shape == (120, 160)
    assert 300 < depth.min() and depth.max() < 4000
    poses = np.loadtxt(os.path.join(room, "port", "poses.txt"))
    pc = io.read_point_cloud(os.path.join(room, "port", "rgbd_ply", "000001.ply"))
    T = np.eye(4)
    T[:3] = poses[1].reshape(3, 4)
    world = pc.points @ T[:3, :3].T + T[:3, 3]
    gt = room_gt_points(3, W=160, H=120, focal=138.5, stride=1)
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(gt).query(world)
    assert dist.max() < 2e-3  # millimetre depths
    assert len(np.unique(np.concatenate(
        [room_hits(room_pose(k, 3)[:3, 3], _camera_rays(room_pose(k, 3), 160, 120, 138.5)[0])[1]
         for k in range(3)]))) >= 7


def test_converter_writes_jax_bytes(room):
    """Every file of the port's output (its ``python -m`` entry) byte-equal
    to the JAX converter's."""
    port, jax = os.path.join(room, "port"), os.path.join(room, "jax")
    files = sorted(os.path.relpath(os.path.join(d, f), port)
                   for d, _, fs in os.walk(port) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), jax)
                           for d, _, fs in os.walk(jax) for f in fs)
    assert len(files) == 4
    for f in files:
        with open(os.path.join(port, f), "rb") as a, open(os.path.join(jax, f), "rb") as b:
            assert a.read() == b.read(), f


def test_room_pool_equals_jax(room, tmp_path):
    """rgbd_batch.yaml as it stands (4 levels, leaf 0.02 m, world level 12,
    ``calib_path: ''``, the dataset reading the coloured plys), the data
    paths aside: the same pool and octree from the converted room."""
    from shine_mapping_tpu.config import SHINEConfig as JaxConfig
    from shine_mapping_tpu.data.dataset import LiDARDataset as JaxDataset
    from shine_mapping_tpu.ops.hashgrid import HashGridHost as JaxGrid
    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.data.dataset import LiDARDataset
    from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost

    out = {}
    for name, cls, ds_cls, grid_cls in (("jax", JaxConfig, JaxDataset, JaxGrid),
                                        ("port", SHINEConfig, LiDARDataset, HashGridHost)):
        cfg = rgbd_cfg(cls, os.path.join(room, name), str(tmp_path / name), every_frame=1)
        assert (cfg.tree_level_feat, cfg.leaf_vox_size, cfg.tree_level_world,
                cfg.calib_path) == (4, 0.02, 12, "")
        kw = {"device": "cpu"} if name == "port" else {}
        grid = grid_cls(max_level=cfg.tree_level_world, featured_level_num=cfg.tree_level_feat,
                        feature_dim=cfg.feature_dim, feature_std=cfg.feature_std,
                        leaf_vox_size=cfg.leaf_vox_size, seed=cfg.seed,
                        init_node_capacity=1 << 14, init_corner_capacity=1 << 14, **kw)
        ds = ds_cls(cfg, grid)
        assert ds.frame_ids() == [0, 1, 2]
        for f in ds.frame_ids():
            ds.process_frame(f)
        out[name] = ds
    port, jax = out["port"], out["jax"]
    assert len(port.pool) > 10_000
    for f in ("coord", "sdf_label", "weight", "time"):
        np.testing.assert_array_equal(getattr(port.pool, f), getattr(jax.pool, f), err_msg=f)
    want = jax.grid.state_dict()
    got = port.grid.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# the short batch run: rgbd_batch.yaml with these cuts (iters 20,000, bs
# 4,096, every 5th of 1,500 frames at 640 x 480, mc_res 0.01 m as written)
SMALL = dict(every_frame=1, iters=100, bs=2048, vis_freq_iters=100, save_freq_iters=0,
             mc_res_m=0.02)
SMALL_FRAMES, SMALL_W, SMALL_H, SMALL_FOCAL = 4, 160, 120, 138.5
FSCORE_AT = 0.02  # m: the room's inlier threshold (the leaf is 0.02 m)


def score_room(mesh_path, gt_path, threshold=FSCORE_AT):
    """``eval_mesh`` at the room's scale, without the crop to the ground
    truth's bounding box: the room's walls lie on that box, and the crop
    would cut the half of each wall's vertices that sits a hair outside."""
    from shine_mapping_tpu_torch.eval.metrics import eval_mesh

    return eval_mesh(mesh_path, gt_path, down_sample_res=0.01, threshold=threshold,
                     truncation_acc=0.2, truncation_com=0.2, mesh_sample_point=300_000,
                     gt_bbx_mask_on=False)


def small_rgbd_cfg(cls, kitti_root, out, **kw):
    """rgbd_batch.yaml on the small room with :data:`SMALL`'s cuts."""
    return rgbd_cfg(cls, kitti_root, out, **{**SMALL, **kw})


def test_room_batch_within_5_points_of_jax(tmp_path):
    """The port's batch CLI on the converted room (4 levels, leaf 0.02 m,
    world level 12, 2x32 MLP, sdf_bce, octree meshing; cut by
    :data:`SMALL`) against the JAX driver on the same files: Chamfer-L1
    under 1 cm, the F-score at 2 cm over 90 % and within 5 points of JAX's
    (measured: port 99.54 %, JAX 99.53 %, Chamfer-L1 5.3 mm)."""
    import torch

    from shine_mapping_tpu.cli.shine_batch import run_shine_mapping_batch as jax_run
    from shine_mapping_tpu.config import SHINEConfig as JaxConfig
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.data import io

    paths = write_rgbd_room(str(tmp_path / "raw"), SMALL_FRAMES, SMALL_W, SMALL_H, SMALL_FOCAL)
    kitti = str(tmp_path / "kitti")
    convert_room(paths, kitti, entry=False)
    gt = str(tmp_path / "gt.ply")
    io.write_ply(gt, io.PointCloud(points=room_gt_points(SMALL_FRAMES, SMALL_W, SMALL_H,
                                                         SMALL_FOCAL, stride=1)))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port, _, _ = run_shine_mapping_batch(cfg=small_rgbd_cfg(
            SHINEConfig, kitti, str(tmp_path / "port"), device="cpu"))
    finally:
        torch.set_num_threads(n)
    jax, _, _ = jax_run(cfg=small_rgbd_cfg(JaxConfig, kitti, str(tmp_path / "jax")))
    mesh = f"mesh/mesh_iter_{SMALL['iters']}.ply"
    m_port, m_jax = score_room(os.path.join(port, mesh), gt), score_room(os.path.join(jax, mesh), gt)
    print("port", {k: round(v, 4) for k, v in m_port.items()}, "jax", m_jax["F-score (%)"])
    for m in (m_port, m_jax):
        assert m["Chamfer_L1 (m)"] < 0.01 and m["F-score (%)"] > 90.0, m
    assert abs(m_port["F-score (%)"] - m_jax["F-score (%)"]) < 5.0
