"""The port's visualizer (shine_mapping_tpu_torch/visualizer.py): the key
state machine and the offscreen rasterizer of tests/test_visualizer.py on
the port, the same PNG bytes as the JAX package's for the same scene, and
both CLIs with ``o3d_vis_on: true`` writing their snapshots into
``run_path/vis`` (Open3D absent: one PNG per mesh in the batch driver, per
frame in the incremental one)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from shine_mapping_tpu_torch.visualizer import MapVisualizer
from tests import synth
from tests.test_torch_cli import port_cfg


def make_vis():
    v = MapVisualizer()
    assert v._vis is None  # headless: no Open3D
    return v


def test_space_pause_resume_and_step():
    v = make_vis()
    assert v.should_advance()
    v.handle_key(" ")
    assert not v.playing
    assert not v.should_advance()
    v.handle_key("N")
    assert v.should_advance()
    assert not v.should_advance()
    v.handle_key(" ")
    assert v.should_advance()


def test_step_ignored_while_playing():
    v = make_vis()
    v.handle_key("N")
    assert not v.step_once


@pytest.mark.parametrize("key", ["Q", "\x1b"])
def test_quit_keys(key):
    v = make_vis()
    v.handle_key(key)
    assert v.quit_requested
    assert not v.should_advance()


def test_view_and_render_toggles():
    v = make_vis()
    assert not v.global_view and v.render_scan and v.render_map
    v.handle_key("V")
    assert v.global_view
    v.handle_key("V")
    assert not v.global_view
    v.handle_key("F")
    assert not v.render_scan
    v.handle_key("M")
    assert not v.render_map
    v.handle_key("B")
    assert v.background == "black"
    v.handle_key("W")
    assert v.background == "white"


def test_headless_update_noop():
    v = make_vis()
    v.update(None, None, None)
    v.update_mesh(None)
    v.stop()


def _scene(io):
    """A ground quad mesh + a little scan + a pose, metric scale (built with
    ``io``, either package's data.io)."""
    g = np.linspace(-10, 10, 9)
    xx, yy = np.meshgrid(g, g)
    v = np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size)], 1)
    n = len(g)
    tris = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            tris += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    mesh = io.TriangleMesh(vertices=v.astype(np.float32), triangles=np.asarray(tris, np.int32),
                           vertex_normals=None, vertex_colors=None)
    rng = np.random.default_rng(0)
    scan = io.PointCloud(points=rng.uniform(-8, 8, (400, 3)).astype(np.float32)
                         * np.array([1, 1, 0.05], np.float32)
                         + np.array([0, 0, 1.0], np.float32))
    pose = np.eye(4)
    pose[:3, 3] = [0, 0, 1.2]
    return scan, pose, mesh


def _golden(img):
    return ((img[..., 0] > 200) & (img[..., 1] > 150) & (img[..., 2] < 120)).sum()


def test_render_offscreen_draws_scene(tmp_path):
    from shine_mapping_tpu_torch.data import io

    scan, pose, mesh = _scene(io)
    v = make_vis()
    p = str(tmp_path / "frame.png")
    img = v.render_offscreen(p, scan_pc=scan, pose=pose, mesh=mesh, width=320, height=200)
    assert img.shape == (200, 320, 3)
    assert os.path.exists(p)
    white = (img == 255).all(axis=2).mean()
    assert white < 0.9, "nothing was drawn"
    golden = _golden(img)
    assert golden > 10

    def again():
        return v.render_offscreen("", scan_pc=scan, pose=pose, mesh=mesh, width=320, height=200)

    v.handle_key("F")  # hides the scan
    assert _golden(again()) < golden / 2
    v.handle_key("F")
    v.handle_key("M")  # hides the mesh
    assert (again() == 255).all(axis=2).mean() > white
    v.handle_key("M")
    v.handle_key("B")
    assert (again() == 0).all(axis=2).mean() > 0.05
    v.handle_key("W")
    v.handle_key("V")  # the overhead view
    assert (again() != img).mean() > 0.05


@pytest.mark.parametrize("keys", ["", "V", "B", "F", "M"])
def test_render_offscreen_writes_jax_png_bytes(tmp_path, keys):
    """The same scene, control state and size: the port's PNG file and
    image byte-equal to the JAX package's."""
    from shine_mapping_tpu.data import io as jax_io
    from shine_mapping_tpu.visualizer import MapVisualizer as JaxVisualizer
    from shine_mapping_tpu_torch.data import io

    imgs, files = [], []
    for cls, pkg_io in ((MapVisualizer, io), (JaxVisualizer, jax_io)):
        scan, pose, mesh = _scene(pkg_io)
        v = cls()
        for k in keys:
            v.handle_key(k)
        path = str(tmp_path / f"{cls.__module__}.png")
        imgs.append(v.render_offscreen(path, scan_pc=scan, pose=pose, mesh=mesh,
                                       width=320, height=200))
        with open(path, "rb") as f:
            files.append(f.read())
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert files[0] == files[1]


def _snapshots(run_path):
    d = os.path.join(run_path, "vis")
    names = sorted(os.listdir(d))
    for n in names:  # each non-blank: 1 % of its pixels off the white background
        img = np.asarray(Image.open(os.path.join(d, n)))
        assert (img != 255).any(axis=2).mean() > 0.01, n
    return names


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_kitti"))
    synth.make_kitti_dataset(root, n_frames=3)
    return root


def test_batch_cli_writes_a_snapshot_per_mesh(world, tmp_path):
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = port_cfg(world, str(tmp_path), o3d_vis_on=True, iters=40, scan_chunk=20,
                       vis_freq_iters=20, mc_res_m=0.3)
        run_path, _, _ = run_shine_mapping_batch(cfg=cfg)
    finally:
        torch.set_num_threads(n)
    assert sorted(os.listdir(os.path.join(run_path, "mesh"))) == [
        "mesh_iter_20.ply", "mesh_iter_40.ply"]
    assert _snapshots(run_path) == ["vis_0000.png", "vis_0001.png"]


def test_incre_cli_writes_a_snapshot_per_frame(world, tmp_path):
    from shine_mapping_tpu_torch.cli.shine_incre import run_shine_mapping_incremental
    from tests.test_torch_incre_cli import port_cfg as incre_port_cfg

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = incre_port_cfg(world, str(tmp_path), "reg", o3d_vis_on=True, iters=10,
                             mc_res_m=0.3)
        run_path, _, _ = run_shine_mapping_incremental(cfg=cfg)
    finally:
        torch.set_num_threads(n)
    assert _snapshots(run_path) == ["vis_0000.png", "vis_0001.png", "vis_0002.png"]
