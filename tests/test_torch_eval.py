"""The port's evaluation (eval/metrics.py) and marching tetrahedra
(ops/marching.py, its C++ and plain numpy versions) against the JAX
package's, on fixed inputs: equal results (the same numpy code on the same
inputs).  And the C++ build raising, not falling back, without its
source."""

import numpy as np
import pytest

from shine_mapping_tpu.data import io as jio
from shine_mapping_tpu.eval import metrics as jmetrics
from shine_mapping_tpu.ops.marching import marching_tetrahedra as jax_marching
from shine_mapping_tpu_torch.data import io
from shine_mapping_tpu_torch.eval import metrics
from shine_mapping_tpu_torch.ops import marching, native_build
from tests.test_marching import sphere_grid


def _grids():
    sdf, spacing, origin = sphere_grid(n=40)
    mask = np.ones(sdf.shape, dtype=bool)
    mask[: sdf.shape[0] // 2] = False
    ax = np.linspace(-1, 1, 24)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    plane = z - 0.1 * x + 0.03
    return {
        "sphere": (sdf, None, spacing, origin),
        "sphere_masked": (sdf, mask, spacing, origin),
        "plane": (plane, None, ax[1] - ax[0], np.array([-1.0, -1.0, -1.0])),
        "empty": (np.ones((8, 8, 8)), None, 1.0, None),
    }


@pytest.mark.parametrize("case", ["sphere", "sphere_masked", "plane", "empty"])
def test_marching_native_and_plain_equal_jax(case):
    sdf, mask, spacing, origin = _grids()[case]
    kw = dict(mask=mask, spacing=spacing, origin=origin)
    v_nat, f_nat = marching.marching_tetrahedra(sdf, 0.0, **kw)
    v_jn, f_jn = jax_marching(sdf, 0.0, **kw)  # the JAX package's C++ version
    np.testing.assert_array_equal(f_nat, f_jn)
    np.testing.assert_array_equal(v_nat, v_jn)
    v_pl, f_pl = marching.marching_tetrahedra_plain(sdf, 0.0, **kw)
    v_jp, f_jp = jax_marching(sdf, 0.0, prefer_native=False, **kw)
    np.testing.assert_array_equal(f_pl, f_jp)
    np.testing.assert_array_equal(v_pl, v_jp)
    if case != "empty":
        assert f_nat.shape[0] > 100
        # the two versions extract the same surface (up to vertex order)
        assert f_nat.shape == f_pl.shape
        np.testing.assert_allclose(np.sort(v_nat, axis=0), np.sort(v_pl, axis=0), atol=1e-5)


def test_native_build_raises_without_source(tmp_path, monkeypatch):
    """No source (or no compiler): the port's marching raises; it does not
    fall back to the plain version, and neither does the mesher."""
    monkeypatch.setattr(native_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_build, "_libs", {})
    sdf = _grids()["sphere"][0]
    with pytest.raises(FileNotFoundError, match="marching.cpp"):
        marching.marching_tetrahedra(sdf, 0.0)
    (tmp_path / "marching.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        marching.marching_tetrahedra(sdf, 0.0)
    assert marching.marching_tetrahedra_plain(sdf, 0.0)[1].shape[0] > 100


def _sphere_mesh_files(tmp_path):
    sdf, spacing, origin = sphere_grid(n=40)
    verts, faces = marching.marching_tetrahedra(sdf, 0.0, spacing=spacing, origin=origin)
    mesh_path = str(tmp_path / "sphere.ply")
    io.write_ply(mesh_path, io.TriangleMesh(vertices=verts, triangles=faces.astype(np.int32)))
    rng = np.random.default_rng(0)
    v = rng.standard_normal((30000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    gt = np.concatenate([v * 0.6, rng.uniform(2, 3, (3000, 3))])
    gt_path = str(tmp_path / "gt.ply")
    io.write_ply(gt_path, io.PointCloud(points=gt))
    return mesh_path, gt_path


@pytest.mark.parametrize("kw", [
    dict(down_sample_res=0.02, threshold=0.05, truncation_acc=0.2, truncation_com=0.2),
    dict(down_sample_res=0.05, threshold=0.2, truncation_acc=0.4, truncation_com=2.0,
         gt_bbx_mask_on=False),
    dict(down_sample_res=0.0, threshold=0.1, truncation_acc=0.2, truncation_com=2.0),
])
def test_eval_mesh_equals_jax(tmp_path, kw):
    mesh_path, gt_path = _sphere_mesh_files(tmp_path)
    got = metrics.eval_mesh(mesh_path, gt_path, mesh_sample_point=50_000, **kw)
    want = jmetrics.eval_mesh(mesh_path, gt_path, mesh_sample_point=50_000, **kw)
    assert got == want
    assert 0 < got["F-score (%)"] <= 100


def test_crop_intersection_equals_jax(tmp_path):
    mesh_path, gt_path = _sphere_mesh_files(tmp_path)
    metrics.crop_intersection(gt_path, [mesh_path], str(tmp_path / "p.ply"), 0.1, 20_000)
    jmetrics.crop_intersection(gt_path, [mesh_path], str(tmp_path / "j.ply"), 0.1, 20_000)
    got = io.read_point_cloud(str(tmp_path / "p.ply")).points
    np.testing.assert_array_equal(got, jio.read_point_cloud(str(tmp_path / "j.ply")).points)
    assert 25000 < len(got) <= 30000  # the far points are cut


def test_eval_depth_equals_jax():
    rng = np.random.default_rng(4)
    gt = rng.uniform(0.5, 12, (40, 50))
    pred = np.where(rng.random((40, 50)) < 0.1, 0.0, gt * rng.uniform(0.8, 1.3, (40, 50)))
    assert metrics.eval_depth(pred, gt) == jmetrics.eval_depth(pred, gt)


def test_evaluator_cli(tmp_path):
    """``python -m shine_mapping_tpu_torch.eval.evaluator`` scores a mesh and
    appends its CSV row."""
    import subprocess
    import sys

    mesh_path, gt_path = _sphere_mesh_files(tmp_path)
    out = tmp_path / "res.csv"
    res = subprocess.run(
        [sys.executable, "-m", "shine_mapping_tpu_torch.eval.evaluator", mesh_path, gt_path,
         "--dataset", "ncd", "--mesh_sample_point", "20000", "--out", str(out)],
        capture_output=True, text=True, timeout=120,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert res.returncode == 0, res.stderr
    assert "F-score (%)" in res.stdout
    rows = out.read_text().splitlines()
    assert len(rows) == 2 and rows[0].startswith("mesh,")
