"""The port's batch CLI (shine_mapping_tpu_torch/cli/shine_batch.py) end to
end on the CPU, on tests/synth.py's KITTI-layout world with
tests/test_e2e.py::small_cfg's settings and ``setting.device: cpu``.

The bars are the JAX driver's own on this scene
(tests/test_e2e.py::test_batch_driver_end_to_end): Chamfer-L1 < 0.15 m and
F-score > 75 %; and the port's F-score within 5 points of the JAX driver's
on the same world and config (one JAX run, shared by the module)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shine_mapping_tpu_torch.config import SHINEConfig
from shine_mapping_tpu_torch.data import io
from shine_mapping_tpu_torch.eval.metrics import eval_mesh
from tests import synth
from tests.test_e2e import small_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's thread pools in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(root: str, out: str, **kw) -> SHINEConfig:
    cfg = SHINEConfig(**dataclasses.asdict(small_cfg(root, out)))
    cfg.device = "cpu"
    cfg.vis_freq_iters = cfg.iters  # one mesh, at the end
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_kitti"))
    synth.make_kitti_dataset(root, n_frames=5)
    gt_path = os.path.join(root, "gt.ply")
    io.write_ply(gt_path, io.PointCloud(points=synth.gt_surface_points(100_000)))
    return root, gt_path


def _score(mesh_path, gt_path):
    return eval_mesh(mesh_path, gt_path, down_sample_res=0.05, threshold=0.2,
                     truncation_acc=0.4, truncation_com=2.0, mesh_sample_point=300_000)


@pytest.fixture(scope="module")
def jax_fscore(world, tmp_path_factory):
    """The JAX driver on the same world and config: its final mesh's F-score."""
    from shine_mapping_tpu.cli.shine_batch import run_shine_mapping_batch

    root, gt_path = world
    cfg = small_cfg(root, str(tmp_path_factory.mktemp("jax_run")))
    cfg.vis_freq_iters = cfg.iters
    run_path, _, _ = run_shine_mapping_batch(cfg=cfg)
    return _score(f"{run_path}/mesh/mesh_iter_{cfg.iters}.ply", gt_path)["F-score (%)"]


def _records(run_path):
    with open(run_path + "/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_cli_end_to_end_matches_jax_quality(world, jax_fscore, tmp_path):
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch

    root, gt_path = world
    cfg = port_cfg(root, str(tmp_path))
    run_path, grid, params = run_shine_mapping_batch(cfg=cfg)
    for art in ("model/model_final.npz", "model/model_final_decoders.npz",
                "map/pc_map_down.ply", "metrics.jsonl", f"mesh/mesh_iter_{cfg.iters}.ply"):
        assert os.path.exists(os.path.join(run_path, art)), art
    rec = _records(run_path)[-1]
    assert rec["iter"] == cfg.iters
    assert "phase(s)/data" in rec and "phase(s)/train" in rec
    assert rec["phase(s)/train"] > 0 and rec["phase(s)/data"] > 0
    assert grid.features[0].device.type == "cpu"
    m = _score(os.path.join(run_path, f"mesh/mesh_iter_{cfg.iters}.ply"), gt_path)
    print({k: round(v, 4) for k, v in m.items()}, "JAX F-score", jax_fscore)
    assert m["Chamfer_L1 (m)"] < 0.15, m
    assert m["F-score (%)"] > 75.0, m
    assert abs(m["F-score (%)"] - jax_fscore) < 5.0, (m["F-score (%)"], jax_fscore)


def test_cli_bf16_map_mode(world, tmp_path, capsys):
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch

    root, gt_path = world
    cfg = port_cfg(root, str(tmp_path), feature_update="pallas", moments_bf16=True,
                   batch_windows=True, params_bf16=True, iters=200, vis_freq_iters=200)
    run_path, grid, params = run_shine_mapping_batch(cfg=cfg)
    out = capsys.readouterr().out
    assert "bf16 map mode" in out and "prerequisites unmet" not in out
    assert params["features"][0].dtype == torch.bfloat16
    assert grid.features[0] is params["features"][0]  # the mesher read the bf16 tables
    m = _score(os.path.join(run_path, f"mesh/mesh_iter_{cfg.iters}.ply"), gt_path)
    print({k: round(v, 4) for k, v in m.items()})
    assert m["Chamfer_L1 (m)"] < 0.15, m
    assert m["F-score (%)"] > 75.0, m


@pytest.mark.parametrize("windows", [False, True])
def test_cli_resume_from_full_checkpoint(world, tmp_path, windows):
    """A run stopped at its iter-50 checkpoint and resumed to 100 continues
    the uninterrupted run: moments, iteration and batches all carry on."""
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch

    root, _ = world
    kw = dict(iters=100, save_freq_iters=50, vis_freq_iters=0, scan_chunk=50,
              feature_update="pallas", moments_bf16=windows, batch_windows=windows)
    run_path, grid, params = run_shine_mapping_batch(cfg=port_cfg(root, str(tmp_path / "a"), **kw))
    cfg2 = port_cfg(root, str(tmp_path / "b"), load_model=True,
                    model_path=run_path + "/model/model_iter_50.npz", **kw)
    run_path2, grid2, params2 = run_shine_mapping_batch(cfg=cfg2)
    assert grid2.corner_counts == grid.corner_counts
    for k, t in params["geo"].state_dict().items():
        torch.testing.assert_close(params2["geo"].state_dict()[k], t, rtol=1e-4, atol=1e-5)
    for a, b in zip(params["features"], params2["features"]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)
    recs, recs2 = _records(run_path), _records(run_path2)
    assert [r["iter"] for r in recs2] == [100]
    np.testing.assert_allclose(recs2[0]["loss/total_loss"], recs[-1]["loss/total_loss"],
                               rtol=1e-4)


def test_cli_pool_rotation(world, tmp_path, capsys):
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch

    root, _ = world
    cfg = port_cfg(root, str(tmp_path), iters=120, scan_chunk=40, vis_freq_iters=0,
                   max_device_pool=1 << 14, pool_rotate_iters=40)
    run_path, _, _ = run_shine_mapping_batch(cfg=cfg)
    assert "rotating" in capsys.readouterr().out
    losses = [r["loss/total_loss"] for r in _records(run_path)]
    assert len(losses) == 3 and np.isfinite(losses[-1]) and losses[-1] < losses[0]
    assert [r["phase(s)/rotate"] > 0 for r in _records(run_path)[1:]] == [True, True]


def test_cli_profile_trace(world, tmp_path):
    """``tpu.profile_dir``: a torch.profiler trace of one steady-state chunk,
    with the ``train`` phase and its 30 steps' stage spans as annotations
    (tracing on for the traced chunk only)."""
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
    from shine_mapping_tpu_torch.utils import profiling

    root, _ = world
    trace_dir = str(tmp_path / "profout")
    try:
        run_shine_mapping_batch(cfg=port_cfg(root, str(tmp_path), iters=60, scan_chunk=30,
                                             vis_freq_iters=0, profile_dir=trace_dir))
        assert profiling.tracing(False) is False
    finally:
        profiling.clear_spans()
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("train") == names.count("chunk") == 1
    for n in ("step", "step.forward", "step.backward", "step.update"):
        assert names.count(n) == 30, n


def test_cli_needs_a_card_unless_the_config_says_cpu(world, tmp_path, monkeypatch):
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _ = world
    with pytest.raises(RuntimeError, match="setting.device: cpu"):
        run_shine_mapping_batch(cfg=port_cfg(root, str(tmp_path), device="cuda"))
    assert SHINEConfig().device == "cuda"


def test_cli_module_entry_point(world, tmp_path):
    """``python -m shine_mapping_tpu_torch.cli.shine_batch <cfg.yaml>`` on a
    YAML of the repo's schema with ``setting.device: cpu``."""
    import yaml

    root, _ = world
    src = yaml.safe_load(open(os.path.join(REPO, "config/maicity/maicity_batch.yaml")))
    src["setting"].update(name="synth", output_root=str(tmp_path), device="cpu",
                          pc_path=os.path.join(root, "velodyne"),
                          pose_path=os.path.join(root, "poses.txt"),
                          calib_path=os.path.join(root, "calib.txt"), first_frame_ref=False)
    src["process"].update(pc_radius_m=20.0, min_range_m=0.5)
    src["optimizer"].update(iters=20, batch_size=1024)
    src["eval"].update(vis_freq_iters=20, save_freq_iters=20, mc_res_m=0.3)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(src))
    res = subprocess.run([sys.executable, "-m", "shine_mapping_tpu_torch.cli.shine_batch",
                          str(path)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "iter 20/20" in res.stdout and "mesh:" in res.stdout
    runs = [d for d in os.listdir(tmp_path) if d.startswith("synth_")]
    assert len(runs) == 1
    assert os.path.exists(tmp_path / runs[0] / "cfg.yaml")
    assert os.path.exists(tmp_path / runs[0] / "model" / "model_final.npz")
