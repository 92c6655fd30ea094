"""The port's incremental driver (shine_mapping_tpu_torch/cli/shine_incre.py)
end to end on the CPU with continual learning, on tests/synth.py's
KITTI-layout world (5 frames) with tests/test_e2e.py::small_cfg's settings
and ``setting.device: cpu``.

The bar: the final mesh's F-score within 5 points of the JAX driver's on
the same world and config (one JAX run, shared by the module; measured on
this world: 77.1 against 80.2, and 76-82 for either package over four
seeds).  tests/test_torch_incre_replay.py does the same for window replay."""

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
from shine_mapping_tpu_torch.train import trainer
from tests import synth
from tests.test_e2e import small_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 5
MESH = f"mesh/mesh_frame_{FRAMES}.ply"  # the last frame's mesh


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def incre_cfg(cfg, mode: str):
    """tests/test_e2e.py::small_cfg with the reg or the replay run's
    settings: 60 steps a frame, a dense-bbx mesh at frame 0 and at the last
    frame."""
    cfg.iters = 60
    cfg.mesh_freq_frame = FRAMES
    if mode == "reg":
        cfg.continual_learning_reg = True
        cfg.freeze_after_frame = 3
    else:
        cfg.window_replay_on = True
        cfg.window_radius = 15.0
        cfg.ekional_loss_on = True
    return cfg


def port_cfg(root: str, out: str, mode: str, **kw) -> SHINEConfig:
    cfg = SHINEConfig(**dataclasses.asdict(small_cfg(root, out)))
    cfg.device = "cpu"
    incre_cfg(cfg, mode)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_kitti"))
    synth.make_kitti_dataset(root, n_frames=FRAMES)
    gt_path = os.path.join(root, "gt.ply")
    io.write_ply(gt_path, io.PointCloud(points=synth.gt_surface_points(100_000)))
    return root, gt_path


def score(mesh_path, gt_path):
    return eval_mesh(mesh_path, gt_path, down_sample_res=0.05, threshold=0.2,
                     truncation_acc=0.4, truncation_com=2.0, mesh_sample_point=300_000)


def jax_run(world, tmp_path_factory, mode):
    """The JAX driver on the world: (run path, final mesh F-score)."""
    from shine_mapping_tpu.cli.shine_incre import run_shine_mapping_incremental

    root, gt_path = world
    cfg = incre_cfg(small_cfg(root, str(tmp_path_factory.mktemp("jax_" + mode))), mode)
    run_path, _, _ = run_shine_mapping_incremental(cfg=cfg)
    return run_path, score(os.path.join(run_path, MESH), gt_path)["F-score (%)"]


def records(run_path):
    with open(run_path + "/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def watch_chunks(monkeypatch):
    """Wrap the trainer's train_chunk as the driver calls it: a frozen
    chunk leaves the decoders bit for bit, no chunk moves the last-frame
    snapshot.  Returns the list of chunks seen, (frozen, reg) each."""
    seen = []
    inner = trainer.train_chunk

    def wrapped(params, *args, **kw):
        s = args[6]
        dec = {(g, n): t.clone() for g in ("geo", "sem")
               for n, t in params[g].state_dict().items()}
        last = kw["shadow"]["last_frame"] if kw.get("shadow") else []
        last0 = [t.clone() for t in last]
        out = inner(params, *args, **kw)
        if s.freeze_decoder:
            for (g, n), t in dec.items():
                assert torch.equal(params[g].state_dict()[n], t), f"{g}.{n} moved frozen"
        for a, b in zip(last0, last):
            assert torch.equal(a, b), "training moved the last-frame snapshot"
            assert all(b.data_ptr() != f.data_ptr() for f in params["features"])
        seen.append((s.freeze_decoder, s.continual_reg_on))
        return out

    monkeypatch.setattr(trainer, "train_chunk", wrapped)
    return seen


@pytest.fixture(scope="module")
def jax_reg(world, tmp_path_factory):
    return jax_run(world, tmp_path_factory, "reg")


def test_incre_reg_matches_jax_quality(world, jax_reg, tmp_path, monkeypatch):
    import jax

    from shine_mapping_tpu.cli.common import build_grid as jax_build_grid
    from shine_mapping_tpu.train import trainer as jtrainer
    from shine_mapping_tpu.train.optimizer import init_opt_state as jax_init_opt_state
    from shine_mapping_tpu.utils import checkpoint as jckpt
    from shine_mapping_tpu_torch.cli.shine_incre import run_shine_mapping_incremental
    from shine_mapping_tpu_torch.utils import checkpoint as ckpt

    root, gt_path = world
    seen = watch_chunks(monkeypatch)
    cfg = port_cfg(root, str(tmp_path), "reg")
    run_path, grid, params = run_shine_mapping_incremental(cfg=cfg)
    assert seen == [(f >= 3, True) for f in range(FRAMES)]
    assert float(grid.importance_weight[0].max()) > 0
    assert all(float(w[-1].abs().max()) == 0 for w in grid.importance_weight)
    recs = records(run_path)
    assert [r["frame"] for r in recs] == list(range(FRAMES))
    assert recs[0]["loss/reg_loss"] == 0.0  # importance is zero before frame 0's sweep
    assert all(r["loss/reg_loss"] > 0 for r in recs[1:])
    assert all(np.isfinite(r["loss/total_loss"]) for r in recs)
    for k in ("preprocess", "mapping", "importance", "reconstruct"):
        assert all(r[f"timing(s)/{k}"] >= 0 for r in recs), k
    # the JAX driver's records carry the same losses
    assert {k for k in records(jax_reg[0])[1] if k.startswith("loss/")} == \
        {k for k in recs[1] if k.startswith("loss/")}
    m = score(os.path.join(run_path, MESH), gt_path)
    print({k: round(v, 4) for k, v in m.items()}, "JAX F-score", jax_reg[1])
    assert abs(m["F-score (%)"] - jax_reg[1]) < 5.0, (m["F-score (%)"], jax_reg[1])
    # model_final.npz loads in both packages, with the importance it saved
    path = os.path.join(run_path, "model", "model_final.npz")
    skeleton = trainer.init_params(cfg, grid)
    grid2, params2, _, iters = ckpt.load_checkpoint(path, skeleton, device="cpu")
    assert iters == FRAMES * cfg.iters and grid2.corner_counts == grid.corner_counts
    assert torch.equal(grid2.importance_weight[0], grid.importance_weight[0])
    jcfg = incre_cfg(small_cfg(root, str(tmp_path)), "reg")
    like = jtrainer.init_params(jcfg, jax_build_grid(jcfg), jax.random.PRNGKey(0))
    jgrid, jparams, _, jiters = jckpt.load_checkpoint(path, like, jax_init_opt_state(like))
    assert jiters == iters
    np.testing.assert_array_equal(np.asarray(jgrid.features[0]), grid.features[0].numpy())
    np.testing.assert_array_equal(np.asarray(jgrid.importance_weight[0]),
                                  grid.importance_weight[0].numpy())
    np.testing.assert_array_equal(np.asarray(jparams["geo"]["w0"]),
                                  params["geo"].layers[0].weight.detach().numpy().T)


def test_incre_reg_on_fused_windows(world, tmp_path, monkeypatch, capsys):
    """The work-ratio gate forced open (as tests/test_e2e.py does for the
    JAX driver): per-frame fused windows with the reg's owner flags, bf16
    moments, importance accumulated."""
    from shine_mapping_tpu_torch.cli import shine_incre

    root, _ = world
    monkeypatch.setattr(shine_incre, "PRECOMPUTE_WORK_RATIO", 0.0)
    seen = watch_chunks(monkeypatch)
    cfg = port_cfg(root, str(tmp_path), "reg", iters=30, end_frame=3, lambda_forget=1e3,
                   batch_windows=True, windows_fused=True, feature_update="pallas",
                   moments_bf16=True)
    run_path, grid, _ = shine_incre.run_shine_mapping_incremental(cfg=cfg)
    assert "with reg fold" in capsys.readouterr().out
    assert float(grid.importance_weight[0].max()) > 0
    recs = records(run_path)
    assert len(seen) == len(recs) < FRAMES
    assert all(np.isfinite(r["loss/total_loss"]) for r in recs)
    assert all(r["loss/reg_loss"] > 0 for r in recs[1:])


def test_incre_module_entry_point(world, tmp_path):
    """``python -m shine_mapping_tpu_torch.cli.shine_incre <cfg.yaml>`` on the
    repo's MaiCity reg YAML with ``setting.device: cpu`` (2 frames)."""
    import yaml

    root, _ = world
    src = yaml.safe_load(open(os.path.join(REPO, "config/maicity/maicity_incre_reg.yaml")))
    src["setting"].update(name="synth", output_root=str(tmp_path), device="cpu", end_frame=2,
                          pc_path=os.path.join(root, "velodyne"),
                          pose_path=os.path.join(root, "poses.txt"),
                          calib_path=os.path.join(root, "calib.txt"))
    src["process"].update(pc_radius_m=20.0, min_range_m=0.5)
    src["optimizer"].update(iters=10, batch_size=1024)
    src["eval"].update(mc_res_m=0.3)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(src))
    res = subprocess.run([sys.executable, "-m", "shine_mapping_tpu_torch.cli.shine_incre",
                          str(path)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "frame 1: loss" in res.stdout
    runs = [d for d in os.listdir(tmp_path) if d.startswith("synth_")]
    assert len(runs) == 1
    assert os.path.exists(tmp_path / runs[0] / "model" / "model_final.npz")
    assert os.path.exists(tmp_path / runs[0] / "mesh" / "mesh_frame_1.ply")


def test_incre_needs_a_card_unless_the_config_says_cpu(world, tmp_path, monkeypatch):
    from shine_mapping_tpu_torch.cli.shine_incre import run_shine_mapping_incremental

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _ = world
    with pytest.raises(RuntimeError, match="setting.device: cpu"):
        run_shine_mapping_incremental(cfg=port_cfg(root, str(tmp_path), "reg", device="cuda"))


@pytest.mark.parametrize("kw,item", [
    (dict(o3d_vis_on=True), "item 15"), (dict(mesh_shape=2), None),
    (dict(num_processes=2), "tpu.process_id and tpu.coordinator"),
    (dict(time_conditioned=True), None),
], ids=["o3d_vis_on", "data-parallel", "multi-host", "time_conditioned"])
def test_incre_unported_options_raise(world, tmp_path, monkeypatch, kw, item):
    """The options that raised before they were ported now run through:
    ``o3d_vis_on`` renders a snapshot of each frame into ``run_path/vis``
    (the visualizer without Open3D; 2 frames), ``mesh_shape: 2``
    spawns two ranks of the driver (their runs are
    tests/test_torch_dist_incre.py's), ``num_processes: 2`` joins ranks
    launched apart and asks for their coordinator (ValueError without it),
    a time-conditioned map trains (the replay mode on 2 frames: the
    importance sweep of the reg mode decodes without timestamps, in both
    packages)."""
    from shine_mapping_tpu_torch.cli import shine_incre
    from shine_mapping_tpu_torch.cli.shine_incre import run_shine_mapping_incremental

    root, _ = world
    if item == "item 15":
        cfg = port_cfg(root, str(tmp_path), "reg", end_frame=1, iters=20, **kw)
        run_path, _, _ = run_shine_mapping_incremental(cfg=cfg)
        assert sorted(os.listdir(os.path.join(run_path, "vis"))) == ["vis_0000.png",
                                                                     "vis_0001.png"]
        return
    if item is not None:
        with pytest.raises(ValueError, match=item):
            run_shine_mapping_incremental(cfg=port_cfg(root, str(tmp_path), "reg", **kw))
        return
    if "mesh_shape" in kw:
        spawned = []
        monkeypatch.setattr(shine_incre, "spawn_ranks",
                            lambda run, cfg, path, backend: spawned.append((run, cfg)) or "r0")
        assert run_shine_mapping_incremental(
            cfg=port_cfg(root, str(tmp_path), "reg", **kw)) == ("r0", None, None)
        assert spawned[0][0] is run_shine_mapping_incremental and spawned[0][1].mesh_shape == 2
        return
    cfg = port_cfg(root, str(tmp_path), "replay", end_frame=1, iters=20, **kw)
    run_path, _, params = run_shine_mapping_incremental(cfg=cfg)
    assert params["geo"].layers[0].in_features == cfg.feature_dim + 1
    recs = records(run_path)
    assert len(recs) == 2 and all(np.isfinite(r["loss/total_loss"]) for r in recs)
