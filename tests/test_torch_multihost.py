"""Processes launched apart through the config's knobs (the port's
counterpart of tests/test_multihost.py), the batch CLI.

``tpu.num_processes`` counts processes, as JAX's hosts: each runs
``tpu.mesh_shape / num_processes`` local ranks (or one a card it sees), and
the world is every rank of every process (``parallel.mesh.launch_plan``).
Two independent processes, each with ``num_processes: 2``, ``mesh_shape:
4``, its own ``process_id`` and a coordinator on a free localhost port,
spawn two gloo CPU ranks each on 3 frames of tests/synth.py at
tests/test_multihost.py's sizes.  They form 4 ranks, and their final
checkpoint is bit-equal to a one-process ``mesh_shape: 4`` spawn of the same
config: the ranks' sums are gathered and added in rank order
(``parallel.comm``), so the two launches sum in the same order.  Rank 0
alone writes the run directory, and both calls return its path.  A config
that cannot be met raises ValueError before any group forms.

tests/test_torch_multihost_incre.py does the same for the incremental CLI.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from shine_mapping_tpu_torch.parallel.mesh import free_port
from tests import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300  # s, each process

# one process of a launch; the main guard keeps the spawned ranks (start
# method spawn re-imports this file) from running it again
_CHILD = r'''
import sys

def main():
    cli, root, out, procs, pid, port, shape = sys.argv[1:8]
    import torch
    torch.set_num_threads(1)
    from shine_mapping_tpu_torch.config import SHINEConfig

    cfg = SHINEConfig()
    cfg.name, cfg.output_root, cfg.device = "mh", out, "cpu"
    cfg.pc_path, cfg.pose_path = root + "/velodyne", root + "/poses.txt"
    cfg.calib_path = root + "/calib.txt"
    cfg.begin_frame, cfg.end_frame, cfg.every_frame = 0, 100, 1
    cfg.first_frame_ref = False
    cfg.pc_radius, cfg.min_range, cfg.min_z = 20.0, 0.5, -3.0
    cfg.rand_downsample, cfg.vox_down_m = False, 0.12
    cfg.tree_level_world, cfg.tree_level_feat, cfg.leaf_vox_size = 9, 3, 0.5
    cfg.bs, cfg.lr, cfg.scan_chunk = 1024, 0.02, 30
    cfg.save_freq_iters = cfg.vis_freq_iters = 0
    cfg.surface_sample_n, cfg.free_sample_n = 3, 2
    cfg.o3d_vis_on = cfg.wandb_vis_on = False
    cfg.continual_learning_reg = cfg.window_replay_on = False
    cfg.init_node_capacity = cfg.init_corner_capacity = 1 << 13
    cfg.init_pool_capacity = 1 << 17
    cfg.mc_res_m = 0.3
    if cli == "batch":
        from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch as run
        cfg.iters, cfg.mesh_freq_frame = 60, 1000
    else:
        from shine_mapping_tpu_torch.cli.shine_incre import (
            run_shine_mapping_incremental as run)
        cfg.iters, cfg.mesh_freq_frame = 20, 1000
        cfg.continual_learning_reg, cfg.freeze_after_frame = True, 2
    # the launch (the knobs under test)
    cfg.num_processes, cfg.process_id = int(procs), int(pid)
    cfg.coordinator = f"localhost:{port}" if int(port) else ""
    cfg.mesh_shape = int(shape)
    cfg.derive()
    run_path, grid, params = run(cfg=cfg)
    print("CHILD_DONE", pid, run_path, grid is None, flush=True)

if __name__ == "__main__":
    main()
'''


def launch(cli, root, out, tmp, procs, shape):
    """``procs`` processes of the ``cli`` driver (batch or incre), each with
    ``num_processes: procs``, ``mesh_shape: shape`` and its own
    ``process_id``, started together; returns their outputs.  Each gets
    TIMEOUT; on a timeout every process group started here is killed."""
    script = os.path.join(tmp, "child.py")
    with open(script, "w") as f:
        f.write(_CHILD)
    port = free_port() if procs > 1 else 0
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    ps = [subprocess.Popen([sys.executable, script, cli, root, out, str(procs), str(k),
                            str(port), str(shape)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO,
                           start_new_session=True)
          for k in range(procs)]
    outs = []
    try:
        for p in ps:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    finally:
        for p in ps:  # the process and the ranks it spawned, by its group id
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for k, (p, text) in enumerate(zip(ps, outs)):
        assert p.returncode == 0, f"process {k} failed:\n{text[-3000:]}"
        assert f"CHILD_DONE {k} " in text, text[-3000:]
    return outs


def check_launch(cli, tmp_path):
    """The two processes against the one-process spawn (module doc)."""
    root = str(tmp_path / "world")
    synth.make_kitti_dataset(root, n_frames=3)
    two, one = str(tmp_path / "two"), str(tmp_path / "one")
    outs = launch(cli, root, two, str(tmp_path), 2, 4)
    ref = launch(cli, root, one, str(tmp_path), 1, 4)

    assert "4 ranks over gloo" in outs[0], outs[0][-3000:]
    assert "4 ranks over gloo" in ref[0]
    runs = os.listdir(two)
    assert len(runs) == 1, runs  # rank 0's run directory alone
    run = os.path.join(two, runs[0])
    for text in outs:  # every process's call returns rank 0's run path
        line = next(ln for ln in text.splitlines() if ln.startswith("CHILD_DONE"))
        assert line.split()[2:] == [run, "True"], line
    ref_run = os.path.join(one, os.listdir(one)[0])
    assert sorted(os.listdir(run)) == sorted(os.listdir(ref_run))

    a = np.load(os.path.join(run, "model", "model_final.npz"))
    b = np.load(os.path.join(ref_run, "model", "model_final.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    with open(os.path.join(run, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss/total_loss"] for line in f]
    assert all(np.isfinite(losses))
    return losses


def test_two_processes_form_four_ranks_batch(tmp_path):
    losses = check_launch("batch", tmp_path)
    assert len(losses) == 2 and losses[-1] < losses[0], losses


def _cfg(tmp_path, **kw):
    from shine_mapping_tpu_torch.config import SHINEConfig

    root = str(tmp_path / "world")
    synth.make_kitti_dataset(root, n_frames=1)
    cfg = SHINEConfig()
    cfg.device, cfg.output_root = "cpu", str(tmp_path / "out")
    cfg.pc_path, cfg.pose_path = root + "/velodyne", root + "/poses.txt"
    cfg.calib_path = root + "/calib.txt"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize("kw,backend,match", [
    (dict(num_processes=2, process_id=0, coordinator="localhost:1", mesh_shape=3), None,
     "not a multiple"),
    (dict(num_processes=2, process_id=0, mesh_shape=4), None, "tpu.coordinator"),
    (dict(num_processes=2, process_id=2, coordinator="localhost:1"), None, "process_id"),
    (dict(num_processes=2, process_id=1, coordinator="localhost:1", mesh_shape=4), "nccl",
     "NCCL takes one card a rank"),
], ids=["mesh_shape-3-over-2", "no-coordinator", "process_id-out-of-range", "nccl-no-cards"])
@pytest.mark.parametrize("cli", ["batch", "incre"])
def test_launch_that_cannot_be_met_raises(tmp_path, cli, kw, backend, match):
    """ValueError before any group forms (and before the run directory)."""
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
    from shine_mapping_tpu_torch.cli.shine_incre import run_shine_mapping_incremental

    run = run_shine_mapping_batch if cli == "batch" else run_shine_mapping_incremental
    cfg = _cfg(tmp_path, **kw)
    with pytest.raises(ValueError, match=match):
        run(cfg=cfg, backend=backend)
    assert not dist.is_initialized()
    assert not os.path.exists(cfg.output_root)


def test_launch_plan_counts_ranks_as_jax_counts_devices(monkeypatch):
    """P processes x L local ranks: L = mesh_shape / P, else the cards a
    process sees, else 1 on the CPU; global rank process_id x L + i;
    torchrun's environment one rank a process; one process of mesh_shape
    ranks on a free port."""
    import torch

    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.parallel.mesh import launch_plan

    def cfg(**kw):
        c = SHINEConfig()
        c.device = "cpu"
        for k, v in kw.items():
            setattr(c, k, v)
        return c

    knobs = dict(num_processes=2, process_id=1, coordinator="host0:29500")
    p = launch_plan(cfg(mesh_shape=8, **knobs))
    assert (p.local, p.world, p.rank(0), p.rank(3), p.init_method, p.backend) == (
        4, 8, 4, 7, "tcp://host0:29500", "gloo")
    assert launch_plan(cfg(**knobs)).local == 1  # the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    p = launch_plan(cfg(device="cuda", **knobs))
    assert (p.local, p.world, p.rank(0), p.backend) == (4, 8, 4, "nccl")
    p = launch_plan(cfg(device="cuda", mesh_shape=16, **knobs))
    assert (p.local, p.backend) == (8, "gloo")  # more ranks than cards share them
    assert launch_plan(cfg(mesh_shape=1)) is None
    p = launch_plan(cfg(mesh_shape=3))
    assert (p.processes, p.local, p.world) == (1, 3, 3)
    assert p.init_method.startswith("tcp://localhost:")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert launch_plan(cfg(mesh_shape=3)) is None


def test_one_rank_a_process_joins_without_spawning(tmp_path):
    """``mesh_shape`` equal to ``num_processes``: one local rank a
    process, so each process joins the group itself (``cli.common.
    join_ranks``) and spawns nothing; 2 ranks, rank 0's run directory
    alone, and both calls return its path."""
    root = str(tmp_path / "world")
    synth.make_kitti_dataset(root, n_frames=1)
    out = str(tmp_path / "two")
    outs = launch("batch", root, out, str(tmp_path), 2, 2)
    assert "2 ranks over gloo" in outs[0], outs[0][-3000:]
    runs = os.listdir(out)
    assert len(runs) == 1, runs
    run = os.path.join(out, runs[0])
    for text in outs:
        line = next(ln for ln in text.splitlines() if ln.startswith("CHILD_DONE"))
        assert line.split()[2:] == [run, "False"], line  # the rank's own grid
    assert os.path.exists(os.path.join(run, "model", "model_final.npz"))
