"""The incremental driver over two ranks (gloo, CPU) on tests/synth.py's
KITTI-layout world, with tests/test_torch_incre_cli.py's settings.

Two ranks (one spawn, ``tests/test_torch_dist_ranks.py::incre_runs``) run
the port's incremental CLI three times: the continual reg on replicated
tables with per-frame fused windows and bf16 moments (the windows' preps
sorted for the update's deterministic sum, the reg folded with the whole
batch's owner flags), the reg on row-sharded tables (iid batches routed
live each step, the grown tables cut into row blocks again every frame),
and window replay on replicated tables.  Held:

* the replicated runs' tables, moments and decoders bit-identical on both
  ranks after every frame, and every run's importance tables after every
  sweep (the sweep splits its batches over the ranks and adds their sums
  in rank order);
* each final mesh (3 of the world's 5 frames at 30 steps, marching cubes at
  0.2 m) F-score within 5 points of the one-rank port run of the same
  config, and the row-sharded reg run's within 5 points of the JAX
  driver's run of its config on the same world (one JAX run, as in
  tests/test_torch_incre_cli.py);
* ``reg_loss`` logged and non-zero after frame 0 (``loss_reduction: sum``
  over the ranks: each rank's part added, the whole batch's sum);
* the importance sweep over two ranks against one rank's on the same map
  and pool (rtol 1e-5), bit-identical on both ranks.
"""

import os

import numpy as np
import pytest
import torch

from shine_mapping_tpu_torch.cli.common import build_grid
from shine_mapping_tpu_torch.data.dataset import LiDARDataset
from tests.test_torch_dist_ranks import incre_runs, spawn
from tests.test_torch_incre_cli import (_one_thread, incre_cfg, port_cfg, records,  # noqa: F401
                                        score, world)
from tests.test_e2e import small_cfg

FRAMES = 3  # of the world's 5
MESH = f"mesh/mesh_frame_{FRAMES}.ply"
CUT = dict(end_frame=FRAMES - 1, mesh_freq_frame=FRAMES, freeze_after_frame=2, mc_res_m=0.2)
ITERS = 30  # of tests/test_torch_incre_cli.py's 60 a frame
RUNS = (
    ("reg_windows", "reg", dict(iters=ITERS, lambda_forget=1e3, batch_windows=True,
                                windows_fused=True, feature_update="pallas",
                                moments_bf16=True)),
    ("reg_rows", "reg", dict(iters=ITERS, table_sharding="rows")),
    ("replay", "replay", dict(iters=ITERS)),
)


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """Each config on two ranks and on one (one spawn: the one-rank runs
    shared out over the two processes)."""
    root, gt_path = world
    cfgs, one_cfgs = [], []
    for label, mode, kw in RUNS:  # on one rank reg_rows is the iid reg run
        for out, tag in ((cfgs, "two_"), (one_cfgs, "one_")):
            out.append((label, port_cfg(root, str(tmp_path_factory.mktemp(tag + label)), mode,
                                        **kw, **CUT)))
    cfg = cfgs[0][1]
    ds = LiDARDataset(cfg, build_grid(cfg))
    for f in ds.frame_ids():
        ds.process_frame(f)
    pool = (ds.pool.coord.astype(np.float32), ds.pool.sdf_label.astype(np.float32))
    out = str(tmp_path_factory.mktemp("dist_incre") / "out.pt")
    spawn(incre_runs, cfgs, one_cfgs, pool, out)
    two = torch.load(out, weights_only=False)
    return two, two["one"], gt_path


@pytest.fixture(scope="module")
def jax_reg(world, tmp_path_factory):
    """The JAX driver's run of the iid reg config: its final mesh's F-score."""
    from shine_mapping_tpu.cli.shine_incre import run_shine_mapping_incremental as jax_run

    root, gt_path = world
    cfg = incre_cfg(small_cfg(root, str(tmp_path_factory.mktemp("jax_reg"))), "reg")
    for k, v in dict(CUT, iters=ITERS).items():
        setattr(cfg, k, v)
    run_path, _, _ = jax_run(cfg=cfg)
    return score(os.path.join(run_path, MESH), gt_path)["F-score (%)"]


@pytest.mark.parametrize("label", [r[0] for r in RUNS])
def test_two_rank_incremental_driver(runs, jax_reg, label):
    two, one, gt_path = runs
    got = two[label]
    recs = records(got["run_path"])
    assert [r["frame"] for r in recs] == list(range(FRAMES))
    assert all(np.isfinite(r["loss/total_loss"]) for r in recs)
    if label.startswith("reg"):
        assert recs[0]["loss/reg_loss"] == 0.0  # importance is zero before frame 0's sweep
        assert all(r["loss/reg_loss"] > 0 for r in recs[1:])
        assert got["importance"] == [True] * FRAMES, "the ranks' importance parted"
    if label != "reg_rows":
        assert got["replicas"] == [True] * FRAMES, "the replicas parted"
    assert os.path.exists(os.path.join(got["run_path"], "model", "model_final.npz"))
    f2 = score(os.path.join(got["run_path"], MESH), gt_path)["F-score (%)"]
    f1 = score(os.path.join(one[label], MESH), gt_path)["F-score (%)"]
    print(label, "two ranks", round(f2, 3), "one rank", round(f1, 3), "JAX reg", round(jax_reg, 3))
    assert abs(f2 - f1) < 5.0, (f2, f1)
    if label == "reg_rows":
        assert abs(f2 - jax_reg) < 5.0, (f2, jax_reg)


def test_importance_over_ranks_matches_one_rank(runs):
    """The sweep's batches split over two ranks, their sums added in rank
    order: the one-rank sweep's tables within rtol 1e-5, the same bits on
    both ranks, the trashbin rows zero."""
    two, _, _ = runs
    imp = two["importance"]
    assert imp["replicas"]
    for a, b in zip(imp["ranks"], imp["one"]):
        assert float(b.max()) > 0
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-12)
        assert float(a[-1].abs().max()) == 0.0
