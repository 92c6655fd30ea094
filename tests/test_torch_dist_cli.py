"""The batch driver over two ranks (gloo, CPU), and the pieces it adds.

* The driver with ``tpu.mesh_shape: 2`` (two spawned ranks),
  ``table_sharding: rows`` and the bf16 map mode (routed fused windows, K2's
  row-sharded caller with stochastic rounding): its final mesh within 5
  F-score points of the one-rank driver's on the same world and config,
  both over the JAX package's bars.
* On that run's rank-0 checkpoint, two ranks (one spawn): the sharded data
  phase bit-equal to a one-process data phase (pool and octree; the
  per-frame rng, ``data/dataset.py:221``), data-parallel meshing bit-equal
  to one rank's (masks and sdf), and the checkpoint loaded, cut into row
  blocks, gathered and written again bit-equal to the file, key by key.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from shine_mapping_tpu_torch.cli.common import build_grid
from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
from shine_mapping_tpu_torch.config import SHINEConfig
from shine_mapping_tpu_torch.data.dataset import LiDARDataset
from shine_mapping_tpu_torch.mesher import Mesher
from shine_mapping_tpu_torch.train import trainer
from shine_mapping_tpu_torch.train.optimizer import init_opt_state
from shine_mapping_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_cli import _score, port_cfg, world  # noqa: F401 (fixture)
from tests.test_torch_dist_ranks import data_map_ckpt, spawn

ITERS = 200


def _cfg(root, out, **kw):
    return port_cfg(root, out, feature_update="pallas", moments_bf16=True, batch_windows=True,
                    params_bf16=True, iters=ITERS, vis_freq_iters=ITERS, **kw)


@pytest.fixture(scope="module")
def two_runs(world, tmp_path_factory):
    """The one-rank driver and the two-rank row-sharded driver."""
    root, gt_path = world
    one, _, _ = run_shine_mapping_batch(cfg=_cfg(root, str(tmp_path_factory.mktemp("one"))))
    cfg2 = _cfg(root, str(tmp_path_factory.mktemp("two")), mesh_shape=2,
                table_sharding="rows", shard_ingest=True)
    two, grid, params = run_shine_mapping_batch(cfg=cfg2)
    assert grid is None and params is None  # the ranks' state stayed in the ranks
    mesh = f"mesh/mesh_iter_{ITERS}.ply"
    return (_score(os.path.join(one, mesh), gt_path), _score(os.path.join(two, mesh), gt_path),
            one, two, cfg2)


def test_two_rank_driver_within_5_points(two_runs):
    m1, m2, one, two, _ = two_runs
    print({k: round(v, 4) for k, v in m2.items()}, "one rank", m1["F-score (%)"])
    for m in (m1, m2):
        assert m["Chamfer_L1 (m)"] < 0.15, m
        assert m["F-score (%)"] > 75.0, m
    assert abs(m2["F-score (%)"] - m1["F-score (%)"]) < 5.0
    # rank 0 alone wrote the run directory
    assert os.path.exists(os.path.join(two, "model/model_final.npz"))
    assert not [d for d in os.listdir(os.path.dirname(two)) if "rank" in d]


def test_sharded_ingest_meshing_and_checkpoint(two_runs, tmp_path):
    _, _, _, two, cfg2 = two_runs
    cfg = SHINEConfig(**dataclasses.asdict(cfg2))
    cfg.mesh_shape = 1
    src = os.path.join(two, "model/model_final.npz")
    out = str(tmp_path / "ranks.pt")
    spawn(data_map_ckpt, cfg, src, out)
    got = torch.load(out, weights_only=False)

    ds = LiDARDataset(cfg, build_grid(cfg))
    ds.process_frames_pipelined(ds.frame_ids(), workers=2)
    for f, a in got["pool"].items():
        np.testing.assert_array_equal(a, getattr(ds.pool, f), err_msg=f)
    want = ds.grid.state_dict()
    assert want.keys() == got["octree"].keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got["octree"][k]), np.asarray(want[k]),
                                      err_msg=k)

    skeleton = trainer.init_params(cfg, build_grid(cfg))
    grid, params, _, _ = ckpt.load_checkpoint(src, skeleton, init_opt_state(skeleton),
                                              device="cpu")
    grid.cast_features(torch.bfloat16)
    sdf, _, mask = Mesher(cfg, grid, params["geo"]).query_grid_lattice(
        got["vox"], got["origin"], cfg.mc_res_m)
    np.testing.assert_array_equal(got["mask"], mask)
    np.testing.assert_array_equal(got["sdf"], sdf)

    a, b = np.load(src), np.load(got["ckpt"])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_rank_driver_rows_on_iid_batches(two_runs, world, tmp_path):
    """``table_sharding: rows`` without windows (``feature_update: fused``,
    iid batches routed live each step) through the batch CLI on two spawned
    ranks: the JAX package's bars, within 5 F-score points of the one-rank
    driver on the same world."""
    m1 = two_runs[0]
    root, gt_path = world
    cfg = port_cfg(root, str(tmp_path), feature_update="fused", iters=ITERS,
                   vis_freq_iters=ITERS, mesh_shape=2, table_sharding="rows")
    run_path, _, _ = run_shine_mapping_batch(cfg=cfg)
    m = _score(os.path.join(run_path, f"mesh/mesh_iter_{ITERS}.ply"), gt_path)
    print({k: round(v, 4) for k, v in m.items()}, "one rank", m1["F-score (%)"])
    assert m["Chamfer_L1 (m)"] < 0.15 and m["F-score (%)"] > 75.0, m
    assert abs(m["F-score (%)"] - m1["F-score (%)"]) < 5.0
