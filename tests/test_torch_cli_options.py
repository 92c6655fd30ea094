"""The port's batch CLI with each single-card training option of the JAX
trainer, end to end on the CPU on a 2-frame world of tests/synth.py
(tests/test_torch_cli.py's config at 60 steps): the run finishes with
finite losses, logs each term it trains, writes its mesh, and with
``time_conditioned`` one mesh per even frame, queried at that frame's
timestamp as the JAX mesher queries it (sdf rtol 1e-5, masks equal).  Their
trajectories are held to the JAX package's by tests/test_torch_options*.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests import synth
from tests.test_torch_cli import _one_thread, port_cfg  # noqa: F401  (fixture)

ITERS = 60


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_opts"))
    synth.make_kitti_dataset(root, n_frames=2)
    return root


CASES = {
    "sparse": (dict(feature_update="sparse"), ()),
    "dense": (dict(feature_update="dense"), ()),
    "sgd": (dict(opt_adam=False, lr=0.05), ()),
    "sort_batch": (dict(sort_batch=True), ()),
    "dr_neus": (dict(ray_loss=True, main_loss_type="dr_neus", bs=256), ()),
    "normal_consistency_proj_l1": (
        dict(estimate_normal=True, normal_loss_on=True, consistency_loss_on=True,
             proj_correction_on=True, main_loss_type="sdf_l1", consistency_count=256),
        ("normal_loss", "consistency_loss")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_cli_runs_option(world, tmp_path, case):
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch

    kw, terms = CASES[case]
    cfg = port_cfg(world, str(tmp_path), iters=ITERS, vis_freq_iters=ITERS, **kw)
    run_path, grid, params = run_shine_mapping_batch(cfg=cfg)
    with open(run_path + "/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    for t in ("total_loss",) + terms:
        assert all(np.isfinite(r["loss/" + t]) for r in recs), t
    assert os.path.exists(os.path.join(run_path, f"mesh/mesh_iter_{ITERS}.ply"))
    assert all(torch.isfinite(f).all() for f in params["features"])


def test_time_conditioned_batch_cli_meshes_every_even_frame(world, tmp_path):
    from shine_mapping_tpu.mesher import Mesher as JaxMesher
    from shine_mapping_tpu.ops.hashgrid import HashGridHost as JaxGrid
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
    from shine_mapping_tpu_torch.interop import params_to_jax
    from shine_mapping_tpu_torch.mesher import Mesher

    cfg = port_cfg(world, str(tmp_path), iters=ITERS, vis_freq_iters=ITERS,
                   time_conditioned=True)
    run_path, grid, params = run_shine_mapping_batch(cfg=cfg)
    assert params["geo"].layers[0].in_features == cfg.feature_dim + 1
    assert sorted(os.listdir(os.path.join(run_path, "mesh"))) == [f"mesh_iter_{ITERS}_ts_0.ply"]
    jm = JaxMesher(cfg, JaxGrid.from_state_dict(grid.state_dict()), params_to_jax(params)["geo"])
    m = Mesher(cfg, grid, params["geo"])
    pts = np.random.default_rng(0).uniform(-0.05, 0.05, (4000, 3)).astype(np.float32)
    sdf = {}
    for ts in (0, 1):
        jm.ts = m.ts = ts
        sj, _, mj = jm.query_points(pts, 1024)
        sdf[ts], _, mask = m.query_points(pts, 1024)
        np.testing.assert_array_equal(mask, mj)
        np.testing.assert_allclose(sdf[ts], sj, rtol=1e-5, atol=1e-6)
    assert mask.any() and not np.array_equal(sdf[0][mask], sdf[1][mask])
