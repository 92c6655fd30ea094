"""The port's incremental driver with continual learning on the lazy Adam
update (``feature_update: sparse``: the reg on each batch's unique touched
rows, the importance sweep after every frame) end to end on the CPU,
against the JAX driver on the same world and config: the final mesh's
F-score within 5 points, as tests/test_torch_incre_cli.py holds the kernel
update's reg run.  The world, config and scoring are that file's."""

import os

import numpy as np
import pytest

from tests.test_e2e import small_cfg
from tests.test_torch_incre_cli import (  # noqa: F401
    MESH, _one_thread, incre_cfg, port_cfg, records, score, watch_chunks, world)


@pytest.fixture(scope="module")
def jax_sparse(world, tmp_path_factory):
    from shine_mapping_tpu.cli.shine_incre import run_shine_mapping_incremental

    root, gt_path = world
    cfg = incre_cfg(small_cfg(root, str(tmp_path_factory.mktemp("jax_sparse"))), "reg")
    cfg.feature_update = "sparse"
    run_path, _, _ = run_shine_mapping_incremental(cfg=cfg)
    return run_path, score(os.path.join(run_path, MESH), gt_path)["F-score (%)"]


def test_incre_sparse_reg_matches_jax_quality(world, jax_sparse, tmp_path, monkeypatch):
    from shine_mapping_tpu_torch.cli.shine_incre import run_shine_mapping_incremental
    from shine_mapping_tpu_torch.ops import adam_kernel

    root, gt_path = world
    seen = watch_chunks(monkeypatch)
    cfg = port_cfg(root, str(tmp_path), "reg", feature_update="sparse")
    run_path, grid, _ = run_shine_mapping_incremental(cfg=cfg)
    assert seen == [(f >= cfg.freeze_after_frame, True) for f in range(len(seen))]
    recs = records(run_path)
    assert recs[0]["loss/reg_loss"] == 0.0 and all(r["loss/reg_loss"] > 0 for r in recs[1:])
    assert all(np.isfinite(r["loss/total_loss"]) for r in recs)
    # the importance sweep ran after every frame
    assert all(float(t.abs().sum()) > 0 for t in grid.importance_weight)
    assert not any(adam_kernel.LAUNCHES.values())
    m = score(os.path.join(run_path, MESH), gt_path)
    print({k: round(v, 4) for k, v in m.items()}, "JAX F-score", jax_sparse[1])
    assert abs(m["F-score (%)"] - jax_sparse[1]) < 5.0, (m["F-score (%)"], jax_sparse[1])
