"""The port's incremental driver with window replay (the MaiCity replay
configuration's mode: the pool keeps the samples within ``window_radius``
of the current frame, no continual-learning reg, eikonal on) end to end on
the CPU, against the JAX driver on the same world and config: the final
mesh's F-score within 5 points (measured: 82.4 against 83.4).  The world,
config and scoring are tests/test_torch_incre_cli.py's."""

import os

from tests.test_torch_incre_cli import (  # noqa: F401
    MESH, _one_thread, jax_run, port_cfg, records, score, watch_chunks, world)

import numpy as np
import pytest


@pytest.fixture(scope="module")
def jax_replay(world, tmp_path_factory):
    return jax_run(world, tmp_path_factory, "replay")


def test_incre_replay_matches_jax_quality(world, jax_replay, tmp_path, monkeypatch):
    from shine_mapping_tpu_torch.cli.shine_incre import run_shine_mapping_incremental

    root, gt_path = world
    seen = watch_chunks(monkeypatch)
    cfg = port_cfg(root, str(tmp_path), "replay")
    run_path, grid, _ = run_shine_mapping_incremental(cfg=cfg)
    assert seen == [(f >= cfg.freeze_after_frame, False) for f in range(len(seen))]
    recs = records(run_path)
    # the replay window keeps the earlier frames' samples: the pool grows
    pools = [r["pool_samples"] for r in recs]
    assert pools[-1] > pools[0]
    assert all("loss/reg_loss" not in r for r in recs)
    assert all(np.isfinite(r["loss/eikonal_loss"]) for r in recs)
    m = score(os.path.join(run_path, MESH), gt_path)
    print({k: round(v, 4) for k, v in m.items()}, "JAX F-score", jax_replay[1])
    assert abs(m["F-score (%)"] - jax_replay[1]) < 5.0, (m["F-score (%)"], jax_replay[1])
