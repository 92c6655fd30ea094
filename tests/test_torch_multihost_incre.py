"""Processes launched apart through the config's knobs, the incremental CLI
(tests/test_torch_multihost.py does the batch CLI and holds the launch's
refusals).

Two independent processes, each with ``num_processes: 2``, ``mesh_shape:
4`` and two gloo CPU ranks, run the incremental driver with continual
learning on 3 frames of tests/synth.py: 4 ranks, a final checkpoint
bit-equal to a one-process ``mesh_shape: 4`` spawn (sums and the
importance sweep in rank order), rank 0's run directory alone, finite
losses and the reg term after frame 0."""

import json
import os

from tests.test_torch_multihost import check_launch


def test_two_processes_form_four_ranks_incre(tmp_path):
    losses = check_launch("incre", tmp_path)
    assert len(losses) == 3, losses
    two = tmp_path / "two"
    with open(os.path.join(two, os.listdir(two)[0], "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert recs[0]["loss/reg_loss"] == 0.0
    assert all(r["loss/reg_loss"] > 0 for r in recs[1:]), recs
