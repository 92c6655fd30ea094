"""The plain reference agrees with the port at a small size on the CPU, and
a run with its timed path broken underneath comes out not correct: a step
that returns its state unchanged, half of each batch left out (the mean
over the rest), an update altered where it is produced."""

import dataclasses
import json

import pytest
import torch

import harness
from small import OVERRIDES

CELL = "maicity_batch.street"


def _unchanged(real):
    def chunk(params, opt, *args, **kw):
        one = torch.ones(())
        return params, opt, {"mean": {"total_loss": one}, "last": {"total_loss": one}}
    return chunk


def _half_batch(real):
    def chunk(p, o, tables, pool, n_valid, start, gen, s, n, **kw):
        return real(p, o, tables, pool, n_valid, start, gen, dataclasses.replace(s, bs=s.bs // 2),
                    n, **kw)
    return chunk


def _altered_update(real):
    def levels(ps, ms, vs, rows, gs, lr, *args, **kw):
        return real(ps, ms, vs, rows, gs, lr * 1.01, *args, **kw)
    return levels


FAULTS = {
    "state_unchanged": ("shine_mapping_tpu_torch.train.trainer", "train_chunk", _unchanged),
    "half_batch": ("shine_mapping_tpu_torch.train.trainer", "train_chunk", _half_batch),
    "update_altered": ("shine_mapping_tpu_torch.ops.adam_kernel", "fused_adam_levels",
                       _altered_update),
}


@pytest.mark.parametrize("sub_pool", [False, True])
def test_reference_agrees_with_the_port(sub_pool):
    """Also where the pool exceeds the device's and a sub-pool goes up."""
    ov = harness.merge(json.loads(json.dumps(OVERRIDES[CELL])),
                       {"config": {"tpu": {"max_device_pool": 8192}}} if sub_pool else {})
    out = harness.run_cell(CELL, 11, 0.2, False, device="cpu", overrides=ov)
    assert out["correct"], out["checked"]
    # the CPU's plain update follows the same arithmetic: far inside the limits
    for k in ("loss_gap", "grad_gap", "change_gap"):
        assert out["checked"][k]["value"] < 0.1 * out["checked"][k]["limit"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    import importlib

    mod_name, attr, wrap = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    out = harness.run_cell(CELL, 12, 0.2, False, device="cpu", overrides=OVERRIDES[CELL])
    assert out["correct"] is False
    failed = [k for k, v in out["checked"].items() if v["value"] > v["limit"]]
    assert failed and set(failed) <= {"loss_gap", "grad_gap", "change_gap"}


def test_a_wrong_pool_is_not_correct(monkeypatch):
    """A data stage that moves the samples: the data check fails."""
    from shine_mapping_tpu_torch.data import dataset

    real = dataset.LiDARDataset.finalize_pool

    def shifted(self):
        real(self)
        self.pool.sdf_label = self.pool.sdf_label + 1e-3

    monkeypatch.setattr(dataset.LiDARDataset, "finalize_pool", shifted)
    out = harness.run_cell(CELL, 13, 0.2, False, device="cpu", overrides=OVERRIDES[CELL])
    assert out["correct"] is False
    assert out["checked"]["data_gap_m"]["value"] > out["checked"]["data_gap_m"]["limit"]
