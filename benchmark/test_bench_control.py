"""On the card: the readings the limits were set from, at a size a test run
holds.  The program stays within each cell's limits; the control (the
reference with TF32 products in the program's place) and the planted fault
(half of each batch) do not."""

import pytest

import control
import harness

SMALL = {
    "maicity_batch.street": {"traffic": {"frames": 8}},
    "rgbd_batch.room": {"traffic": {"frames": 4}},
}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_and_fault_fail_the_limits(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = harness.Cell(workload).limits
    for seed in (101, 102, 103):
        r = control.readings(workload, seed, "cuda", SMALL[workload])
        assert harness.verdict(r["program"], limits)[0], r["program"]
        for side in ("control_tf32", "fault_half_batch"):
            assert any(v > limits[k] for k, v in r[side].items()), (side, r[side])
        assert r["control_bf16_pool"]["data_gap_m"] > limits["data_gap_m"]
