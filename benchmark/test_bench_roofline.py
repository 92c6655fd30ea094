"""The yardstick's counts against hand counts, and the trace reader on a
hand-made trace."""

import pytest

import harness
import roofline


def test_update_bytes_match_a_hand_count():
    # 10 rows of 8 lanes: p, m, v read and written, 4 bytes each; 4 entries of
    # an int32 row and 8 float32 gradients
    nbytes, flops = roofline.update_work(10, 4, 8)
    assert nbytes == 10 * 8 * 3 * 4 * 2 + 4 * (4 + 8 * 4)
    assert flops == 13 * 80 + 4 * 8


def test_step_work_matches_a_hand_count():
    w = {"bs": 2, "levels": 1, "dim": 8, "found_entries": 16, "used_rows": 10,
         "decoder_dims": [8, 32, 32, 1], "eikonal": True}
    nbytes, flops = roofline.step_work(w)
    f = 2 * (8 * 32 + 32 * 32 + 32 * 1)
    assert nbytes == 2 * 24 + 2 * (8 * 4 + 1) + 2 * 16 * 8 * 4 + roofline.update_work(10, 16, 8)[0]
    assert flops == 2 * (2 * 8 * 8 + 6 * f) + roofline.update_work(10, 16, 8)[1]


def test_least_time_names_its_bound():
    peaks = roofline.peaks_of("NVIDIA H100 80GB HBM3")
    t, by = roofline.least_time(3.35e12, 1.0, peaks)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.least_time(1.0, 67e12 * 2, peaks)
    assert t == pytest.approx(2.0) and by == "operations"
    assert roofline.peaks_of("cpu") is None


def test_trace_reader_on_a_hand_made_trace():
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0, "dur": 50,
         "args": {"External id": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 60, "dur": 50,
         "args": {"External id": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 70, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 80, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k_mul", "ts": 20, "dur": 10,
         "args": {"External id": 1}},
        {"ph": "X", "cat": "kernel", "name": "k_mul", "ts": 25, "dur": 10,
         "args": {"External id": 1}},
        {"ph": "X", "cat": "kernel", "name": "fused_adam_kernel<float>", "ts": 80, "dur": 20,
         "args": {"External id": 2}},
    ]
    tr = harness.read_trace(ev, steps=2, window_s=1e-4)
    assert tr["launches"] == 2
    assert tr["busy_s"] == pytest.approx(35e-6)  # [20, 35] and [80, 100]
    assert tr["by_name"]["k_mul"] == pytest.approx(20e-6)
    assert tr["breakdown"]["idle_gaps"] == [["host in aten::add", pytest.approx(45e-6)]]
    rec = {"trace": tr, "step_s": 1e-4}
    fwd = harness.load_module("metrics", "fwd_bwd_device_ms").read(rec)
    assert fwd == pytest.approx(1e3 * 20e-6 / 2)
    idle = harness.load_module("metrics", "device_idle_share").read(rec)
    assert idle == pytest.approx(100 * (1 - 35e-6 / 2 / 1e-4))
