"""The stage reader (``stages.by_stage``) on hand-made Chrome traces, the
spans summed by name (``harness.summed``), and ``stages.run`` at a small
size on the CPU."""

import pytest

import harness
import stages
from small import OVERRIDES


def _x(cat, name, ts, dur, tid=1, ext=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if ext is not None:
        e["args"] = {"External id": ext}
    return e


def _trace():
    """One step: forward [0, 10], backward [10, 20], update [20, 30] on the
    main thread (tid 1); the backward's launches on autograd's thread
    (tid 2); one launch before the step and one after it."""
    return [
        _x("user_annotation", "step", 0, 30),
        _x("user_annotation", "step.forward", 0, 10),
        _x("user_annotation", "step.backward", 10, 10),
        _x("user_annotation", "step.update", 20, 10),
        _x("cuda_runtime", "cudaLaunchKernel", -5, 1),
        _x("cpu_op", "aten::mul", 1, 2, ext=1),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 1, ext=1),
        _x("cpu_op", "MulBackward0", 12, 3, tid=2, ext=2),
        _x("cuda_runtime", "cudaLaunchKernel", 13, 1, tid=2, ext=2),
        _x("cuda_driver", "cuLaunchKernel", 14, 1, tid=2, ext=2),
        _x("cpu_op", "aten::sqrt", 22, 2, ext=3),
        _x("cuda_runtime", "cudaLaunchKernel", 23, 1, ext=3),
        _x("cuda_runtime", "cudaLaunchKernel", 35, 1),
        _x("cuda_runtime", "cudaMemcpyAsync", 24, 1),  # no launch
        _x("kernel", "mul_kernel", 100, 5, tid=7, ext=1),
        _x("kernel", "mul_bwd_kernel", 110, 5, tid=7, ext=2),
        _x("kernel", "mul_bwd_kernel2", 112, 5, tid=7, ext=2),
        _x("kernel", "sqrt_kernel", 130, 5, tid=7, ext=3),
        _x("kernel", "untraced_kernel", 140, 5, tid=7, ext=99),
    ]


def test_a_launch_on_another_thread_inside_the_backward_counts_to_it():
    got = stages.by_stage(_trace())["launches_by_stage"]
    assert got["step.backward"] == 2 and got["step.forward"] == 1
    assert got["step.update"] == 1


def test_a_launch_outside_every_stage_goes_to_outside():
    assert stages.by_stage(_trace())["launches_by_stage"]["outside"] == 2


def test_the_stages_and_outside_sum_to_the_trace_launches():
    ev = _trace()
    st = stages.by_stage(ev)
    assert st["launches"] == harness.read_trace(ev, 1, 1.0)["launches"] == 6
    assert sum(st["launches_by_stage"].values()) == st["launches"]


def test_idle_by_stage_follows_the_external_id():
    """Each gap goes to the stage of the launching op of the operation that
    ends it (not of whatever runs at the gap's time); a gap before an
    operation with no traced op goes to ``outside``."""
    idle = stages.by_stage(_trace())["idle_by_stage"]
    assert idle == pytest.approx({"step.backward": 5e-6, "step.update": 13e-6,
                                  "outside": 5e-6})
    gaps = harness.read_trace(_trace(), 1, 1.0)["breakdown"]["idle_gaps"]
    assert sum(s for _, s in gaps) == pytest.approx(sum(idle.values()))


def test_spans_are_summed_by_name():
    from shine_mapping_tpu_torch.utils.profiling import Span

    sp = [Span("data.prep", 1, 0, 2_000_000_000, None), Span("data.prep", 2, 0, 10**9, None),
          Span("data.wait", 1, 5, 10**9 + 5, None), Span("step", 1, 0, 10**9, None)]
    assert harness.summed(sp, "data.") == {"data.prep": 3.0, "data.wait": 1.0}
    assert harness.summed(sp) == {"data.prep": 3.0, "data.wait": 1.0, "step": 1.0}


def test_run_reads_every_stage_at_a_small_size():
    """On the CPU (the program's plain paths; no launches there): a data
    span a frame, the three stages in the spans stretch and the A/B rounds,
    and tracing left off."""
    from shine_mapping_tpu_torch.utils import profiling

    w = "rgbd_batch.room"
    out = stages.run(w, 2 ** 31 + 7, seconds=0.1, steps=2, rounds=2, device="cpu",
                     overrides=OVERRIDES[w])
    assert out["skipped"] == []
    assert out["frames"] == OVERRIDES[w]["traffic"]["frames"]
    assert set(out["setup_spans"]) == {"data.prep", "data.wait", "data.octree", "data.pool"}
    assert set(out["setup_spans_sequential"]) == {"data.prep", "data.octree", "data.pool"}
    assert sum(out["setup_spans_sequential"].values()) <= out["data_s_sequential"]
    assert set(out["stages"]) == {"chunk", "step", "step.forward", "step.backward",
                                  "step.update"}
    assert sum(out["stages"][f"step.{k}"] for k in ("forward", "backward", "update")) <= \
        out["stages"]["step"] <= out["spans_ms_per_step"]
    assert out["launches_per_step"] == sum(out["launches_by_stage"].values())
    assert len(out["ab_ms_per_step"]["on"]) == len(out["ab_ms_per_step"]["off"]) == 2
    assert profiling.tracing(False) is False and profiling.spans() == []
