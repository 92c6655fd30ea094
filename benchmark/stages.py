#!/usr/bin/env python3
"""A cell's time by the program's stage spans (``utils.profiling.span``).

    python3 benchmark/stages.py --workload <cell> --seed <n> [--seconds 20]
                                [--steps 20] [--rounds 4]

One run on the card through the cell's driver (``drivers/<driver>.py``), as
``run.py``'s set-up and window, with tracing on where it is read and off
where the window is timed:

1. the driver's set-up with tracing on: the data phase's ``data.*`` spans
   summed by name (``setup_spans``, seconds; ``data.prep`` over every frame
   and worker thread) beside the set-up's timers; then, where the driver
   has ``sequential_data``, the data phase again on the main thread alone
   (``frames``, ``setup_spans_sequential``, ``data_s_sequential``);
2. the driver's checked steps, warm-up and a window of whole units for
   ``--seconds`` (``harness.window``), tracing off (``window_ms_per_step``);
3. ``--steps`` steps in one ``stretch`` call with tracing on and no
   profiler, ended by a synchronise: each stage's summed span time a step
   (``stages``) and the stretch's own ms a step, the on-cost against the
   window;
4. where the driver has ``ab_steps``, ``--rounds`` pairs of stretches of
   that many steps (the batch driver's: a unit's chunk) with tracing off
   and on, in turns (``ab``): the on-cost again, on stretches the window's
   size;
5. ``--steps`` steps in one ``stretch`` call under ``torch.profiler``
   with tracing on (:func:`by_stage`): each launch call given to the
   ``step.*`` interval that holds it, on any thread (autograd runs the
   backward's launches on its own thread), ``outside`` the rest; each idle
   gap before a device operation given to the stage of the operation's
   launching ``cpu_op`` (by ``External id``; the profiler roughly doubles
   the host's time, so these gaps are shares, not times); then one stretch
   of ``ab_steps`` (else ``--steps``) steps with tracing off
   (``after_profile_ms_per_step``).

``skipped`` names the parts the driver has no function for
(``sequential_data``, ``ab_rounds``).  Prints one JSON object as its last
line.  ``run.py`` runs none of this.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

if __name__ == "__main__":
    # as run.py, before numpy and torch load: one process on one CPU with
    # one intra-op thread
    os.environ["OMP_NUM_THREADS"] = "1"
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (HERE, os.path.dirname(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402

STAGE_PREFIX = "step."
OUTSIDE = "outside"


def stage_of(events: list):
    """A function from a trace time to the ``step.*`` annotation that holds
    it (in [ts, ts + dur], on any thread), or ``outside``.  The stages of
    a step run one after the other on the calling thread: none overlap."""
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                for e in events
                if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(STAGE_PREFIX))
    starts = [a for a, _, _ in iv]

    def at(ts: float) -> str:
        i = bisect.bisect_right(starts, ts) - 1
        return iv[i][2] if i >= 0 and ts <= iv[i][1] else OUTSIDE

    return at


def by_stage(events: list) -> dict:
    """``launches`` (``harness.read_trace``'s count), ``launches_by_stage``
    (which sum to it) and ``idle_by_stage`` (seconds) of a Chrome trace."""
    stage_at = stage_of(events)
    launches, by_launch, dev, cpu_ts = 0, {}, [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                        (e.get("args") or {}).get("External id")))
        elif cat in ("cuda_runtime", "cuda_driver") and "Launch" in e.get("name", ""):
            launches += 1
            st = stage_at(float(e["ts"]))
            by_launch[st] = by_launch.get(st, 0) + 1
        elif cat == "cpu_op":
            ext = (e.get("args") or {}).get("External id")
            if ext is not None:
                cpu_ts.setdefault(ext, float(e["ts"]))
    dev.sort()
    idle, end = {}, None
    for t0, t1, ext in dev:
        if end is not None and t0 > end:
            st = stage_at(cpu_ts[ext]) if ext in cpu_ts else OUTSIDE
            idle[st] = idle.get(st, 0.0) + (t0 - end) / 1e6
        end = t1 if end is None else max(end, t1)
    return {"launches": launches, "launches_by_stage": by_launch, "idle_by_stage": idle}


def profiled(drv, prog, steps: int, device: str, tmp: str):
    """:func:`timed`'s stretch with tracing on, under ``torch.profiler``:
    (the Chrome trace's events, the stretch's host seconds)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    harness._sync(device)
    with profile(activities=acts) as prof:
        window_s = timed(drv, prog, steps, True, device)
    path = os.path.join(tmp, "stages_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return events, window_s


def timed(drv, prog, steps: int, on: bool, device: str) -> float:
    """Host seconds of one ``stretch`` call of ``steps`` steps, ended by a
    synchronise, with tracing ``on`` or off (no profiler)."""
    from shine_mapping_tpu_torch.utils import profiling

    was = profiling.tracing(on)
    try:
        t0 = time.perf_counter()
        drv.stretch(prog, steps)
        harness._sync(device)
        return time.perf_counter() - t0
    finally:
        profiling.tracing(was)


def run(workload: str, seed: int, seconds: float = 20.0, steps: int = 20, rounds: int = 4,
        device: str = "cuda", overrides: dict | None = None) -> dict:
    from shine_mapping_tpu_torch.utils import profiling

    cell = harness.Cell(workload, overrides)
    drv = cell.driver
    tmp = tempfile.mkdtemp(prefix="shine-stages-")
    out = {"workload": workload, "seed": seed, "skipped": []}
    try:
        with harness.spans_of(True, "data.") as sp:
            prog = drv.setup(cell, seed, device, tmp)
        out["setup_spans"] = sp
        out["timers"] = dict(prog.timers)
        if hasattr(drv, "sequential_data"):
            out.update(drv.sequential_data(prog))
        else:
            out["skipped"].append("sequential_data")

        drv.check(prog)
        drv.warm(prog)
        win = harness.window(drv, prog, seconds, device)
        out["window_ms_per_step"] = 1e3 * win["window_s"] / win["steps"]

        with harness.spans_of(True) as sp:
            dt = timed(drv, prog, steps, True, device)
        out["stages"] = {k: 1e3 * v / (1 if k == "chunk" else steps) for k, v in sp.items()}
        out["spans_ms_per_step"] = 1e3 * dt / steps

        chunk = steps
        if hasattr(drv, "ab_steps"):
            chunk = drv.ab_steps(prog)
            ab = {"off": [], "on": []}
            for r in range(rounds):
                for on in ((False, True) if r % 2 == 0 else (True, False)):
                    ab["on" if on else "off"].append(
                        1e3 * timed(drv, prog, chunk, on, device) / chunk)
            profiling.clear_spans()
            out["ab_ms_per_step"] = ab
            if ab["off"]:
                out["ab_median_ms"] = {k: statistics.median(v) for k, v in ab.items()}
        else:
            out["skipped"].append("ab_rounds")

        # last: on the card a profiled stretch leaves the host's later steps slower
        events, tr_s = profiled(drv, prog, steps, device, tmp)
        profiling.clear_spans()
        rt = harness.read_trace(events, steps, tr_s)
        st = by_stage(events)
        assert st["launches"] == rt["launches"] == sum(st["launches_by_stage"].values())
        out["launches_per_step"] = st["launches"] / steps
        out["launches_by_stage"] = {k: v / steps for k, v in st["launches_by_stage"].items()}
        out["idle_by_stage_ms"] = {k: 1e3 * v / steps for k, v in st["idle_by_stage"].items()}
        out["profiled_ms_per_step"] = 1e3 * tr_s / steps
        out["busy_ms_per_step"] = 1e3 * rt["busy_s"] / steps
        out["after_profile_ms_per_step"] = 1e3 * timed(drv, prog, chunk, False, device) / chunk
        drv.free(prog)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("stages.py needs a CUDA card", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, args.steps, args.rounds)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
