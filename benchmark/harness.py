"""One run of a benchmark cell: the inputs from the seed, the program's
set-up, the checked first steps, the timed window, the optional traced
stretches, the comparison with the plain reference, and the result.

Everything is found by name: the cell in BENCHMARK.json, its configuration
in ``configs/<config>.json``, its traffic in ``traffic/<traffic>.json``
(whose ``generator`` names ``generators/<generator>.py``), each metric in
``metrics/<metric>.py``, each cell's limits in ``limits/<cell>.json``, and
the driver in ``drivers/<driver>.py``, named by the configuration's
top-level ``"driver"`` (``"batch"`` where it gives none).

A driver holds all that knows how the program is driven, as module
functions over the program it sets up:

* ``setup(cell, seed, device, tmp)``: the program, with ``timers`` (host
  seconds by set-up stage, which the metrics read);
* ``check(prog)``: the program's readings of its checked first steps;
* ``warm(prog)``: the window's shapes, once;
* ``unit(prog)``: one timed unit, read back: ``(steps, samples)``, or
  ``None`` where the traffic has run out (a batch driver's unit is a chunk
  of steps, an incremental driver's a whole frame: its scan processed,
  then its steps);
* ``stretch(prog, n)``: ``n`` steps in one call, read back (the traced
  stretches; where a unit is a frame, ``n`` steps of the current frame's
  training, with no frame processing);
* ``work(prog)``: one step's work for the roofline shares, or ``None``;
* ``free(prog)``: the program's device state released;
* ``compare(prog, checked)``: the numbers set beside the cell's limits.

and, where it has them:

* ``control(prog, checked)``: ``control.py``'s readings once ``free`` has
  run, ``{side: {number: reading}}``: ``program`` (``compare``'s numbers,
  the lower readings of the limits), and the controls and planted faults
  that the limits' upper readings come from (the batch driver's
  ``control_tf32``, ``fault_half_batch`` and ``control_bf16_pool``);
* ``sequential_data(prog)`` and ``ab_steps(prog)``: ``stages.py``'s data
  phase again on the main thread alone, and the steps of one of its
  tracing off / on rounds; ``stages.py`` skips each part whose function
  the driver lacks.

``run_cell`` hands each metric's reader one record: ``timers``,
``setup_s``, ``window_s``, ``samples``, ``step_s``, ``unit_s`` (each timed
unit's host seconds, in order), ``peak_bytes`` and ``device_kind``; in a
traced run also ``spans``, ``trace`` and ``work``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (HERE, os.path.join(HERE, "generators")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# modules that no run may hold once its window has closed (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "shine_mapping_tpu")


def load_module(kind: str, name: str):
    path = os.path.join(HERE, kind, name + ".py")
    mod_name = f"bench_{kind}_{name}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


class Cell:
    """A cell's specification: BENCHMARK.json's entry, its configuration,
    traffic and limits, with ``overrides`` ({"config": ..., "traffic": ...},
    merged in; the CPU tests' small sizes) and its driver (``driver``, a
    module, takes the place of the one the configuration names: the tests'
    stand-ins)."""

    def __init__(self, workload: str, overrides: dict | None = None, driver=None):
        bench = load_json(ROOT, "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r} (known: {sorted(cells)})")
        self.bench, self.cell = bench, cells[workload]
        self.name = workload
        self.config = load_json(HERE, "configs", self.cell["config"] + ".json")
        self.traffic = load_json(HERE, "traffic", self.cell["traffic"] + ".json")
        self.limits = load_json(HERE, "limits", workload + ".json")
        ov = overrides or {}
        merge(self.config["config"], ov.get("config", {}))
        merge(self.traffic, ov.get("traffic", {}))
        self.driver = driver or load_module("drivers", self.config.get("driver", "batch"))

    def metrics(self, trace: bool) -> list:
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind] if self.name in m.get("workloads", [self.name])]


def make_config(cell: Cell, data: dict, tmp: str, seed: int, device: str):
    """The configuration as run: the published YAML's keys with the data
    paths of this run's scans, loaded by the program's own loader.  The
    program's own seed (its samplers) is the traffic file's ``data_seed``
    where it gives one, so that every run grows the same tables."""
    from shine_mapping_tpu_torch.config import SHINEConfig

    cfg_dict = json.loads(json.dumps(cell.config["config"]))
    for k in ("pc_path", "pose_path", "calib_path"):
        if cfg_dict["setting"].get(k) == "{data}":
            cfg_dict["setting"][k] = data[k]
    path = os.path.join(tmp, "config.yaml")
    with open(path, "w") as f:
        json.dump(cfg_dict, f)  # JSON is YAML
    cfg = SHINEConfig().load(path)
    cfg.seed = cell.traffic.get("data_seed", seed)
    cfg.device = device
    return cfg


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at most its limit."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    return ok, shown


def summed(spans, prefix: str = "") -> dict:
    """Seconds by span name over the spans whose name starts with ``prefix``."""
    out = {}
    for s in spans:
        if s.name.startswith(prefix):
            out[s.name] = out.get(s.name, 0.0) + (s.t1_ns - s.t0_ns) / 1e9
    return out


@contextlib.contextmanager
def spans_of(on: bool, prefix: str = ""):
    """Where ``on``, the program's tracing (``utils.profiling``) on over the
    block, and the block's spans whose name starts with ``prefix`` summed by
    name into the dict it yields; where not, tracing untouched and the dict
    left empty."""
    out = {}
    if not on:
        yield out
        return
    from shine_mapping_tpu_torch.utils import profiling

    profiling.clear_spans()
    was = profiling.tracing(True)
    try:
        yield out
    finally:
        profiling.tracing(was)
    out.update(summed(profiling.spans(), prefix))
    profiling.clear_spans()


def trace_stretch(drv, prog, steps: int, device: str, tmp: str) -> dict:
    """The driver's stretch of ``steps`` steps under ``torch.profiler``
    (host and device), read from its Chrome trace: every device operation
    (kernels, copies, memsets) with its interval, the launch calls, and the
    idle gaps between device operations by the host operation that launched
    the operation ending the gap."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        drv.stretch(prog, steps)
        _sync(device)
        window_s = time.perf_counter() - t0
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return read_trace(events, steps, window_s)


def read_trace(events: list, steps: int, window_s: float) -> dict:
    dev, cpu_by_ext, launches = [], {}, 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"],
                        (e.get("args") or {}).get("External id")))
        elif cat in ("cuda_runtime", "cuda_driver") and "Launch" in e.get("name", ""):
            launches += 1
        elif cat == "cpu_op":
            ext = (e.get("args") or {}).get("External id")
            if ext is not None:
                cpu_by_ext.setdefault(ext, e["name"])
    dev.sort()
    by_name, busy, gaps = {}, 0.0, {}
    end = None
    for t0, t1, name, ext in dev:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
        if end is None or t0 > end:
            if end is not None:
                who = "host in " + cpu_by_ext.get(ext, "an untraced call")
                gaps[who] = gaps.get(who, 0.0) + (t0 - end) / 1e6
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": steps, "window_s": window_s, "busy_s": busy / 1e6, "launches": launches,
            "device_ops": len(dev), "by_name": by_name,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in sorted(gaps.items(),
                                                                  key=lambda kv: -kv[1])[:10]]}}


def window(drv, prog, seconds: float, device: str) -> dict:
    """The timed window: whole units until ``seconds`` have passed or the
    traffic has run out, each read back, then a synchronise.  ``steps`` and
    ``samples`` summed, ``marks`` (each unit's end, host seconds from the
    window's start), ``cpu_marks`` (the same on the dispatching thread's CPU
    clock) and ``window_s``."""
    steps, samples, marks, cpu_marks = 0, 0, [], []
    c0, t0 = time.thread_time(), time.perf_counter()
    while True:
        done = drv.unit(prog)
        if done is None:
            break
        steps += done[0]
        samples += done[1]
        marks.append(time.perf_counter() - t0)
        cpu_marks.append(time.thread_time() - c0)
        if marks[-1] >= seconds:
            break
    _sync(device)
    return {"steps": steps, "samples": samples, "marks": marks, "cpu_marks": cpu_marks,
            "window_s": time.perf_counter() - t0}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, t_start: float | None = None,
             trace_steps: int = 20, span_rounds: int = 100, driver=None) -> dict:
    """One run; returns the result line's object (and prints each number
    compared beside its limit on standard error).  A traced run's spans
    stretch is ``span_rounds`` stretches of ``trace_steps`` steps, each
    ended by a synchronise (in one long call the host would run ahead until
    the launch queue fills, and its spans would then read the device's
    step); its profiled stretch is one of ``trace_steps`` steps.
    ``driver``: a stand-in for the cell's own (the tests')."""
    import torch

    t_start = time.time() if t_start is None else t_start
    cell = Cell(workload, overrides, driver)
    drv = cell.driver
    tmp = tempfile.mkdtemp(prefix="shine-bench-")
    try:
        with spans_of(trace) as setup_spans:  # the data phase's spans, traced runs only
            prog = drv.setup(cell, seed, device, tmp)
        t = time.perf_counter()
        checked = drv.check(prog)
        prog.timers["checked_steps"] = time.perf_counter() - t
        t = time.perf_counter()
        drv.warm(prog)
        _sync(device)
        prog.timers["warm"] = time.perf_counter() - t
        rec = {"setup_s": time.time() - t_start, "timers": prog.timers}
        win = window(drv, prog, seconds, device)
        steps, marks, cpu_marks = win["steps"], win["marks"], win["cpu_marks"]
        rec["window_s"] = win["window_s"]
        rec["samples"] = win["samples"]
        rec["step_s"] = rec["window_s"] / steps
        rec["unit_s"] = [b - a for a, b in zip([0.0] + marks, marks)]
        cuda = device.startswith("cuda")
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
        rec["device_kind"] = torch.cuda.get_device_name(0) if cuda else "cpu"
        if trace:
            # spans first: a profiled stretch leaves the host's later steps slower
            with spans_of(True) as stretch_spans:
                for _ in range(span_rounds):
                    drv.stretch(prog, trace_steps)
                    _sync(device)
            rec["spans"] = {"setup": setup_spans, "stretch": stretch_spans,
                            "stretch_steps": span_rounds * trace_steps}
            rec["trace"] = trace_stretch(drv, prog, trace_steps, device, tmp)
            rec["work"] = drv.work(prog)
        # the comparison, once the program's state is freed
        drv.free(prog)
        t = time.perf_counter()
        numbers = drv.compare(prog, checked)
        print(f"set-up stages (s): {json.dumps(prog.timers)}; window {rec['window_s']:.3f} s, "
              f"{steps} steps, units ended at {[round(m, 3) for m in marks]} s "
              f"(thread CPU {[round(m, 3) for m in cpu_marks]} s); comparison "
              f"{time.perf_counter() - t:.3f} s; program readings {json.dumps(checked)}",
              file=sys.stderr)
        correct, shown = verdict(numbers, cell.limits)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    metrics = {}
    for m in cell.metrics(trace):
        val = load_module("metrics", m["name"]).read(rec)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": rec["device_kind"],
           "count": 1, "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": correct, "attempted": steps, "failed": 0, "metrics": metrics,
           "device": dev}
    if trace:
        tr = rec["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = tr["breakdown"]
        if rec["work"] is not None and cuda:
            import roofline

            peaks = roofline.peaks_of(rec["device_kind"])
            if peaks is not None:
                _, by = roofline.least_time(*roofline.step_work(rec["work"]), peaks)
                print(f"step_mfu is bound by {by}; work {json.dumps(rec['work'])}",
                      file=sys.stderr)
    out["checked"] = shown
    for k, v in shown.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return out
