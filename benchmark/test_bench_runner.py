"""The runner at a small size on the CPU (the program's plain paths): a
valid result line, the spans of a traced run, the numbers compared as the
driver's own functions give them, a stand-in driver that needs only new
files, and no result without a card.

The dry run: ``dry_run/`` holds a stand-in incremental cell
(``FRAMES``: a driver shaped like ``cli.shine_incre``'s frame loop, with no
pool lookups and a unit of one whole frame, and its configuration, traffic,
limits, CPU sizes and a span metric of its own), laid as new files over a
copy of ``BENCHMARK.json`` and ``benchmark/``, with ``BENCHMARK.json``
given the entries of ``dry_run/BENCHMARK.add.json``.  Every check below
that the real cells take runs on it too, with ``control.readings`` and
``stages.run``."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import control
import harness
import small
import stages
from small import OVERRIDES

CELLS = sorted(OVERRIDES)
FRAMES = "incre_stand_in.street_frames"
CASES = CELLS + [FRAMES]
DRY_RUN = os.path.join(harness.HERE, "dry_run")


def dry_run_root(tmp: str) -> str:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``tmp`` with the
    dry run's cell added as new files only (none of ``dry_run/``'s files is
    there already, and no entry of ``BENCHMARK.json`` changes but by the
    cell's name added to a metric's ``workloads``); returns ``tmp``."""
    here = os.path.join(tmp, "benchmark")
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "dry_run"))
    for d, _, files in os.walk(DRY_RUN):
        for f in files:
            if f == "BENCHMARK.add.json" or "__pycache__" in d:
                continue
            dst = os.path.join(here, os.path.relpath(os.path.join(d, f), DRY_RUN))
            assert not os.path.exists(dst), dst
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(os.path.join(d, f), dst)
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    add = harness.load_json(DRY_RUN, "BENCHMARK.add.json")
    for key in ("configs", "workloads", "per_layer"):
        assert not {e["name"] for e in bench[key]} & {e["name"] for e in add[key]}
        bench[key] += add[key]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in add["workloads_of"]:
            m["workloads"] += add["workloads_of"][m["name"]]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=2)
    return tmp


@pytest.fixture
def sizes(workload, tmp_path, monkeypatch) -> dict:
    """The cell's CPU sizes; for the dry run's cell, with the harness
    pointed at :func:`dry_run_root`."""
    if workload == FRAMES:
        root = dry_run_root(str(tmp_path / "root"))
        monkeypatch.setattr(harness, "ROOT", root)
        monkeypatch.setattr(harness, "HERE", os.path.join(root, "benchmark"))
    return small.overrides(harness.HERE)[workload]


def _check_line(out: dict, cell: harness.Cell, trace: bool):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checked"
    assert out["correct"] is True, out["checked"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"]: m["unit"] for m in cell.metrics(trace)}
    assert set(out["metrics"]) <= set(names)
    for k, v in out["metrics"].items():
        assert v["unit"] == names[k] and v["value"] > 0
    assert set(out["checked"]) == set(cell.limits)
    for v in out["checked"].values():
        assert v["value"] <= v["limit"]
    json.dumps(out)


class Looked(dict):
    """A dict of spans that notes each name looked up in it."""

    def __init__(self, spans: dict, names: set):
        super().__init__(spans)
        self.names = names

    def get(self, k, default=None):
        self.names.add(k)
        return super().get(k, default)

    def __getitem__(self, k):
        self.names.add(k)
        return super().__getitem__(k)


def _records(monkeypatch) -> tuple:
    """The records that the run's metric readers are handed, and the span
    names that the readers look up, by part (``setup``, ``stretch``)."""
    seen, looked, real = [], {"setup": set(), "stretch": set()}, harness.load_module

    def spy(kind, name):
        mod = real(kind, name)
        if kind == "metrics":
            read = mod.read

            def spied(rec):
                seen.append(rec)
                if "spans" in rec:
                    rec = dict(rec, spans=dict(rec["spans"], **{
                        part: Looked(rec["spans"][part], looked[part]) for part in looked}))
                return read(rec)

            mod.read = spied
        return mod

    monkeypatch.setattr(harness, "load_module", spy)
    return seen, looked


@pytest.mark.parametrize("workload", CASES)
@pytest.mark.parametrize("trace", [False, True])
def test_runner_prints_a_valid_line(workload, trace, sizes, monkeypatch):
    """A traced run reads every host-clock and span metric that the cell
    lists, from set-up and stretch spans that its driver recorded; an
    untraced one records no span.  Each timed unit's seconds reach the
    readers."""
    from shine_mapping_tpu_torch.utils import profiling

    profiling.clear_spans()
    seen, looked = _records(monkeypatch)
    out = harness.run_cell(workload, 2 ** 31 + 7, 0.2, trace, device="cpu",
                           overrides=sizes, trace_steps=2, span_rounds=2)
    cell = harness.Cell(workload)
    _check_line(out, cell, trace)
    assert profiling.tracing(False) is False and profiling.spans() == []
    rec = seen[0]
    assert rec["unit_s"] and min(rec["unit_s"]) > 0
    assert sum(rec["unit_s"]) <= rec["window_s"]
    if trace:
        listed = {m["name"] for m in cell.metrics(True)
                  if m["source"] in ("host_clock", "program_span")}
        assert listed <= set(out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert rec["spans"]["stretch_steps"] == 4
        for part in ("setup", "stretch"):
            assert looked[part] <= set(rec["spans"][part]), part
        spans = {m["name"] for m in cell.metrics(True) if m["source"] == "program_span"}
        assert spans and looked["setup"] | looked["stretch"]
        for k in {"octree_update_s", "pool_append_s"} & spans:
            assert out["metrics"][k]["value"] <= out["metrics"]["data_phase_s"]["value"]
    else:
        names = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in names and len(names) >= 2
        # on the CPU there is no device peak to read
        assert set(out["metrics"]) == names - {"peak_device_gib"}
        assert "spans" not in rec


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CASES)
@pytest.mark.parametrize("trace", [False, True])
def test_checked_numbers_are_the_drivers_own(workload, trace, sizes, one_thread, tmp_path):
    """``run_cell``'s numbers compared, traced or not, are those of the
    driver's set-up, checked steps and comparison on a program set up afresh
    at the same seed: the window, the stretches and the spans leave them as
    they are."""
    seed = 2 ** 31 + 7
    out = harness.run_cell(workload, seed, 0.2, trace, device="cpu",
                           overrides=sizes, trace_steps=2, span_rounds=2)
    cell = harness.Cell(workload, sizes)
    drv = cell.driver
    prog = drv.setup(cell, seed, "cpu", str(tmp_path))
    checked = drv.check(prog)
    drv.free(prog)
    numbers = drv.compare(prog, checked)
    assert {k: v["value"] for k, v in out["checked"].items()} == \
        {k: numbers[k] for k in cell.limits}


STAND_IN = """
import time
import types

from shine_mapping_tpu_torch.utils import profiling


def _span(name):
    with profiling.span(name):
        time.sleep(1e-3)


def setup(cell, seed, device, tmp):
    for name in ("data.octree", "data.pool"):
        _span(name)
    return types.SimpleNamespace(timers={"data": 0.5, "precompute": 0.1}, units=0,
                                 limits=cell.limits)


def check(prog):
    return {}


def warm(prog):
    pass


def unit(prog):
    if prog.units == 3:
        return None
    prog.units += 1
    time.sleep(1e-3)
    return 2, 16


def stretch(prog, n):
    for _ in range(n):
        _span("step")


def work(prog):
    return None


def free(prog):
    pass


def compare(prog, checked):
    return {k: 0 for k in prog.limits}
"""


def _stand_in(tmp_path):
    """``STAND_IN`` as a module loaded from a file of its own."""
    import importlib.util

    path = tmp_path / "stand_in.py"
    path.write_text(STAND_IN)
    spec = importlib.util.spec_from_file_location("stand_in", path)
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    return drv


@pytest.mark.parametrize("trace", [False, True])
def test_a_second_driver_needs_only_new_files(tmp_path, trace):
    """A driver of the harness's functions, from a file of its own: a valid
    line, and a window that ends where its traffic runs out."""
    drv = _stand_in(tmp_path)
    w = "rgbd_batch.room"
    out = harness.run_cell(w, 5, 60.0, trace, device="cpu", trace_steps=2, span_rounds=2,
                           driver=drv)
    _check_line(out, harness.Cell(w), trace)
    assert out["attempted"] == 6
    if trace:
        assert {"octree_update_s", "pool_append_s", "step_host_ms"} <= set(out["metrics"])
    else:
        assert out["metrics"]["train_samples_per_s"]["value"] > 0


def test_unit_s_holds_each_timed_units_host_seconds(tmp_path, monkeypatch):
    """``rec["unit_s"]``: one entry a timed unit, in order, from the marks
    the window takes (the stand-in's three units, each at least its sleep)."""
    drv = _stand_in(tmp_path)
    seen, _ = _records(monkeypatch)
    harness.run_cell("rgbd_batch.room", 5, 60.0, False, device="cpu", driver=drv)
    rec = seen[0]
    assert len(rec["unit_s"]) == 3 and min(rec["unit_s"]) >= 1e-3
    assert sum(rec["unit_s"]) <= rec["window_s"]


def _cpu_sizes_cover_every_cell():
    files = {f[:-len(".json")] for f in os.listdir(os.path.join(harness.HERE, "cpu_sizes"))
             if f.endswith(".json")}
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    assert {w["name"] for w in bench["workloads"]} <= files
    return files


def test_every_cell_has_its_cpu_sizes():
    """``small.OVERRIDES`` holds every ``cpu_sizes/*.json``, one a cell."""
    assert set(OVERRIDES) == _cpu_sizes_cover_every_cell()


def _per_layer_metrics_move_what_their_cells_report():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for m in bench["per_layer"]:
        for w in m.get("workloads", [c["name"] for c in bench["workloads"]]):
            names = {e["name"] for e in harness.Cell(w).metrics(False)}
            assert m["moves"] in names, (m["name"], w)
            assert harness.Cell(w).metrics(True), w


def test_every_per_layer_metric_moves_what_its_cells_report():
    _per_layer_metrics_move_what_their_cells_report()


def _no_result_without_a_card(root: str, workload: str):
    """``run.py`` in ``root`` finds the cell, then exits with no line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA card" in res.stderr, res.stderr


def test_no_result_without_a_card():
    _no_result_without_a_card(harness.ROOT, CELLS[0])


def _same_seed_same_scans(workload: str, sizes: dict, tmp_path):
    import numpy as np

    cell = harness.Cell(workload, sizes)
    gen = harness.load_module("generators", cell.traffic["generator"])
    fixed = cell.traffic.pop("data_seed")
    d = gen.generate(str(tmp_path / "d"), dict(cell.traffic, data_seed=fixed), 3, "cpu")
    e = gen.generate(str(tmp_path / "e"), dict(cell.traffic, data_seed=fixed), 4, "cpu")
    for name in sorted(os.listdir(d["pc_path"])):
        with open(os.path.join(d["pc_path"], name), "rb") as fd, \
                open(os.path.join(e["pc_path"], name), "rb") as fe:
            assert fd.read() == fe.read()
    a = gen.generate(str(tmp_path / "a"), cell.traffic, 3, "cpu")
    b = gen.generate(str(tmp_path / "b"), cell.traffic, 3, "cpu")
    for name in sorted(os.listdir(a["pc_path"])):
        with open(os.path.join(a["pc_path"], name), "rb") as fa, \
                open(os.path.join(b["pc_path"], name), "rb") as fb:
            assert fa.read() == fb.read()
    c = gen.generate(str(tmp_path / "c"), cell.traffic, 4, "cpu")
    from plyio import read_ply_xyz

    first = sorted(os.listdir(a["pc_path"]))[0]
    assert not np.array_equal(read_ply_xyz(os.path.join(a["pc_path"], first)),
                              read_ply_xyz(os.path.join(c["pc_path"], first)))


def test_same_seed_same_scans(tmp_path):
    """The traffic is a function of the seed, or of the traffic file's
    ``data_seed`` alone where it gives one."""
    _same_seed_same_scans(CELLS[0], OVERRIDES[CELLS[0]], tmp_path)


@pytest.mark.parametrize("workload", [FRAMES])
def test_dry_run_cell_passes_the_checks_of_every_cell(workload, sizes, tmp_path):
    """The cell-wide checks above, on the copy that holds the dry run's
    cell: its CPU sizes, its per-layer metrics' ``moves``, ``run.py``
    finding it and printing nothing without a card, its scans from the seed;
    and it is asked for no ``precompute_s``, which its driver never times."""
    _cpu_sizes_cover_every_cell()
    _per_layer_metrics_move_what_their_cells_report()
    _no_result_without_a_card(harness.ROOT, workload)
    _same_seed_same_scans(workload, sizes, tmp_path)
    names = {m["name"] for m in harness.Cell(workload).metrics(True)}
    assert "precompute_s" not in names and {"data_phase_s", "reg_host_ms"} <= names


@pytest.mark.parametrize("workload", [FRAMES])
def test_dry_run_control_readings_go_through_its_driver(workload, sizes):
    """``control.readings`` on the dry run's cell: the program within its
    limits, each of its driver's controls and faults past one of them."""
    limits = harness.Cell(workload).limits
    rows = [control.readings(workload, seed, "cpu", sizes) for seed in (11, 2 ** 31 + 7)]
    for r in rows:
        assert set(r) == {"seed", "program", "control_f16", "fault_half_batch"}
        assert harness.verdict(r["program"], limits)[0], r["program"]
        for side in ("control_f16", "fault_half_batch"):
            assert any(v > limits[k] for k, v in r[side].items()), (side, r[side])
    assert set(control.summary(rows)["loss_gap"]) == {
        "program_max", "control_f16_min", "fault_half_batch_min"}


@pytest.mark.parametrize("workload", [FRAMES])
def test_dry_run_stages_skip_what_its_driver_lacks(workload, sizes):
    """``stages.run`` through the dry run's driver: its set-up spans, the
    window and stretches, and the batch driver's sequential data phase and
    tracing off / on rounds named as skipped."""
    from shine_mapping_tpu_torch.utils import profiling

    out = stages.run(workload, 2 ** 31 + 7, seconds=0.1, steps=2, rounds=2, device="cpu",
                     overrides=sizes)
    assert out["skipped"] == ["sequential_data", "ab_rounds"]
    assert "ab_ms_per_step" not in out and "setup_spans_sequential" not in out
    assert set(out["setup_spans"]) == {"data.octree", "data.pool"}
    assert set(out["stages"]) == {"step", "step.reg"} and out["window_ms_per_step"] > 0
    assert out["launches_per_step"] == sum(out["launches_by_stage"].values())
    assert profiling.tracing(False) is False and profiling.spans() == []
