"""The runner at a small size on the CPU (the program's plain paths): a
valid result line, the spans of a traced run, the numbers compared as the
driver's own functions give them, a stand-in driver that needs only new
files, and no result without a card."""

import json
import os
import subprocess
import sys

import pytest

import harness
from small import OVERRIDES

CELLS = sorted(OVERRIDES)


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


def _records(monkeypatch) -> list:
    """The records that the run's metric readers are handed."""
    seen, real = [], harness.load_module

    def spy(kind, name):
        mod = real(kind, name)
        if kind == "metrics":
            read = mod.read
            mod.read = lambda rec: seen.append(rec) or read(rec)
        return mod

    monkeypatch.setattr(harness, "load_module", spy)
    return seen


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_runner_prints_a_valid_line(workload, trace, monkeypatch):
    """A traced run records the data phase's spans in set-up and the step's
    in the spans stretch; an untraced one records no span."""
    from shine_mapping_tpu_torch.utils import profiling

    profiling.clear_spans()
    seen = _records(monkeypatch)
    out = harness.run_cell(workload, 2 ** 31 + 7, 0.2, trace, device="cpu",
                           overrides=OVERRIDES[workload], trace_steps=2, span_rounds=2)
    cell = harness.Cell(workload)
    _check_line(out, cell, trace)
    assert profiling.tracing(False) is False and profiling.spans() == []
    rec = seen[0]
    if trace:
        assert {"data_phase_s", "precompute_s"} <= set(out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"data.octree", "data.pool"} <= set(rec["spans"]["setup"])
        assert "step" in rec["spans"]["stretch"] and rec["spans"]["stretch_steps"] == 4
        spans = {m["name"] for m in cell.metrics(True) if m["source"] == "program_span"}
        assert spans and spans <= set(out["metrics"])
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


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_checked_numbers_are_the_drivers_own(workload, trace, one_thread, tmp_path):
    """``run_cell``'s numbers compared, traced or not, are those of the
    driver's set-up, checked steps and comparison on a program set up afresh
    at the same seed: the window, the stretches and the spans leave them as
    they are."""
    seed = 2 ** 31 + 7
    out = harness.run_cell(workload, seed, 0.2, trace, device="cpu",
                           overrides=OVERRIDES[workload], trace_steps=2, span_rounds=2)
    cell = harness.Cell(workload, OVERRIDES[workload])
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


@pytest.mark.parametrize("trace", [False, True])
def test_a_second_driver_needs_only_new_files(tmp_path, trace):
    """A driver of the harness's functions, from a file of its own: a valid
    line, and a window that ends where its traffic runs out."""
    import importlib.util

    path = tmp_path / "stand_in.py"
    path.write_text(STAND_IN)
    spec = importlib.util.spec_from_file_location("stand_in", path)
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    w = "rgbd_batch.room"
    out = harness.run_cell(w, 5, 60.0, trace, device="cpu", trace_steps=2, span_rounds=2,
                           driver=drv)
    _check_line(out, harness.Cell(w), trace)
    assert out["attempted"] == 6
    if trace:
        assert {"octree_update_s", "pool_append_s", "step_host_ms"} <= set(out["metrics"])
    else:
        assert out["metrics"]["train_samples_per_s"]["value"] > 0


def test_every_cell_has_its_cpu_sizes():
    """``small.OVERRIDES`` holds every ``cpu_sizes/*.json``, one a cell."""
    files = {f[:-len(".json")] for f in os.listdir(os.path.join(harness.HERE, "cpu_sizes"))
             if f.endswith(".json")}
    assert set(OVERRIDES) == files
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    assert {w["name"] for w in bench["workloads"]} <= files


def test_every_per_layer_metric_moves_what_its_cells_report():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for m in bench["per_layer"]:
        for w in m.get("workloads", [c["name"] for c in bench["workloads"]]):
            names = {e["name"] for e in harness.Cell(w).metrics(False)}
            assert m["moves"] in names, (m["name"], w)
            assert harness.Cell(w).metrics(True), w


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    root = os.path.dirname(harness.HERE)
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_same_seed_same_scans(tmp_path):
    """The traffic is a function of the seed, or of the traffic file's
    ``data_seed`` alone where it gives one."""
    import numpy as np

    cell = harness.Cell(CELLS[0], OVERRIDES[CELLS[0]])
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
