"""The runner at a small size on the CPU (the program's plain paths): a
valid result line, and no result without a card."""

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


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_runner_prints_a_valid_line(workload, trace):
    out = harness.run_cell(workload, 2 ** 31 + 7, 0.2, trace, device="cpu",
                           overrides=OVERRIDES[workload], trace_steps=2)
    cell = harness.Cell(workload)
    _check_line(out, cell, trace)
    if trace:
        assert {"data_phase_s", "precompute_s"} <= set(out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        names = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in names and len(names) >= 2
        # on the CPU there is no device peak to read
        assert set(out["metrics"]) == names - {"peak_device_gib"}


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
