"""The port's stage spans (``utils.profiling.span``): nothing recorded and no
torch call while tracing is off, parents by thread, ``user_annotation``
events under ``torch.profiler``, the step's and the data phase's spans where
they belong, and training that tracing leaves bit-identical."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from shine_mapping_tpu_torch.config import SHINEConfig
from shine_mapping_tpu_torch.data.dataset import LiDARDataset
from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
from shine_mapping_tpu_torch.train import trainer
from shine_mapping_tpu_torch.train.optimizer import FEATURES, init_opt_state
from shine_mapping_tpu_torch.utils import profiling
from shine_mapping_tpu_torch.utils.profiling import span
from tests import synth
from tests.graph_stand_in import stand_in_graph  # noqa: F401  (a fixture)

STAGES = ("step.forward", "step.backward", "step.update")


@pytest.fixture(autouse=True)
def _fresh_spans():
    was = profiling.tracing(False)
    profiling.clear_spans()
    yield
    profiling.tracing(was)
    profiling.clear_spans()


def _cfg(root):
    cfg = SHINEConfig()
    cfg.pc_path = os.path.join(root, "velodyne")
    cfg.pose_path = os.path.join(root, "poses.txt")
    cfg.calib_path = os.path.join(root, "calib.txt")
    cfg.first_frame_ref = False
    cfg.pc_radius = 20.0
    cfg.min_range = 0.5
    cfg.min_z = -3.0
    cfg.rand_downsample = False
    cfg.vox_down_m = 0.15
    cfg.tree_level_world = 8
    cfg.tree_level_feat = 3
    cfg.leaf_vox_size = 0.5
    cfg.surface_sample_n = 3
    cfg.free_sample_n = 2
    cfg.bs = 128
    cfg.ekional_loss_on = True
    cfg.weight_e = 0.1
    cfg.derive()
    return cfg


def _grid(cfg):
    return HashGridHost(max_level=cfg.tree_level_world, featured_level_num=cfg.tree_level_feat,
                        feature_dim=cfg.feature_dim, feature_std=cfg.feature_std,
                        leaf_vox_size=cfg.leaf_vox_size, seed=cfg.seed,
                        init_node_capacity=1 << 12, init_corner_capacity=1 << 12,
                        device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spans_world"))
    synth.make_kitti_dataset(root, n_frames=3)
    return root


@pytest.fixture(scope="module")
def mapped(world):
    cfg = _cfg(world)
    grid = _grid(cfg)
    ds = LiDARDataset(cfg, grid)
    for f in ds.frame_ids():
        ds.process_frame(f)
    return cfg, grid, ds.pool


def _train(mapped, mode, steps=3):
    """``steps`` steps of ``train_chunk`` from the same start every call
    (the grid's tables copied); returns (params, opt state, aux)."""
    cfg, grid, pool = mapped
    s = trainer.TrainSettings.from_config(cfg, grid.levels, feature_update=mode,
                                          n_used=trainer.used_rows_for(grid))
    params = trainer.init_params(cfg, grid, torch.Generator("cpu").manual_seed(3))
    params[FEATURES] = [f.clone() for f in grid.features]
    opt = init_opt_state(params)
    dev, n = trainer.pool_to_device(pool, len(pool), device="cpu")
    gen = torch.Generator("cpu").manual_seed(11)
    params, opt, aux = trainer.train_chunk(params, opt, grid.tables, dev, n, 0, gen, s, steps)
    return params, opt, aux


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "named_parameters"):
        return [p for _, p in sorted(tree.named_parameters())]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _flat(x)]
    if dataclasses.is_dataclass(tree):  # the optimizer state: its moments
        return _flat({f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)})
    return []


def test_span_off_records_nothing_and_calls_no_torch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a torch call while tracing is off")

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        monkeypatch.setattr(torch.autograd, "_profiler_enabled", refuse)
        assert span("a") is span("b")  # one shared no-op context
        with span("a"):
            with span("b"):
                pass
    assert profiling.spans() == []


def test_nested_spans_name_their_parents():
    profiling.tracing(True)
    with span("outer"):
        with span("mid"):
            with span("inner"):
                pass
        with span("mid2"):
            pass
    got = [(s.name, s.parent) for s in profiling.spans()]
    assert got == [("inner", "mid"), ("mid", "outer"), ("mid2", "outer"), ("outer", None)]
    by = {s.name: s for s in profiling.spans()}
    assert by["outer"].t0_ns <= by["mid"].t0_ns <= by["inner"].t0_ns
    assert by["inner"].t1_ns <= by["mid"].t1_ns <= by["mid2"].t0_ns <= by["outer"].t1_ns
    assert profiling.tracing(False) is True
    profiling.clear_spans()
    assert profiling.spans() == []


def test_worker_threads_keep_their_own_stacks():
    """Threads whose spans interleave in time each see their own parent."""
    profiling.tracing(True)
    ready, go = threading.Barrier(3), threading.Event()

    def work(k):
        with span(f"w{k}"):
            ready.wait()
            go.wait()
            with span("leaf"):
                pass

    with span("main"):
        ts = [threading.Thread(target=work, args=(k,)) for k in range(2)]
        for t in ts:
            t.start()
        ready.wait()
        with span("main.child"):
            go.set()
            for t in ts:
                t.join()
    got = profiling.spans()
    main_tid = threading.get_ident()
    leaves = [s for s in got if s.name == "leaf"]
    assert sorted(s.parent for s in leaves) == ["w0", "w1"]
    for s in got:
        if s.name.startswith("w"):
            assert s.parent is None and s.tid != main_tid
    assert {(s.name, s.parent, s.tid) for s in got if s.name.startswith("main")} == {
        ("main.child", "main", main_tid), ("main", None, main_tid)}


def test_phase_timer_phase_is_the_parent_span():
    profiling.tracing(True)
    timer = profiling.PhaseTimer()
    with timer.phase("data"):
        with span("data.pool"):
            pass
    assert [(s.name, s.parent) for s in profiling.spans()] == [("data.pool", "data"),
                                                                ("data", None)]
    assert set(timer.summary()) == {"data"}
    assert not hasattr(timer, "means")


def test_device_trace_turns_tracing_on_for_its_block(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with span("chunk"):
            torch.ones(4).mul_(2)
    assert profiling.tracing(False) is False  # restored
    assert [s.name for s in profiling.spans()] == ["chunk"]
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e["name"] == "chunk" for e in events)


@pytest.mark.parametrize("mode", ["pallas", "sparse", "dense"])
def test_train_chunk_is_bit_identical_with_tracing_on(mapped, mode):
    """Tracing on changes no parameter, moment or aux bit, on the kernel,
    lazy and autodiff routes; it records one ``step`` a step, each with
    forward, backward and update in that order, under one ``chunk``."""
    p0, o0, a0 = _train(mapped, mode)
    assert profiling.spans() == []
    profiling.tracing(True)
    p1, o1, a1 = _train(mapped, mode)
    profiling.tracing(False)
    for x, y in zip(_flat(p0) + _flat(o0) + _flat(a0), _flat(p1) + _flat(o1) + _flat(a1)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert len(_flat(p0)) == len(_flat(p1)) > 3 and len(_flat(a0)) == len(_flat(a1)) > 0
    assert len(_flat(o0)) == len(_flat(o1)) == 2 * len(_flat(p0)) and o0.step == o1.step == 3
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == (
        [(n, "step") for n in STAGES] + [("step", "chunk")]) * 3 + [("chunk", None)]
    for k in range(3):
        f, b, u, st = got[4 * k:4 * k + 4]
        assert st.t0_ns <= f.t0_ns <= f.t1_ns <= b.t0_ns <= b.t1_ns <= u.t0_ns <= u.t1_ns
        assert u.t1_ns <= st.t1_ns


def test_step_spans_enclose_their_stage_ops_under_the_profiler(mapped, tmp_path):
    """Under a CPU ``torch.profiler`` the stages are ``user_annotation``
    events: the draw runs in the forward, autograd's ops in the backward,
    Adam's in the update, and every op of a step lies in one of its three."""
    profiling.tracing(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train(mapped, "pallas", steps=2)
    profiling.tracing(False)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    def spans_of(name):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                if e.get("cat") == "user_annotation" and e["name"] == name]

    stage = {n: spans_of(n) for n in STAGES}
    steps = spans_of("step")
    assert len(steps) == 2 and all(len(v) == 2 for v in stage.values())
    assert len(spans_of("chunk")) == 1

    def where(ts):
        return [n for n, iv in stage.items() if any(a <= ts <= b for a, b in iv)]

    ops = [e for e in events if e.get("cat") == "cpu_op"]
    in_steps = [e for e in ops if any(a <= float(e["ts"]) <= b for a, b in steps)]
    assert in_steps and all(len(where(float(e["ts"]))) == 1 for e in in_steps)
    seen = {n: {e["name"] for e in in_steps if where(float(e["ts"])) == [n]} for n in STAGES}
    assert "aten::randint" in seen["step.forward"]
    assert any("Backward" in n for n in seen["step.backward"])
    assert "aten::sqrt" in seen["step.update"]  # Adam's denominators
    assert "aten::randint" not in seen["step.backward"] | seen["step.update"]


def test_pipelined_data_phase_records_each_stage(world):
    """One ``data.prep`` a frame on the workers, and a wait, an octree
    growth and a pool append a frame on the main thread; the pool and the
    tables as with tracing off."""
    def run():
        cfg = _cfg(world)
        grid = _grid(cfg)
        ds = LiDARDataset(cfg, grid)
        ds.process_frames_pipelined(ds.frame_ids(), workers=2)
        return ds, grid

    ds0, g0 = run()
    profiling.tracing(True)
    ds1, g1 = run()
    profiling.tracing(False)
    n = len(ds1.frame_ids())
    got = profiling.spans()
    main_tid = threading.get_ident()
    by = {k: [s for s in got if s.name == k]
          for k in ("data.prep", "data.wait", "data.octree", "data.pool")}
    assert sum(len(v) for v in by.values()) == len(got)
    assert all(len(v) == n for v in by.values())
    assert all(s.tid != main_tid and s.parent is None for s in by["data.prep"])
    for k in ("data.wait", "data.octree", "data.pool"):
        assert all(s.tid == main_tid and s.parent is None for s in by[k])
    np.testing.assert_array_equal(ds0.pool.coord, ds1.pool.coord)
    np.testing.assert_array_equal(ds0.pool.sdf_label, ds1.pool.sdf_label)
    assert g0.corner_counts == g1.corner_counts


def test_replayed_steps_record_one_replay_span_and_no_stages(mapped, stand_in_graph):
    """A traced chunk through the recorded step (on the CPU the stand-in of
    ``tests.graph_stand_in``, which runs the body untraced at each replay):
    the key's first step is eager with its three stages; each later step
    records one ``step.replay`` under its ``step``, and the replayed steps
    no stage."""
    cfg, grid, pool = mapped
    s = trainer.TrainSettings.from_config(cfg, grid.levels, feature_update="pallas",
                                          n_used=trainer.used_rows_for(grid))
    params = trainer.init_params(cfg, grid, torch.Generator("cpu").manual_seed(3))
    params[FEATURES] = [f.clone() for f in grid.features]
    dev, n = trainer.pool_to_device(pool, len(pool), device="cpu")
    pre = trainer.precompute_pool_lookups(grid.tables, dev["coord"], grid.levels,
                                          [f.shape[0] for f in grid.features])
    profiling.tracing(True)
    trainer.train_chunk(params, init_opt_state(params), grid.tables, dev, n, 0,
                        torch.Generator("cpu").manual_seed(11), s, 4, pre_lookups=pre)
    profiling.tracing(False)
    assert trainer.GRAPH_COUNTS == {"eager": 1, "captured": 1, "replayed": 3}
    got = profiling.spans()
    steps = [sp for sp in got if sp.name == "step"]
    assert len(steps) == 4

    def within(k):
        return [sp.name for sp in got if sp.parent == "step"
                and steps[k].t0_ns <= sp.t0_ns <= sp.t1_ns <= steps[k].t1_ns]

    assert within(0) == list(STAGES)
    assert within(1)[-1] == "step.replay"  # the recording step also replays
    assert within(2) == within(3) == ["step.replay"]
    assert [sp.name for sp in got].count("step.replay") == 3
