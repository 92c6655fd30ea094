"""One run of a benchmark cell: the inputs from the seed, the program's
set-up, the checked first steps, the timed window, the optional traced
stretch, the comparison with the plain reference, and the result.

Everything is found by name: the cell in BENCHMARK.json, its configuration
in ``configs/<config>.json``, its traffic in ``traffic/<traffic>.json``
(whose ``generator`` names ``generators/<generator>.py``), each metric in
``metrics/<metric>.py`` and each cell's limits in ``limits/<cell>.json``.

The program is driven as its batch CLI (``cli.shine_batch``) drives it:
``data.dataset.LiDARDataset`` over the scans, ``trainer.init_params``,
``TrainSettings.from_config``, ``init_opt_state``, ``pool_to_device``,
``precompute_pool_lookups`` and chunks of ``scan_chunk`` steps of
``trainer.train_chunk`` on iid batches.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (HERE, os.path.join(HERE, "generators")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
B1 = 0.9
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


def chunk_seed(seed: int, start: int) -> int:
    """The batch generator's seed of the chunk starting at step ``start``."""
    return int(np.random.SeedSequence([seed, start, 0xBA7C]).generate_state(1, np.uint64)[0] >> 1)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


class Cell:
    """A cell's specification: BENCHMARK.json's entry, its configuration,
    traffic and limits, with ``overrides`` ({"config": ..., "traffic": ...},
    merged in; the CPU tests' small sizes)."""

    def __init__(self, workload: str, overrides: dict | None = None):
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


class Program:
    """The system under test: set up as the batch CLI sets it up, then
    stepped in chunks of ``scan_chunk``."""

    def __init__(self, cell: Cell, seed: int, device: str, tmp: str):
        import torch

        from shine_mapping_tpu_torch.cli.common import build_grid, pool_capacity_for
        from shine_mapping_tpu_torch.data.dataset import LiDARDataset
        from shine_mapping_tpu_torch.train import trainer
        from shine_mapping_tpu_torch.train.optimizer import init_opt_state

        import weights

        self.seed, self.device, self.timers = seed, device, {}
        t = time.perf_counter()
        gen_mod = load_module("generators", cell.traffic["generator"])
        self.data = gen_mod.generate(tmp, cell.traffic, seed, device)
        _sync(device)
        self.timers["scans"] = time.perf_counter() - t
        if device.startswith("cuda"):  # the program's peak, not the scan writer's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg = self.cfg = make_config(cell, self.data, tmp, seed, device)

        self.grid = grid = build_grid(cfg)
        self.dataset = ds = LiDARDataset(cfg, grid)
        t = time.perf_counter()
        if cfg.num_workers > 1:
            ds.process_frames_pipelined(ds.frame_ids(), cfg.num_workers)
        else:
            for f in ds.frame_ids():
                ds.process_frame(f)
        _sync(device)
        self.timers["data"] = time.perf_counter() - t
        ds.finalize_pool()

        self.params = trainer.init_params(cfg, grid, torch.Generator(device).manual_seed(seed))
        weights.write_into(self.params, grid, cfg, seed)
        self.settings = trainer.TrainSettings.from_config(
            cfg, grid.levels, n_used=trainer.used_rows_for(grid, granularity=64))
        self.opt = init_opt_state(self.params, moments_bf16=(
            cfg.moments_bf16 and trainer.resolve_feature_update(self.settings) == "pallas"))

        t = time.perf_counter()
        n = len(ds.pool)
        self.subset = None
        if n > cfg.max_device_pool and not cfg.ray_loss:
            # the CLI's first rotating sub-pool (it rotates every
            # pool_rotate_iters steps, past any window)
            self.subset = np.random.default_rng(cfg.seed + 1).integers(0, n, cfg.max_device_pool)
            self.pool, self.n_valid = trainer.pool_to_device(
                ds.pool, cfg.max_device_pool, device, self.subset, self.settings)
        else:
            self.pool, self.n_valid = trainer.pool_to_device(
                ds.pool, pool_capacity_for(n, cfg.init_pool_capacity), device,
                settings=self.settings)
        _sync(device)
        self.timers["upload"] = time.perf_counter() - t
        t = time.perf_counter()
        self.pre = trainer.precompute_pool_lookups(
            grid.tables, self.pool["coord"], grid.levels, [f.shape[0] for f in grid.features])
        _sync(device)
        self.timers["precompute"] = time.perf_counter() - t
        self.step = 0

    def chunk(self, n: int):
        """``n`` steps of ``train_chunk`` on iid batches from this chunk's
        generator; returns the chunk's aux (its losses)."""
        import torch

        from shine_mapping_tpu_torch.train import trainer

        gen = torch.Generator(self.device).manual_seed(chunk_seed(self.seed, self.step))
        self.params, self.opt, aux = trainer.train_chunk(
            self.params, self.opt, self.grid.tables, self.pool, self.n_valid, self.step, gen,
            self.settings, n, pre_lookups=self.pre)
        self.step += n
        return aux

    def leaves(self, state: dict) -> dict:
        from shine_mapping_tpu_torch.train.optimizer import FEATURES

        out = {k: v for k, v in state.items() if k != FEATURES and not hasattr(v, "named_parameters")}
        for k, mod in state.items():
            if hasattr(mod, "named_parameters"):
                out.update({f"{k}.{n}": p for n, p in mod.named_parameters()})
        out.update({f"features.{i}": t for i, t in enumerate(state[FEATURES])})
        return out

    def work(self) -> dict:
        """Counts of one step's work for the roofline shares."""
        cfg, s = self.cfg, self.settings
        found = [float(f[: self.n_valid].float().mean()) for _, f in self.pre]
        dims = [cfg.feature_dim] + [cfg.geo_mlp_hidden_dim] * cfg.geo_mlp_level + [1]
        return {"bs": s.bs, "levels": len(s.levels), "dim": cfg.feature_dim,
                "used_rows": int(sum(self.grid.corner_counts)),
                "used_rows_by_level": list(self.grid.corner_counts),
                "found_share_by_level": found,
                "found_entries": sum(found) * s.bs * 8, "decoder_dims": dims,
                "eikonal": bool(s.ekional_loss_on), "pool_samples": len(self.dataset.pool),
                "device_pool": int(self.n_valid)}

    def free(self):
        import torch

        for k in ("params", "opt", "pre", "pool", "grid"):
            setattr(self, k, None)
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()


def sq_norm(t) -> float:
    """Squared norm in float64, a million rows at a time (no whole-table
    float64 copy to raise the peak)."""
    import torch

    t = t.detach().reshape(t.shape[0], -1) if t.dim() else t.detach().reshape(1, 1)
    return sum(float(torch.sum(t[a:a + (1 << 20)].double() ** 2))
               for a in range(0, t.shape[0], 1 << 20))


def checked_steps(prog: Program, n_steps: int = 3) -> dict:
    """The program's first ``n_steps`` steps, one call each through the
    window's own ``train_chunk``: each step's loss, the first gradient of
    every leaf (from Adam's first moment after step 1, m = (1 - b1) g), and
    each leaf's change over the steps (against the benchmark's weights)."""
    import torch

    import weights

    out = {"loss": []}
    for k in range(n_steps):
        aux = prog.chunk(1)
        out["loss"].append(float(aux["last"]["total_loss"]))
        if k == 0:
            m = prog.leaves(prog.opt.m)
            out["grad"] = {name: math.sqrt(sq_norm(t)) / (1.0 - B1) for name, t in m.items()}
    cfg = prog.cfg
    p = prog.leaves(prog.params)
    p0 = weights.decoder_values(prog.seed, weights.decoder_layout(cfg), prog.device)
    change = {}
    for name, t in p.items():
        if name.startswith("features."):
            i = int(name.split(".")[1])
            hl = prog.grid.host_levels[i]
            keys = torch.from_numpy(hl.corner_keys_sorted).to(t.device)
            rows = torch.from_numpy(hl.corner_rows_sorted.astype(np.int64)).to(t.device)
            sq = sq_norm(t)
            for a in range(0, rows.numel(), 1 << 20):
                r = rows[a:a + (1 << 20)]
                v0 = weights.table_values(prog.seed, int(hl.level), keys[a:a + (1 << 20)],
                                          t.shape[1], cfg.feature_std)
                pr = t[r].double()
                sq += float(torch.sum((pr - v0.double()) ** 2) - torch.sum(pr ** 2))
            change[name] = math.sqrt(max(sq, 0.0))
        else:
            base = p0[name] if name in p0 else torch.ones_like(t)  # sigma starts at 1
            change[name] = float(torch.linalg.vector_norm((t.detach() - base).double()))
    out["change"] = change
    return out


def reference_readings(prog: Program, n_steps: int = 3, **variant) -> dict:
    """The plain reference over the same inputs: its own octree from the
    pool's surface samples, the benchmark's weights, the same batches."""
    import torch

    import weights
    from reference import train_ref

    cfg, dev = prog.cfg, prog.device
    spec = train_ref.spec_of(cfg)
    pool = prog.dataset.pool
    surf = torch.from_numpy(pool.coord[pool.weight > 0]).to(dev)
    structure = train_ref.build_structure(surf, spec["levels"])
    del surf
    tables = [weights.table_values(prog.seed, lvl, corners, cfg.feature_dim, cfg.feature_std)
              for lvl, (_, corners) in zip(spec["levels"], structure)]
    dec = weights.decoder_values(prog.seed, weights.decoder_layout(cfg), dev)
    ref = train_ref.ReferenceTrainer(spec, structure, tables, dec, **variant)
    del tables
    fields = {k: getattr(pool, k) for k in ("coord", "sdf_label", "weight")}
    out = {"loss": []}
    p0 = {k: v.clone() for k, v in ref.p.items()}
    for k in range(n_steps):
        gen = torch.Generator(dev).manual_seed(chunk_seed(prog.seed, k))
        idx = torch.randint(0, int(prog.n_valid), (spec["bs"],), generator=gen, device=dev)
        ih = idx.cpu().numpy()
        if prog.subset is not None:  # the device pool is the host pool's sub-pool
            ih = prog.subset[ih]
        batch = {f: torch.from_numpy(np.ascontiguousarray(a[ih])).to(dev)
                 for f, a in fields.items()}
        loss, grads = ref.step(batch)
        out["loss"].append(loss)
        if k == 0:
            out["grad"] = train_ref.norms(grads)
    out["change"] = train_ref.norms({k: ref.p[k] - p0[k] for k in ref.p})
    return out


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap, and by the
    worst leaf the gap of the first gradient's norm and of the change's norm
    over the steps, each against the reference's norm of that leaf or of
    the median leaf, whichever is larger.  Leaves whose reference gradient
    is under a thousandth of the median leaf's are left out of the change
    (Adam moves them by round-off alone)."""
    from reference.train_ref import median

    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    mg = median(ref["grad"].values())
    grad = max(abs(prog["grad"][k] - r) / max(r, mg) for k, r in ref["grad"].items())
    moved = [k for k, r in ref["grad"].items() if r >= 1e-3 * mg]
    mc = median([ref["change"][k] for k in moved])
    change = max(abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], mc)
                 for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def data_readings(prog: Program, frames: int = 4) -> dict:
    from reference import data_ref

    cfg, ds = prog.cfg, prog.dataset
    ids = ds.frame_ids()
    pick = sorted(np.random.default_rng(prog.seed).choice(len(ids), min(frames, len(ids)),
                                                          replace=False))
    c = dict(min_z=cfg.min_z, max_z=cfg.max_z, min_range=cfg.min_range,
             pc_radius=cfg.pc_radius, vox_down_m=cfg.vox_down_m, scale=cfg.scale,
             surface_n=cfg.surface_sample_n, clearance_n=cfg.clearance_sample_n,
             free_n=cfg.free_sample_n)
    files = sorted(os.path.join(cfg.pc_path, f) for f in os.listdir(cfg.pc_path))
    pool = {k: getattr(ds.pool, k) for k in ("coord", "sdf_label", "weight", "time")}
    return data_ref.check_frames(pool, files, cfg.pose_path, [ids[i] for i in pick], c)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at most its limit."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    return ok, shown


def trace_stretch(prog: Program, steps: int, tmp: str) -> dict:
    """``steps`` steps in one ``train_chunk`` call under ``torch.profiler``
    (host and device), read from its Chrome trace: every device operation
    (kernels, copies, memsets) with its interval, the launch calls, and the
    idle gaps between device operations by the host operation that launched
    the operation ending the gap."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if prog.device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    _sync(prog.device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        aux = prog.chunk(steps)
        float(aux["mean"]["total_loss"])
        _sync(prog.device)
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


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, t_start: float | None = None,
             trace_steps: int = 20) -> dict:
    """One run; returns the result line's object (and prints each number
    compared beside its limit on standard error)."""
    import torch

    t_start = time.time() if t_start is None else t_start
    cell = Cell(workload, overrides)
    tmp = tempfile.mkdtemp(prefix="shine-bench-")
    try:
        prog = Program(cell, seed, device, tmp)
        t = time.perf_counter()
        checked = checked_steps(prog)
        prog.timers["checked_steps"] = time.perf_counter() - t
        chunk = int(prog.cfg.scan_chunk)
        t = time.perf_counter()
        float(prog.chunk(chunk)["mean"]["total_loss"])  # warm chunk: the window's shapes
        _sync(device)
        prog.timers["warm_chunk"] = time.perf_counter() - t
        rec = {"setup_s": time.time() - t_start, "timers": prog.timers}
        # the window: whole chunks until --seconds have passed, each read back
        # the dispatching thread's CPU seconds beside the host clock, on standard error
        c0, t0, steps, marks, cpu_marks = time.thread_time(), time.perf_counter(), 0, [], []
        while True:
            float(prog.chunk(chunk)["mean"]["total_loss"])
            steps += chunk
            marks.append(time.perf_counter() - t0)
            cpu_marks.append(time.thread_time() - c0)
            if marks[-1] >= seconds:
                break
        _sync(device)
        rec["window_s"] = time.perf_counter() - t0
        rec["samples"] = steps * prog.settings.bs
        rec["step_s"] = rec["window_s"] / steps
        cuda = device.startswith("cuda")
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
        rec["device_kind"] = torch.cuda.get_device_name(0) if cuda else "cpu"
        if trace:
            rec["trace"] = trace_stretch(prog, trace_steps, tmp)
            rec["work"] = prog.work()
        # the comparison, once the program's state is freed
        prog.free()
        t = time.perf_counter()
        numbers = gaps(checked, reference_readings(prog))
        numbers.update(data_readings(prog))
        print(f"set-up stages (s): {json.dumps(prog.timers)}; pool {len(prog.dataset.pool)} "
              f"samples, device pool {prog.n_valid}; window {rec['window_s']:.3f} s, "
              f"{steps} steps, chunks ended at {[round(m, 3) for m in marks]} s "
              f"(thread CPU {[round(m, 3) for m in cpu_marks]} s); reference {time.perf_counter() - t:.3f} s; program readings "
              f"{json.dumps(checked)}", file=sys.stderr)
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
