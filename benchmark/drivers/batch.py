"""The batch driver: the program set up and stepped as its batch CLI
(``cli.shine_batch``) drives it.  ``data.dataset.LiDARDataset`` over every
scan, ``trainer.init_params``, ``TrainSettings.from_config``,
``init_opt_state``, ``pool_to_device``, ``precompute_pool_lookups``, then
``trainer.train_chunk`` on iid batches; a timed unit is a chunk of
``scan_chunk`` steps.

The functions ``harness.run_cell`` calls, as every driver gives them:
``setup``, ``check``, ``warm``, ``unit``, ``stretch``, ``work``, ``free``
and ``compare``; and the optional ones: ``control`` (``control.py``'s
readings: the program, the TF32 control, the half-batch fault, the data
stage's bfloat16 control), ``sequential_data`` and ``ab_steps``
(``stages.py``'s).  A unit is a chunk of ``scan_chunk`` steps, and so is
``stretch(prog, n)`` a chunk of ``n``.
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

from harness import _sync, load_module, make_config, spans_of

B1 = 0.9


def chunk_seed(seed: int, start: int) -> int:
    """The batch generator's seed of the chunk starting at step ``start``."""
    return int(np.random.SeedSequence([seed, start, 0xBA7C]).generate_state(1, np.uint64)[0] >> 1)


class Program:
    """The system under test: set up as the batch CLI sets it up, then
    stepped in chunks of ``scan_chunk``."""

    def __init__(self, cell, seed: int, device: str, tmp: str):
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


# the driver's functions


setup, check, work, free = Program, checked_steps, Program.work, Program.free


def _chunk(prog: Program, n: int) -> None:
    float(prog.chunk(n)["mean"]["total_loss"])  # read back: the chunk has run


def warm(prog: Program) -> None:
    """One chunk: the window's shapes (and, on the card, its recording)."""
    _chunk(prog, int(prog.cfg.scan_chunk))


def unit(prog: Program) -> tuple:
    """One chunk of ``scan_chunk`` steps: (steps, batch samples)."""
    n = int(prog.cfg.scan_chunk)
    _chunk(prog, n)
    return n, n * prog.settings.bs


def stretch(prog: Program, n: int) -> None:
    """``n`` steps in one ``train_chunk`` call."""
    _chunk(prog, n)


def compare(prog: Program, checked: dict) -> dict:
    """The reference's steps against the checked ones, then the data stage."""
    numbers = gaps(checked, reference_readings(prog))
    numbers.update(data_readings(prog))
    print(f"pool {len(prog.dataset.pool)} samples, device pool {prog.n_valid}", file=sys.stderr)
    return numbers


def control(prog: Program, checked: dict) -> dict:
    """The readings the limits are set from, on a freed program: the
    program against the plain reference (``program``, the lower readings);
    the control, the reference computed with TF32 matrix products, one
    precision below the configuration's float32, in the program's place
    (``control_tf32``); a planted fault, the reference with half of each
    batch left out, the mean taken over the rest (``fault_half_batch``);
    and the data stage's control, the pool's coordinates and labels held in
    bfloat16, one precision below its float32 (``control_bf16_pool``)."""
    ref = reference_readings(prog)
    out = {"program": gaps(checked, ref),
           "control_tf32": gaps(reference_readings(prog, tf32=True), ref),
           "fault_half_batch": gaps(reference_readings(prog, half_batch=True), ref)}
    out["program"].update(data_readings(prog))
    pool = prog.dataset.pool
    kept = pool.coord, pool.sdf_label
    pool.coord, pool.sdf_label = (_bf16(a) for a in kept)
    out["control_bf16_pool"] = data_readings(prog)
    pool.coord, pool.sdf_label = kept
    return out


def _bf16(a):
    import torch

    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def sequential_data(prog: Program) -> dict:
    """The data phase again on the main thread alone (``process_frame``),
    tracing on: the frames, the ``data.*`` spans summed by name and the
    phase's host seconds.  On one core the pipelined phase's spans hold each
    other's time; these do not."""
    from shine_mapping_tpu_torch.cli.common import build_grid
    from shine_mapping_tpu_torch.data.dataset import LiDARDataset

    with spans_of(True, "data.") as sp:
        ds = LiDARDataset(prog.cfg, build_grid(prog.cfg))
        t0 = time.perf_counter()
        for f in ds.frame_ids():
            ds.process_frame(f)
        dt = time.perf_counter() - t0
    return {"frames": len(ds.frame_ids()), "setup_spans_sequential": sp, "data_s_sequential": dt}


def ab_steps(prog: Program) -> int:
    """The steps of one of ``stages.py``'s tracing off / on rounds: a unit's
    chunk."""
    return int(prog.cfg.scan_chunk)
