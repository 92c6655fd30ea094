"""Shared driver plumbing for the batch and incremental CLIs.

Port of ``shine_mapping_tpu/cli/common.py``.  Its ``device_local`` fetches
a single controller's sharded arrays to the host; the port's ranks each
hold their own tensors (the row-sharded tables are gathered by
``sync_features_to_grid``), so it has no counterpart here.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import SHINEConfig
from ..ops.hashgrid import HashGridHost
from ..train.optimizer import FEATURES, OptState
from ..utils import checkpoint as ckpt


def torch_device_of(cfg: SHINEConfig) -> torch.device:
    """The entry point's device, ``setting.device``; raises when it is the
    card and there is none (a driver never carries on on the CPU unless the
    config says ``cpu``)."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"setting.device is {cfg.device!r} but no CUDA device is "
                           "available; set setting.device: cpu to run on the CPU")
    return device


def _rank_entry(i: int, launch, run, cfg: SHINEConfig, config_path, out_file: str) -> None:
    """Local rank ``i`` of this process's ranks (``launch``, a
    ``parallel.mesh.Launch``) running the driver ``run``; local rank 0
    writes the run path it got from global rank 0."""
    from ..parallel import mesh as pmesh

    device = pmesh.rank_device(cfg, i)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    pmesh.setup_distributed(cfg, launch.backend, launch.init_method, launch.rank(i),
                            launch.world)
    try:
        run_path, _, _ = run(config_path, cfg, group=pmesh.data_group(device))
        if i == 0:
            with open(out_file, "w") as f:
                f.write(run_path)
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(run, cfg: SHINEConfig, config_path, launch):
    """Run the driver ``run`` on this process's ``launch.local`` ranks
    (``launch``: ``parallel.mesh.launch_plan``'s; ``torch.multiprocessing``,
    start method spawn; local rank i on ``cuda:i``, or all on the one card
    over gloo, or the CPU); returns global rank 0's run directory (the
    others' artifacts are rank 0's)."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/run_path"
        mp.start_processes(_rank_entry, args=(launch, run, cfg, config_path, out),
                           nprocs=launch.local, start_method="spawn", join=True)
        with open(out) as f:
            return f.read()


def join_ranks(cfg: SHINEConfig, launch, backend=None):
    """This process's :class:`~..parallel.mesh.DataGroup` when ``launch``
    (``parallel.mesh.launch_plan``'s, one local rank) or torchrun's
    environment (``launch`` None) joins it to ranks launched apart, else
    None."""
    from ..parallel import mesh as pmesh

    if launch is None:
        rank, world = pmesh.setup_distributed(cfg, backend)
    else:
        rank, world = pmesh.setup_distributed(cfg, launch.backend, launch.init_method,
                                              launch.rank(0), launch.world)
    if world <= 1:
        return None
    device = pmesh.rank_device(cfg, int(os.environ.get("LOCAL_RANK", rank)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return pmesh.data_group(device)


def seed_for(*keys: int) -> int:
    """A generator seed drawn from ``keys`` (the config seed and a chunk's
    start iteration or a frame, ...), so a resumed run draws what an
    uninterrupted one would (JAX ``fold_in``)."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0] >> 1)


def build_grid(cfg: SHINEConfig) -> HashGridHost:
    return HashGridHost(
        max_level=cfg.tree_level_world,
        featured_level_num=cfg.tree_level_feat,
        feature_dim=cfg.feature_dim,
        feature_std=cfg.feature_std,
        polynomial_interpolation=cfg.poly_int_on,
        leaf_vox_size=cfg.leaf_vox_size,
        seed=cfg.seed,
        init_node_capacity=cfg.init_node_capacity,
        init_corner_capacity=cfg.init_corner_capacity,
        device=cfg.device,
    )


def maybe_load_model(cfg: SHINEConfig, grid: HashGridHost):
    """Load a saved model BEFORE the data phase (the reference's
    shine_batch.py:45-55 ordering): a full ``.npz`` checkpoint restores the
    whole map structure (which then keeps growing from new frames), its
    decoders, its optimizer moments and its iteration, so a resumed run
    continues the Adam trajectory and the LR schedule; a decoders-only file
    loads the decoders.

    Returns (grid, decoders or None, freeze_decoder, opt_state or None,
    start_iter)."""
    if not (cfg.load_model and cfg.model_path and os.path.exists(cfg.model_path)):
        return grid, None, False, None, 0
    if cfg.model_path.endswith(".npz"):
        d = np.load(cfg.model_path, allow_pickle=False)
        if any(k.startswith("grid_") for k in d.files):
            from ..train import trainer
            from ..train.optimizer import init_opt_state

            skeleton = trainer.init_params(cfg, grid)
            grid2, params2, opt_state, iters = ckpt.load_checkpoint(
                cfg.model_path, skeleton, init_opt_state(skeleton), device=cfg.device)
            grid2.print_detail()
            print(f"Full checkpoint loaded (iter {iters})")
            dec = {k: params2[k] for k in ("geo", "sem")}
            return grid2, dec, True, opt_state, iters
    if cfg.model_path.endswith((".npz", ".pth")):
        dec = ckpt.load_decoders(cfg.model_path, {}, device=cfg.device)
        print("Pretrained decoder loaded")
        return grid, dec, True, None, 0
    return grid, None, False, None, 0


def pad_opt_state_features(opt_state: OptState, params) -> OptState:
    """Grow the restored optimizer's feature-moment tables to the current
    (possibly doubled) capacities; new rows start at zero like fresh Adam."""

    def pad_like(o, p):
        if o.shape == p.shape:
            return o
        out = torch.zeros(p.shape, dtype=o.dtype, device=o.device)
        out[: o.shape[0]] = o
        return out

    m, v = dict(opt_state.m), dict(opt_state.v)
    m[FEATURES] = [pad_like(o, p) for o, p in zip(m[FEATURES], params[FEATURES])]
    v[FEATURES] = [pad_like(o, p) for o, p in zip(v[FEATURES], params[FEATURES])]
    return OptState(m=m, v=v, step=opt_state.step)


def pool_capacity_for(n: int, minimum: int) -> int:
    cap = max(minimum, 1024)
    while cap < n:
        cap *= 2
    return cap


def event_boundaries(total_iters: int, freqs, chunk: int):
    """Yield (start, n_iters) chunks that never cross a save/mesh boundary."""
    events = set()
    for f in freqs:
        if f and f > 0:
            events.update(range(f, total_iters + 1, f))
    events.add(total_iters)
    start = 0
    for e in sorted(events):
        while start < e:
            n = min(chunk, e - start)
            yield start, n
            start += n


def sync_features_to_grid(grid: HashGridHost, params, group=None) -> None:
    """Point the grid at the trained tables, as training holds them: the
    port trains the grid's own tensors in place, bf16 tables included (the
    mesher widens gathered rows, ``state_dict`` writes the exact f32
    upcast), so no table is copied.  Row-sharded tables (``group``'s
    layout ``rows``) are gathered whole on every rank first (one gather a
    level)."""
    if group is not None and group.world > 1 and group.table_sharding == "rows":
        from ..parallel.mesh import gather_table_rows

        grid.features = gather_table_rows(group, params[FEATURES])
        return
    grid.features = list(params[FEATURES])


def refresh_params_features(grid: HashGridHost, params):
    return dict(params, features=list(grid.features))
