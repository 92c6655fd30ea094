"""Rank bodies of the port's multi-rank tests (``tests/test_torch_dist*.py``).

The tests spawn their ranks (``torch.multiprocessing``, start method
``spawn``), and a spawned rank imports the module that holds its body, so
this module imports torch and the port only, never jax: the tests' own
process has JAX on 8 virtual devices (``tests/conftest.py``).  Its one test
checks that.  Each body joins a gloo group on ``tcp://localhost:<port>``,
runs its cases and leaves rank 0's results in a file (``torch.save``).
"""

import os
import subprocess
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from shine_mapping_tpu_torch import interop
from shine_mapping_tpu_torch.parallel import comm, mesh
from shine_mapping_tpu_torch.train import trainer
from shine_mapping_tpu_torch.train.optimizer import FEATURES, init_opt_state

WORLD = 2


def spawn(body, *args, world: int = WORLD) -> None:
    """Run ``body(rank, world, port, *args)`` in ``world`` spawned ranks."""
    mp.start_processes(body, args=(world, mesh.free_port()) + args, nprocs=world,
                       start_method="spawn", join=True)


def _join(rank, world, port):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    return mesh.data_group("cpu")


def _whole(grp, tables, rows: bool):
    return [t.clone() for t in (mesh.gather_table_rows(grp, tables) if rows else tables)]


def train_cases(rank, world, port, spec_path, out_path):
    """Every case of ``spec_path`` (a ``torch.save`` of ``{"world": the
    port's tables, pool, lookups; "cases": [...]}``) on this rank; rank 0
    saves ``{name: {"params", "opt", "aux", "replicas_equal"}}`` with the
    tables whole (JAX layout, numpy)."""
    grp = _join(rank, world, port)
    spec = torch.load(spec_path, weights_only=False)
    w = spec["world"]
    out = {}
    for case in spec["cases"]:
        s = case["settings"]
        params = interop.params_from_jax(case["params_np"], device="cpu")
        if case.get("bf16_tables"):
            params[FEATURES] = [f.to(torch.bfloat16) for f in params[FEATURES]]
        opt = init_opt_state(params, moments_bf16=case.get("bf16_moments", False))
        rows = case["layout"] == "rows"
        params, opt, _ = mesh.place_training_state(grp, params, opt,
                                                   table_sharding=case["layout"])
        shapes = [tuple(f.shape) for f in case["params_np"]["features"]]
        win = None
        if case.get("window_idx") is not None:
            win = trainer.precompute_batch_windows(
                w["pre"], w["n_valid"], None, s, shapes, fused=True,
                window_indices=torch.from_numpy(case["window_idx"]),
                shards=world if rows else 0, deterministic=not rows)
            if rows:
                win = mesh.place_routed_windows(grp, win)
        bi = case.get("batch_indices")
        comm.reset_counts()
        params, opt, aux = trainer.train_chunk(
            params, opt, w["tables"], w["pool"], w["n_valid"], 0, None, s, case["steps"],
            group=grp, pre_lookups=w["pre"], batch_windows=win,
            batch_indices=None if bi is None else torch.from_numpy(bi))
        same = None if rows else mesh.replicas_equal(grp, mesh.state_tensors(params, opt))
        feats = _whole(grp, params[FEATURES], rows)
        m = _whole(grp, opt.m[FEATURES], rows)
        v = _whole(grp, opt.v[FEATURES], rows)
        if rank == 0:
            params = dict(params, **{FEATURES: feats})
            opt.m[FEATURES], opt.v[FEATURES] = m, v
            out[case["name"]] = {
                "params": interop.params_to_jax(params), "opt": interop.opt_state_to_jax(opt),
                "aux": {k: {n: float(a) for n, a in d.items()} for k, d in aux.items()},
                "replicas_equal": same, "comm": {k: list(c) for k, c in comm.COUNTS.items()}}
    if rank == 0:
        torch.save(out, out_path)
    dist.destroy_process_group()


def data_map_ckpt(rank, world, port, cfg, ckpt_path, out_path):
    """The sharded data phase, data-parallel meshing and the row-sharded
    checkpoint round trip on this rank.  ``cfg``: the port's config of a
    world; ``ckpt_path``: a full checkpoint of a map of it.  Rank 0 saves
    the pool's fields and the octree, the mesher's sdf and mask of the map's
    bounding box, and the path of the checkpoint written again from the
    rows cut out of the loaded one (``{out_path}.npz``)."""
    from shine_mapping_tpu_torch.cli.common import build_grid
    from shine_mapping_tpu_torch.data.dataset import LiDARDataset
    from shine_mapping_tpu_torch.mesher import Mesher
    from shine_mapping_tpu_torch.parallel.ingest import process_frames_sharded
    from shine_mapping_tpu_torch.utils import checkpoint as ckpt

    grp = _join(rank, world, port)
    ds = LiDARDataset(cfg, build_grid(cfg))
    process_frames_sharded(ds, ds.frame_ids(), grp)
    pool = {f: getattr(ds.pool, f) for f in ("coord", "sdf_label", "weight", "time")}
    octree = ds.grid.state_dict()
    skeleton = trainer.init_params(cfg, build_grid(cfg))
    grid, params, opt, iters = ckpt.load_checkpoint(ckpt_path, skeleton,
                                                    init_opt_state(skeleton), device="cpu")
    if cfg.params_bf16:  # a bf16 map's tables, as the driver resumes them
        grid.cast_features(torch.bfloat16)
        params[FEATURES] = list(grid.features)
    mesher = Mesher(cfg, grid, params["geo"], params["sem"], group=grp)
    vox, origin = mesher.grid_shape_from_bbx(ds.map_bbx, cfg.mc_res_m)
    sdf, _, mask = mesher.query_grid_lattice(vox, origin, cfg.mc_res_m)
    params, opt, _ = mesh.place_training_state(grp, params, opt, table_sharding="rows")
    params[FEATURES] = [f.clone() for f in params[FEATURES]]
    grid.features = mesh.gather_table_rows(grp, params[FEATURES])
    ckpt.save_checkpoint(out_path + ".npz", grid, params, opt, iters, grp)
    if rank == 0:
        torch.save({"pool": pool, "octree": octree, "sdf": sdf, "mask": mask, "vox": vox,
                    "origin": origin, "ckpt": out_path + ".npz"}, out_path)
    dist.destroy_process_group()


def test_rank_module_imports_no_jax():
    """A spawned rank imports this module: it must not pull in jax."""
    code = ("import sys, tests.test_torch_dist_ranks as m; "
            "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
            "or k.startswith('shine_mapping_tpu.') or k == 'shine_mapping_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
