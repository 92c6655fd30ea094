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
        shadow = case.get("shadow_np")
        if shadow is not None:
            shadow = interop.shadow_from_jax(shadow, device="cpu")
        params, opt, shadow = mesh.place_training_state(grp, params, opt, shadow,
                                                        table_sharding=case["layout"])
        shapes = [tuple(f.shape) for f in case["params_np"]["features"]]
        win = None
        if case.get("window_idx") is not None:
            win = trainer.precompute_batch_windows(
                w["pre"], w["n_valid"], None, s, shapes, fused=True,
                window_indices=torch.from_numpy(case["window_idx"]),
                shards=world if rows else 0, deterministic=not rows,
                reg_cover=s.continual_reg_on)
            if rows:
                win = mesh.place_routed_windows(grp, win)
        bi = case.get("batch_indices")
        draws = {k: torch.from_numpy(case[k]) for k in ("near_indices", "near_shifts")
                 if case.get(k) is not None}
        comm.reset_counts()
        params, opt, aux = trainer.train_chunk(
            params, opt, w["tables"], w["pool"], w["n_valid"], 0, None, s, case["steps"],
            group=grp, pre_lookups=case.get("pre", w["pre"]), batch_windows=win,
            batch_indices=None if bi is None else torch.from_numpy(bi), shadow=shadow,
            **draws)
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


def rows_growth(rank, world, port, spec_path, out_path):
    """Row-sharded tables through growth (the counterpart of the JAX
    package's ``test_row_sharded_layout_survives_capacity_doublings``): per
    round the ranks place the whole state in row blocks, train 2 iid steps
    (live routing, K2's row-sharded caller's plain version) and gather the
    blocks, and one rank trains the same steps from the same state; then
    the map grows (its capacity doubling), the tables take the grown rows
    and the moments are padded.  Rank 0 saves per round the capacity, the
    blocks' and the whole tables' shapes, and both runs' loss, tables and
    moments (JAX layout, numpy)."""
    from types import SimpleNamespace

    from shine_mapping_tpu_torch.cli.common import pad_opt_state_features
    from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
    from shine_mapping_tpu_torch.train.optimizer import OptState

    grp = _join(rank, world, port)
    spec = torch.load(spec_path, weights_only=False)
    grid = HashGridHost(**spec["grid_kw"], device="cpu")
    grid.update(spec["surf"])
    params = interop.params_from_jax(spec["params_np"], device="cpu")
    opt = init_opt_state(params)
    rounds = []
    for rnd, extra in enumerate(spec["extras"] + [None]):
        bi = torch.from_numpy(spec["batch_indices"][rnd])
        start = interop.params_to_jax(params), SimpleNamespace(**interop.opt_state_to_jax(opt))
        runs = {}
        for name, g in (("one", None), ("ranks", grp)):
            p = interop.params_from_jax(start[0], device="cpu")
            o = interop.opt_state_from_jax(start[1], p)
            if g is not None:
                p, o, _ = mesh.place_training_state(grp, p, o, table_sharding="rows")
                shapes = [tuple(f.shape) for f in p[FEATURES]]
            p, o, aux = trainer.train_chunk(p, o, grid.tables, spec["pool"], spec["n_valid"], 0,
                                            None, spec["settings"], 2, group=g,
                                            batch_indices=bi)
            if g is not None:
                p = dict(p, **{FEATURES: mesh.gather_table_rows(grp, p[FEATURES])})
                o = OptState(m=dict(o.m, **{FEATURES: mesh.gather_table_rows(grp, o.m[FEATURES])}),
                             v=dict(o.v, **{FEATURES: mesh.gather_table_rows(grp, o.v[FEATURES])}),
                             step=o.step)
            runs[name] = (p, o, float(aux["mean"]["total_loss"]))
        params, opt, _ = runs["ranks"]
        rounds.append(dict(capacity=grid.host_levels[0].corner_capacity, shapes=shapes,
                           whole=[int(f.shape[0]) for f in params[FEATURES]],
                           **{name: dict(params=interop.params_to_jax(p),
                                         opt=interop.opt_state_to_jax(o), loss=loss)
                              for name, (p, o, loss) in runs.items()}))
        if extra is None:
            break
        # growth writes the new corners' rows in place: not into the saved round
        grid.features = [f.clone() for f in params[FEATURES]]
        grid.update(extra)
        params = dict(params, **{FEATURES: list(grid.features)})
        opt = pad_opt_state_features(opt, params)
    if rank == 0:
        torch.save(rounds, out_path)
    dist.destroy_process_group()


def _incre(cfg, group=None):
    """The incremental driver on ``cfg``, the work-ratio gate open where the
    config asks for windows, over ``group`` or on this rank alone (not
    joined to the group this process is in); returns (run path, grid)."""
    from shine_mapping_tpu_torch.cli import shine_incre

    ratio, join = shine_incre.PRECOMPUTE_WORK_RATIO, shine_incre.join_ranks
    if cfg.batch_windows:
        shine_incre.PRECOMPUTE_WORK_RATIO = 0.0
    shine_incre.join_ranks = lambda *a: None
    try:
        run_path, grid, _ = shine_incre.run_shine_mapping_incremental(cfg=cfg, group=group)
    finally:
        shine_incre.PRECOMPUTE_WORK_RATIO, shine_incre.join_ranks = ratio, join
    return run_path, grid


def incre_runs(rank, world, port, cfgs, one_cfgs, pool, out_path):
    """The incremental driver over the ranks for each config of ``cfgs``
    (``(label, config)``), every frame's chunk followed by a check that the
    ranks' tables, moments and decoders are bit-identical (replicated
    tables) and every importance sweep by a check that the ranks'
    importance tables are; then on the last run's map the importance sweep
    of ``pool`` (coord, sdf label) over the ranks and on one; then the
    one-rank runs of ``one_cfgs``, shared out over the ranks.  Rank 0 saves
    per run its run path and the checks' results, both sweeps and the
    one-rank runs' paths."""
    from shine_mapping_tpu_torch.cli import shine_incre
    from shine_mapping_tpu_torch.train import importance

    grp = _join(rank, world, port)
    out = {}
    inner_train, inner_imp = trainer.train_chunk, shine_incre.cal_feature_importance
    for label, cfg in cfgs:
        checks = {"replicas": [], "importance": []}

        def train(*a, **kw):
            params, opt, aux = inner_train(*a, **kw)
            if grp.table_sharding == "replicated":
                checks["replicas"].append(mesh.replicas_equal(grp, mesh.state_tensors(params,
                                                                                      opt)))
            return params, opt, aux

        def imp(grid, *a, **kw):
            inner_imp(grid, *a, **kw)
            checks["importance"].append(mesh.replicas_equal(grp, grid.importance_weight))

        trainer.train_chunk, shine_incre.cal_feature_importance = train, imp
        try:
            run_path, grid = _incre(cfg, grp)
        finally:
            trainer.train_chunk, shine_incre.cal_feature_importance = inner_train, inner_imp
        out[label] = dict(run_path=run_path, **checks)
    # the importance sweep over the ranks against one rank's on the last map
    coord, sdf = (torch.from_numpy(a) for a in pool)
    start = list(grid.importance_weight)
    sweeps = {}
    for name, g in (("one", None), ("ranks", grp)):
        grid.importance_weight = list(start)
        importance.cal_feature_importance(grid, _decoder(grid, cfg), coord, sdf, sigma=0.1,
                                          bs=512, group=g)
        sweeps[name] = [w.clone() for w in grid.importance_weight]
    out["importance"] = dict(sweeps, replicas=mesh.replicas_equal(grp, sweeps["ranks"]))
    mine = [f"{label}={_incre(cfg)[0]}" for k, (label, cfg) in enumerate(one_cfgs)
            if k % world == rank]
    out["one"] = dict(p.split("=", 1) for b in comm.gather_bytes(grp, "\n".join(mine).encode())
                      for p in b.decode().splitlines())
    if rank == 0:
        torch.save(out, out_path)
    dist.destroy_process_group()


def _decoder(grid, cfg):
    """A seeded decoder of the config's geometry head."""
    return trainer.init_params(cfg, grid, torch.Generator().manual_seed(1))["geo"]


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
