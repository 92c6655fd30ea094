"""The port's training loop against the JAX package's on the synthetic world.

Both packages read the same synthetic KITTI-layout world (tests/synth.py)
through their own dataset and grid code, start from the same weights
(carried across by ``shine_mapping_tpu_torch.interop``) and train 30 steps on
the same batches (the JAX package's own per-step ``split(key, 3)`` ->
``randint`` draws, handed to the port through ``batch_indices``).  Loss:
sdf_bce + eikonal (the ICRA main path), on the CPU: JAX's plain dense Adam
("fused") or its kernel's XLA twin ("pallas"), the port's plain twin.

Adam's epsilon decides what can be compared element by element.  At the
reference's eps 1e-15 every gradient above ~1e-15 is normalised to a step
of about lr, and a row whose gradient is a near-cancelled sum (a few 1e-15,
the size of float32 rounding noise of its ~1e-8 terms) moves by a fraction
of lr that the summation ORDER decides — XLA's scatter and torch's
``index_add_`` add in different orders.  So:

* the trajectory test runs with adam_eps 1e-3, where the step is a smooth
  function of the gradient, and holds every parameter to rtol 1e-4,
  atol 1e-5 after 30 steps (float32 sums in another order, compounded);
* the ICRA-eps test (1e-15) holds the loss trajectory to rtol 1e-4 and at
  least 97% of the feature entries to the same tolerance (measured on this
  world: 98.4-99.2% per level after 30 steps).

The bf16 map mode (pool lookups, epoch windows, bf16 moments and tables)
has its own section and tolerances below.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_mapping_tpu.config import SHINEConfig as JaxConfig
from shine_mapping_tpu.data.dataset import LiDARDataset as JaxDataset
from shine_mapping_tpu.ops.hashgrid import HashGridHost as JaxGrid
from shine_mapping_tpu.train import trainer as jtrainer
from shine_mapping_tpu_torch.parallel.mesh import DataGroup
from shine_mapping_tpu.train.optimizer import init_opt_state as jinit_opt_state
from shine_mapping_tpu_torch import interop
from shine_mapping_tpu_torch.config import SHINEConfig
from shine_mapping_tpu_torch.data.dataset import LiDARDataset
from shine_mapping_tpu_torch.ops import adam_kernel
from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
from shine_mapping_tpu_torch.train import trainer
from shine_mapping_tpu_torch.train.optimizer import FEATURES, init_opt_state
from tests import synth
from tests.graph_stand_in import stand_in_graph  # noqa: F401  (a fixture)

STEPS = 30
BS = 256


def _cfg(cls, root):
    cfg = cls()
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
    cfg.bs = BS
    cfg.lr = 0.01
    cfg.weight_decay = 1e-7
    cfg.sigma_sigmoid_m = 0.1
    cfg.ekional_loss_on = True
    cfg.weight_e = 0.1
    cfg.window_replay_on = False
    cfg.derive()
    return cfg


def _grid(cls, cfg, **kw):
    return cls(max_level=cfg.tree_level_world, featured_level_num=cfg.tree_level_feat,
               feature_dim=cfg.feature_dim, feature_std=cfg.feature_std,
               leaf_vox_size=cfg.leaf_vox_size, seed=cfg.seed,
               init_node_capacity=1 << 12, init_corner_capacity=1 << 12, **kw)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_torch"))
    synth.make_kitti_dataset(root, n_frames=2)
    out = {}
    for name, cfg_cls, ds_cls, grid in (
        ("jax", JaxConfig, JaxDataset, lambda c: _grid(JaxGrid, c)),
        ("torch", SHINEConfig, LiDARDataset, lambda c: _grid(HashGridHost, c, device="cpu")),
    ):
        cfg = _cfg(cfg_cls, root)
        g = grid(cfg)
        ds = ds_cls(cfg, g)
        for f in ds.frame_ids():
            ds.process_frame(f)
        out[name] = (cfg, g, ds.pool)
    return out


def test_same_world_in_both_packages(worlds):
    """The copied dataset + grid code builds the same pool and map."""
    _, gj, pj = worlds["jax"]
    _, gt, pt = worlds["torch"]
    for f in ("coord", "sdf_label", "weight", "time"):
        np.testing.assert_array_equal(getattr(pj, f), getattr(pt, f))
    sj, st = gj.state_dict(), gt.state_dict()
    assert sj.keys() == st.keys()
    for k in sj:
        np.testing.assert_array_equal(np.asarray(sj[k]), np.asarray(st[k]), err_msg=k)


def _jax_batch_indices(key, n_valid, n_iters, bs):
    """The draws of JAX body_fused: key, k_idx, k_loss = split(key, 3);
    idx = randint(k_idx, (bs,), 0, n_valid) (trainer.py:1118, :982)."""
    out = []
    for _ in range(n_iters):
        key, k_idx, _ = jax.random.split(key, 3)
        out.append(np.asarray(jax.random.randint(k_idx, (bs,), 0, n_valid)))
    return np.stack(out)


def _train_both(worlds, mode, fuse, adam_eps):
    """30 steps in each package from the same weights on the same batches."""
    cfg_j, grid_j, pool_j = worlds["jax"]
    cfg_t, grid_t, pool_t = worlds["torch"]
    cap = 1 << int(np.ceil(np.log2(len(pool_j))))

    s_j = jtrainer.TrainSettings.from_config(
        cfg_j, grid_j.levels, feature_update=mode, fuse_update_levels=fuse,
        n_used=jtrainer.used_rows_for(grid_j), adam_eps=adam_eps)
    params_j = jtrainer.init_params(cfg_j, grid_j, jax.random.PRNGKey(0))
    # the JAX chunk donates its inputs: keep numpy copies for the port first
    params_np = jax.device_get(params_j)
    params_j = jax.tree_util.tree_map(jnp.array, params_np)
    opt_j = jinit_opt_state(params_j)
    opt_np = jax.device_get(opt_j)
    dev_j, n_valid = jtrainer.pool_to_device(pool_j, cap, s_j)
    key = jax.random.PRNGKey(3)
    params_j, opt_j, aux_j = jtrainer.train_chunk(
        params_j, opt_j, tuple(grid_j.tables), dev_j,
        jtrainer.empty_shadow(params_j["features"]), n_valid, jnp.int32(0),
        key, s_j, STEPS)

    s_t = trainer.TrainSettings.from_config(
        cfg_t, grid_t.levels, feature_update=mode, fuse_update_levels=fuse,
        n_used=trainer.used_rows_for(grid_t), adam_eps=adam_eps)
    params_t = interop.params_from_jax(params_np, device="cpu")
    opt_t = interop.opt_state_from_jax(opt_np, params_t)
    dev_t, n_t = trainer.pool_to_device(pool_t, cap, device="cpu")
    assert n_t == int(n_valid)
    idx = torch.from_numpy(_jax_batch_indices(key, n_valid, STEPS, BS))
    adam_kernel.reset_launch_counts()
    params_t, opt_t, aux_t = trainer.train_chunk(
        params_t, opt_t, grid_t.tables, dev_t, n_t, 0, None, s_t, STEPS,
        batch_indices=idx)
    # on the CPU the wrappers run their plain twins and launch nothing
    assert not any(adam_kernel.LAUNCHES.values())
    for k in ("mean", "last"):
        np.testing.assert_allclose(float(aux_t[k]["total_loss"]),
                                   float(aux_j[k]["total_loss"]), rtol=1e-4)
    return (interop.params_to_jax(params_t), interop.opt_state_to_jax(opt_t),
            jax.device_get(params_j), jax.device_get(opt_j))


@pytest.mark.parametrize("mode,fuse", [("fused", False), ("pallas", False),
                                       ("pallas", True)])
def test_train_chunk_trajectory_matches_jax(worlds, mode, fuse):
    got, opt_got, want, opt_want = _train_both(worlds, mode, fuse, adam_eps=1e-3)
    for grp in ("geo", "sem"):
        for leaf in want[grp]:
            np.testing.assert_allclose(got[grp][leaf], want[grp][leaf], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{grp}.{leaf}")
    np.testing.assert_allclose(got["sigma"], want["sigma"])
    assert opt_got["step"] == int(opt_want.step) == STEPS
    for i in range(len(want["features"])):
        for name, a, b in (("p", got["features"][i], want["features"][i]),
                           ("m", opt_got["m"]["features"][i], opt_want.m["features"][i]),
                           ("v", opt_got["v"]["features"][i], opt_want.v["features"][i])):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} features[{i}]")


def test_per_level_iid_step_is_one_call_a_step_and_matches_jax(worlds, monkeypatch):
    """The per-level branch on iid batches (``feature_update: pallas``, no
    ``fuse_update_levels``) makes ONE ``fused_adam_levels`` call a step
    over all levels, each with its lr (on the card one prep and one launch;
    on the CPU the per-level plain steps), and still tracks the JAX
    package's per-level ``fused_adam_packed`` calls at the tolerance of
    test_train_chunk_trajectory_matches_jax."""
    calls = []
    inner = adam_kernel.fused_adam_levels

    def spy(ps, ms, vs, rows_list, g_list, lr, bc1, bc2, lr_scales, n_used=None, **kw):
        calls.append((len(ps), tuple(lr_scales)))
        return inner(ps, ms, vs, rows_list, g_list, lr, bc1, bc2, lr_scales, n_used, **kw)

    def refuse(*a, **k):
        raise AssertionError("the per-level branch called fused_adam level by level")

    monkeypatch.setattr(adam_kernel, "fused_adam_levels", spy)
    monkeypatch.setattr(adam_kernel, "fused_adam", refuse)
    got, opt_got, want, opt_want = _train_both(worlds, "pallas", False, adam_eps=1e-3)
    L = len(want["features"])
    assert len(calls) == STEPS and all(c[0] == L for c in calls), calls
    for i in range(L):
        for name, a, b in (("p", got["features"][i], want["features"][i]),
                           ("m", opt_got["m"]["features"][i], opt_want.m["features"][i]),
                           ("v", opt_got["v"]["features"][i], opt_want.v["features"][i])):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} features[{i}]")


def test_train_chunk_at_reference_eps_tracks_jax(worlds):
    got, _, want, _ = _train_both(worlds, "pallas", True, adam_eps=1e-15)
    for i, (a, b) in enumerate(zip(got["features"], want["features"])):
        share = np.isclose(a, b, rtol=1e-4, atol=1e-5).mean()
        assert share >= 0.97, f"features[{i}]: only {share:.4f} of entries agree"



# two ranks holding row blocks of the tables (no process group is needed:
# the check raises before any collective)
_ROWS_GROUP = DataGroup(rank=0, world=2, device=torch.device("cpu"), table_sharding="rows")

@pytest.mark.parametrize("settings_kw,call_kw", [
    (dict(feature_update="sparse"), {}), (dict(opt_adam=False), {}),
    (dict(normal_loss_on=True), {}), (dict(ray_loss=True, main_loss_type="dr_neus"), {}),
    (dict(sort_batch=True), {}),
    (dict(feature_update="pallas"), dict(pre_lookups=(), group=_ROWS_GROUP)),
], ids=["sparse", "sgd", "normal_loss", "ray_loss", "sort_batch", "pre_lookups"])
def test_train_chunk_rejects_unported_options(worlds, settings_kw, call_kw):
    """Row-sharded tables without routed windows, which raised before they
    were ported (their training is tests/test_torch_dist_rows.py's), still
    refuse the ``pallas`` update as the JAX package does (ValueError, before
    any collective).  The options of the other cases, which raised before
    they were ported, now train through: two steps with finite losses and
    parameters (their parity with the JAX package is
    tests/test_torch_options.py's)."""
    from shine_mapping_tpu_torch.train.optimizer import init_opt_state

    cfg_t, grid_t, pool_t = worlds["torch"]
    s = trainer.TrainSettings.from_config(cfg_t, grid_t.levels, **settings_kw)
    params = trainer.init_params(cfg_t, grid_t, torch.Generator().manual_seed(0))
    params[FEATURES] = [f.clone() for f in params[FEATURES]]  # the shared grid stays as is
    dev, n = trainer.pool_to_device(pool_t, len(pool_t), device="cpu", settings=s)
    rng = np.random.default_rng(0)
    if s.normal_loss_on:
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        dev["normal_label"] = torch.from_numpy(nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
    if s.ray_loss:
        # the point pool read as rays of ray_sample_count consecutive samples
        depth = torch.linalg.norm(dev["coord"], dim=1)
        dev["sample_depth"] = depth
        dev["ray_depth"] = depth[: n - n % s.ray_sample_count].reshape(
            -1, s.ray_sample_count).mean(dim=1)
    if "group" in call_kw:
        with pytest.raises(ValueError, match="needs replicated feature tables"):
            trainer.train_chunk(params, init_opt_state(params), grid_t.tables, dev, n, 0,
                                torch.Generator(), s, 1, **call_kw)
        return
    _, opt, aux = trainer.train_chunk(params, init_opt_state(params), grid_t.tables, dev, n,
                                      0, torch.Generator().manual_seed(1), s, 2, **call_kw)
    assert opt.step == 2 and np.isfinite(float(aux["last"]["total_loss"]))
    for f in params[FEATURES]:
        assert torch.isfinite(f).all()


# ------------------------------------------------------------- bf16 map mode
#
# Pool lookups, epoch windows and the bf16 modes (the JAX package's
# production configuration).  The JAX side runs precompute_pool_lookups,
# precompute_batch_windows (per-level layout) or
# precompute_batch_windows_fused (fused layout) and train_chunk; the port
# takes JAX's window indices through precompute_batch_windows's
# ``window_indices`` and, for bf16 tables, JAX's per-step rounding bits
# through train_chunk's ``sr_noise16``.
#
# Tolerances.  bf16 moments: a moment whose f32 value moves by an ulp
# (another sum order) may round to the neighbouring bf16 value, 0.4% off, so
# p is held to atol 2e-4 (2% of lr) everywhere and to rtol 1e-4, atol 1e-5
# on 99.9% of elements, and m, v to bit equality on 99% of elements and a
# few bf16 ulps everywhere (measured: 99.5% bit-equal, 7e-5 max |dp|).
# bf16 tables: JAX's autodiff takes d loss / d G in bfloat16 when G is
# gathered from a bf16 table — 23% of the nonzero entry gradients then
# differ from the rounded f32 gradient, by up to 2.2x on near-cancelled
# sums — while the port keeps the f32 gradient and rounds it once, as the
# kernel's grads_bf16 does.  So that trajectory is held in aggregate: loss
# rtol 2e-4, decoders and moments within 5% in norm, and 98% of the feature
# elements within one bf16 ulp of JAX's (measured: 1e-4, 1.7%, 99.0%).


def _jax_sr_noise(shapes, steps):
    """JAX ``sr_round_bf16``'s bits for the seeds 0 .. steps - 1 on the
    levels' concatenated packed table, flattened per step."""
    R = sum(C * D // 128 for C, D in shapes)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.bits(jax.random.PRNGKey(t), (R, 128), jnp.uint32)
                   & jnp.uint32(0xFFFF)).astype(np.int32).reshape(-1)
        for t in range(steps)]))


def _windows_both(worlds, fused, params_bf16):
    """STEPS steps of bf16-moment window training in each package from the
    same weights on the same windows."""
    from shine_mapping_tpu.train.optimizer import init_opt_state as jinit

    cfg_j, grid_j, pool_j = worlds["jax"]
    cfg_t, grid_t, pool_t = worlds["torch"]
    cap = 1 << int(np.ceil(np.log2(len(pool_j))))
    s_j = jtrainer.TrainSettings.from_config(
        cfg_j, grid_j.levels, feature_update="pallas",
        n_used=jtrainer.used_rows_for(grid_j), adam_eps=1e-3)
    params_j = jtrainer.init_params(cfg_j, grid_j, jax.random.PRNGKey(0))
    if params_bf16:
        params_j = dict(params_j, features=tuple(
            f.astype(jnp.bfloat16) for f in params_j["features"]))
    params_np = jax.device_get(params_j)
    params_j = jax.tree_util.tree_map(jnp.array, params_np)
    opt_j = jinit(params_j, moments_bf16=True)
    opt_np = jax.device_get(opt_j)
    dev_j, n_valid = jtrainer.pool_to_device(pool_j, cap, s_j)
    shapes = tuple(tuple(f.shape) for f in params_j["features"])
    caps = tuple(sh[0] for sh in shapes)
    pre_j = jtrainer.precompute_pool_lookups(tuple(grid_j.tables), dev_j["coord"],
                                            tuple(grid_j.levels), caps)
    if fused:
        win_j = jtrainer.precompute_batch_windows_fused(
            pre_j, dev_j, int(n_valid), jax.random.PRNGKey(1), s_j, shapes)
    else:
        win_j = jtrainer.precompute_batch_windows(
            pre_j, int(n_valid), jax.random.PRNGKey(1), s_j, shapes)
    widx = np.array(win_j["idx"])
    params_j, opt_j, aux_j = jtrainer.train_chunk(
        params_j, opt_j, tuple(grid_j.tables), dev_j,
        jtrainer.empty_shadow(params_j["features"]), n_valid, jnp.int32(0),
        jax.random.PRNGKey(3), s_j, STEPS, pre_lookups=None if fused else pre_j,
        batch_windows=win_j)

    s_t = trainer.TrainSettings.from_config(
        cfg_t, grid_t.levels, feature_update="pallas",
        n_used=trainer.used_rows_for(grid_t), adam_eps=1e-3)
    params_t = interop.params_from_jax(params_np, device="cpu")
    opt_t = interop.opt_state_from_jax(opt_np, params_t)
    dev_t, n_t = trainer.pool_to_device(pool_t, cap, device="cpu")
    pre_t = trainer.precompute_pool_lookups(grid_t.tables, dev_t["coord"],
                                            grid_t.levels, caps)
    win_t = trainer.precompute_batch_windows(pre_t, n_t, None, s_t, shapes, fused=fused,
                                             window_indices=torch.from_numpy(widx))
    adam_kernel.reset_launch_counts()
    params_t, opt_t, aux_t = trainer.train_chunk(
        params_t, opt_t, grid_t.tables, dev_t, n_t, 0, None, s_t, STEPS,
        pre_lookups=pre_t, batch_windows=win_t,
        sr_noise16=_jax_sr_noise(shapes, STEPS) if params_bf16 else None)
    assert not any(adam_kernel.LAUNCHES.values())
    dt = torch.bfloat16 if params_bf16 else torch.float32
    assert params_t["features"][0].dtype == dt
    assert opt_t.m["features"][0].dtype == torch.bfloat16
    assert opt_t.m["geo.layers.0.weight"].dtype == torch.float32
    return (interop.params_to_jax(params_t), interop.opt_state_to_jax(opt_t), aux_t,
            jax.device_get(params_j), jax.device_get(opt_j), aux_j)


def test_precompute_pool_lookups_matches_jax(worlds):
    cfg_j, grid_j, pool_j = worlds["jax"]
    cfg_t, grid_t, pool_t = worlds["torch"]
    s_j = jtrainer.TrainSettings.from_config(cfg_j, grid_j.levels)
    dev_j, _ = jtrainer.pool_to_device(pool_j, len(pool_j), s_j)
    dev_t, _ = trainer.pool_to_device(pool_t, len(pool_t), device="cpu")
    caps = tuple(f.shape[0] for f in grid_j.features)
    want = jtrainer.precompute_pool_lookups(tuple(grid_j.tables), dev_j["coord"],
                                           tuple(grid_j.levels), caps)
    got = trainer.precompute_pool_lookups(grid_t.tables, dev_t["coord"], grid_t.levels,
                                          caps, chunk=1000)
    for (c, f), (cj, fj) in zip(got, want):
        assert c.dtype == torch.int32 and f.dtype == torch.bool
        np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(f.numpy(), np.asarray(fj))
    assert 0 < float(got[0][1].float().mean()) < 1  # hits and misses both


def _port_setup(worlds, **kw):
    cfg_t, grid_t, pool_t = worlds["torch"]
    s = trainer.TrainSettings.from_config(
        cfg_t, grid_t.levels, feature_update="pallas",
        n_used=trainer.used_rows_for(grid_t), **kw)
    dev, n = trainer.pool_to_device(pool_t, len(pool_t), device="cpu")
    shapes = [tuple(f.shape) for f in grid_t.features]
    pre = trainer.precompute_pool_lookups(grid_t.tables, dev["coord"], grid_t.levels,
                                          [sh[0] for sh in shapes])
    return s, dev, n, shapes, pre


def test_precompute_batch_windows_partitions_the_pool(worlds):
    """W = ceil(n / bs) windows cover every pool sample once per epoch (the
    tail wraps to the start of the permutation); both layouts hold the same
    windows; the estimate is the bytes they hold."""
    s, dev, n, shapes, pre = _port_setup(worlds)
    win = trainer.precompute_batch_windows(pre, n, torch.Generator().manual_seed(0), s,
                                           shapes, fused=True)
    W = -(n // -s.bs)
    assert tuple(win.idx.shape) == (W, s.bs) and win.n_windows == W
    flat = win.idx.reshape(-1).numpy()
    assert len(np.unique(flat)) == n
    assert flat.min() >= 0 and flat.max() < n
    assert flat.size - n == W * s.bs - n
    per = trainer.precompute_batch_windows(pre, n, torch.Generator().manual_seed(0), s,
                                           shapes, fused=False)
    assert torch.equal(per.idx, win.idx)
    assert len(win.preps) == 1 and len(per.preps) == len(s.levels)
    assert tuple(win.preps[0].rows.shape) == (W, s.bs * 8 * len(s.levels))
    held = sum(t.numel() * t.element_size()
               for p in per.preps for t in (p.rows, p.order, p.tile_off, p.dropped,
                                            p.split_off, p.split_items, p.n_split))
    held += win.idx.numel() * win.idx.element_size()
    assert held == trainer.estimate_windows_bytes(n, s, shapes)
    # each window's fused prep holds its levels' per-level preps, offset
    w = W - 1
    fused_rows = win.preps[0].rows[w]
    off = 0
    for p, (C, _) in zip(per.preps, shapes):
        r = p.rows[w]
        r = r[r != 2 ** 31 - 1]
        sel = (fused_rows >= off) & (fused_rows < off + C)
        assert torch.equal(fused_rows[sel] - off, r)
        off += C
    srt = trainer.precompute_batch_windows(pre, n, torch.Generator().manual_seed(0),
                                           dataclasses_replace(s, sort_batch=True), shapes)
    assert torch.equal(srt.idx, torch.sort(win.idx, dim=1).values)


def dataclasses_replace(s, **kw):
    import dataclasses

    return dataclasses.replace(s, **kw)


def test_windows_raise_before_training_on_stale_heads(worlds):
    """An entry past a used head is found when the windows are built, not
    at the end of a chunk."""
    s, dev, n, shapes, pre = _port_setup(worlds)
    stale = dataclasses_replace(s, n_used=tuple(nu // 2 for nu in s.n_used))
    for fused in (True, False):
        with pytest.raises(ValueError, match="stale"):
            trainer.precompute_batch_windows(pre, n, torch.Generator().manual_seed(0),
                                             stale, shapes, fused=fused)


@pytest.mark.parametrize("fused,moments_bf16", [(True, False), (False, False), (True, True)],
                         ids=["f32-fused", "f32-per-level", "bf16m-fused"])
def test_window_steps_equal_iid_steps_on_the_same_batches(worlds, fused, moments_bf16):
    """A window step is the iid step on the window's samples, bit for bit:
    pool lookups and the precomputed entry prep change where the rows come
    from, not the step (both layouts; the per-level layout against the
    per-level iid update, the fused one against the multi-level one)."""
    s, dev, n, shapes, pre = _port_setup(worlds)
    cfg_t, grid_t, _ = worlds["torch"]
    idx = torch.randperm(n, generator=torch.Generator().manual_seed(2))[:4 * s.bs]
    idx = idx.reshape(4, s.bs)
    win = trainer.precompute_batch_windows(pre, n, None, s, shapes, fused=fused,
                                           window_indices=idx)
    out = []
    for kw, fuse in ((dict(pre_lookups=pre, batch_windows=win), False),
                     (dict(batch_indices=idx), fused)):
        params = trainer.init_params(cfg_t, grid_t, torch.Generator().manual_seed(0))
        params["features"] = [f.clone() for f in params["features"]]
        opt = init_opt_state(params, moments_bf16=moments_bf16)
        params, opt, aux = trainer.train_chunk(
            params, opt, grid_t.tables, dev, n, 0, None,
            dataclasses_replace(s, fuse_update_levels=fuse), 4, **kw)
        out.append((params, opt, aux))
    (pw, ow, aw), (pi, oi, ai) = out
    assert torch.equal(aw["mean"]["total_loss"], ai["mean"]["total_loss"])
    for a, b in zip(pw["features"] + ow.m["features"] + ow.v["features"],
                    pi["features"] + oi.m["features"] + oi.v["features"]):
        assert torch.equal(a, b)
    for k, t in pw["geo"].state_dict().items():
        assert torch.equal(t, pi["geo"].state_dict()[k]), k


@pytest.mark.parametrize("fused", [True, False])
def test_train_chunk_refuses_windows_built_for_other_heads(worlds, fused):
    """Windows whose entry prep was built for other used heads raise before
    a step is taken, in both layouts."""
    s, dev, n, shapes, pre = _port_setup(worlds)
    cfg_t, grid_t, _ = worlds["torch"]
    whole = dataclasses_replace(s, n_used=tuple(C for C, _ in shapes))
    assert whole.n_used != s.n_used
    win = trainer.precompute_batch_windows(pre, n, torch.Generator().manual_seed(0), whole,
                                           shapes, fused=fused)
    assert win.built_for == (whole.n_used, whole.n_used)  # (table rows, used heads)
    params = trainer.init_params(cfg_t, grid_t, torch.Generator().manual_seed(0))
    params["features"] = [f.clone() for f in params["features"]]
    before = [f.clone() for f in params["features"]]
    with pytest.raises(ValueError, match="recompute them"):
        trainer.train_chunk(params, init_opt_state(params, moments_bf16=True), grid_t.tables,
                            dev, n, 0, None, s, 1, pre_lookups=pre, batch_windows=win)
    for a, b in zip(params["features"], before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused,params_bf16", [(False, False), (True, False), (True, True)],
                         ids=["bf16m-per-level", "bf16m-fused", "bf16p-fused"])
def test_bf16_windows_trajectory_matches_jax(worlds, fused, params_bf16):
    got, opt_got, aux_t, want, opt_want, aux_j = _windows_both(worlds, fused, params_bf16)
    rtol_loss = 2e-4 if params_bf16 else 1e-4
    for k in ("mean", "last"):
        np.testing.assert_allclose(float(aux_t[k]["total_loss"]),
                                   float(aux_j[k]["total_loss"]), rtol=rtol_loss)
    assert opt_got["step"] == int(opt_want.step) == STEPS
    for grp in ("geo", "sem"):
        for leaf in want[grp]:
            a, b = got[grp][leaf], want[grp][leaf]
            if params_bf16:
                assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(b) + 1e-7, leaf
            else:
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{grp}.{leaf}")
    for i in range(len(want["features"])):
        p, pw = (np.asarray(x, np.float32) for x in (got["features"][i], want["features"][i]))
        if params_bf16:
            assert got["features"][i].dtype == want["features"][i].dtype  # bf16
            share = (np.abs(p - pw) <= 2.0 ** -7 * np.abs(pw) + 1e-30).mean()
            assert share >= 0.98, f"features[{i}]: {share:.4f} within one bf16 ulp"
        else:
            np.testing.assert_allclose(p, pw, rtol=0, atol=2e-4, err_msg=f"p{i}")
            share = np.isclose(p, pw, rtol=1e-4, atol=1e-5).mean()
            assert share >= 0.999, f"p{i}: {share:.5f}"
        for name in ("m", "v"):
            a = np.asarray(opt_got[name]["features"][i], np.float32)
            b = np.asarray(getattr(opt_want, name)["features"][i], np.float32)
            if params_bf16:
                assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(b), f"{name}{i}"
            else:
                assert (a == b).mean() >= 0.99, f"{name}{i}: {(a == b).mean():.4f}"
                np.testing.assert_allclose(a, b, rtol=2.0 ** -5, atol=1e-3 * np.abs(b).max(),
                                           err_msg=f"{name}{i}")


def test_bf16_table_windows_are_chunk_split_deterministic(worlds):
    """The stochastic rounding is seeded by the absolute iteration, so a run
    split into chunks equals one chunk bit for bit (resume continuity), and
    the loss falls."""
    s, dev, n, shapes, pre = _port_setup(worlds)
    cfg_t, grid_t, _ = worlds["torch"]
    win = trainer.precompute_batch_windows(pre, n, torch.Generator().manual_seed(1), s,
                                           shapes, fused=True)

    def run(splits):
        params = trainer.init_params(cfg_t, grid_t, torch.Generator().manual_seed(0))
        params["features"] = [f.to(torch.bfloat16) for f in params["features"]]
        opt = init_opt_state(params, moments_bf16=True)
        start, losses = 0, []
        for k in splits:
            params, opt, aux = trainer.train_chunk(params, opt, grid_t.tables, dev, n,
                                                   start, None, s, k, pre_lookups=pre,
                                                   batch_windows=win)
            losses.append(float(aux["mean"]["total_loss"]))
            start += k
        return params, losses

    once, _ = run([6])
    split, _ = run([2, 4])
    for a, b in zip(once["features"], split["features"]):
        assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), b.view(torch.int16))
    _, losses = run([10, 10])
    assert losses[-1] < losses[0]


def _jax_gate_raises(worlds, match, moments_bf16, params_bf16, windows, feature_update):
    from shine_mapping_tpu.train.optimizer import init_opt_state as jinit

    cfg_j, grid_j, pool_j = worlds["jax"]
    s = jtrainer.TrainSettings.from_config(cfg_j, grid_j.levels,
                                           feature_update=feature_update)
    params = jtrainer.init_params(cfg_j, grid_j, jax.random.PRNGKey(0))
    if params_bf16:
        params = dict(params, features=tuple(f.astype(jnp.bfloat16)
                                             for f in params["features"]))
    dev, n_valid = jtrainer.pool_to_device(pool_j, len(pool_j), s)
    shapes = tuple(tuple(f.shape) for f in params["features"])
    pre = win = None
    if windows:
        pre = jtrainer.precompute_pool_lookups(tuple(grid_j.tables), dev["coord"],
                                              tuple(grid_j.levels),
                                              tuple(sh[0] for sh in shapes))
        win = jtrainer.precompute_batch_windows(
            pre, int(n_valid), jax.random.PRNGKey(1),
            dataclasses_replace(s, feature_update="pallas"), shapes)
    with pytest.raises(ValueError, match=match):
        jtrainer.train_chunk(params, jinit(params, moments_bf16=moments_bf16),
                             tuple(grid_j.tables), dev,
                             jtrainer.empty_shadow(params["features"]), n_valid,
                             jnp.int32(0), jax.random.PRNGKey(0), s, 1,
                             pre_lookups=pre, batch_windows=win)


@pytest.mark.parametrize("match,moments_bf16,params_bf16,windows,feature_update", [
    ("moments_bf16", True, False, False, "fused"),
    ("params_bf16", True, True, False, "pallas"),
    ("params_bf16", True, True, True, "pallas"),
    ("batch_windows", False, False, True, "fused"),
], ids=["bf16-moments-without-kernel-update", "bf16-tables-iid",
        "bf16-tables-per-level-windows", "windows-without-kernel-update"])
def test_bf16_gates_raise_where_jax_does(worlds, match, moments_bf16, params_bf16,
                                         windows, feature_update):
    _jax_gate_raises(worlds, match, moments_bf16, params_bf16, windows, feature_update)
    s, dev, n, shapes, pre = _port_setup(worlds)
    cfg_t, grid_t, _ = worlds["torch"]
    params = trainer.init_params(cfg_t, grid_t, torch.Generator().manual_seed(0))
    params["features"] = [f.clone() for f in params["features"]]
    if params_bf16:
        params["features"] = [f.to(torch.bfloat16) for f in params["features"]]
    win = (trainer.precompute_batch_windows(pre, n, torch.Generator().manual_seed(1), s,
                                            shapes, fused=False) if windows else None)
    with pytest.raises(ValueError, match=match):
        trainer.train_chunk(params, init_opt_state(params, moments_bf16=moments_bf16),
                            grid_t.tables, dev, n, 0, torch.Generator(),
                            dataclasses_replace(s, feature_update=feature_update), 1,
                            pre_lookups=pre if windows else None, batch_windows=win)


def test_batch_windows_ok_tells_the_layouts_apart(worlds):
    """Continual-learning reg keeps the kernel update only on the fused
    layout; JAX's predicate answers for the fused layout whichever is meant
    (ROADMAP Queue C), the port's takes the layout."""
    cfg_t, grid_t, _ = worlds["torch"]
    shapes = [tuple(f.shape) for f in grid_t.features]
    s = trainer.TrainSettings.from_config(cfg_t, grid_t.levels, feature_update="pallas")
    reg = dataclasses_replace(s, continual_reg_on=True)
    assert trainer.batch_windows_ok(s, shapes, fused=True)
    assert trainer.batch_windows_ok(s, shapes, fused=False)
    assert trainer.batch_windows_ok(reg, shapes, fused=True)
    assert not trainer.batch_windows_ok(reg, shapes, fused=False)
    assert trainer.resolve_feature_update(reg) == "fused"
    assert trainer.resolve_feature_update(reg, fused_windows=True) == "pallas"
    # JAX's predicate says yes to per-level windows under reg too
    cfg_j, grid_j, _ = worlds["jax"]
    sj = jtrainer.TrainSettings.from_config(cfg_j, grid_j.levels, feature_update="pallas",
                                            continual_reg_on=True)
    assert jtrainer.batch_windows_ok(sj, tuple(tuple(f.shape) for f in grid_j.features))
    for bad in (dict(fuse_update_levels=True), dict(feature_update="fused"),
                dict(ray_loss=True), dict(consistency_loss_on=True)):
        for fused in (True, False):
            assert not trainer.batch_windows_ok(dataclasses_replace(s, **bad), shapes, fused)
    assert not trainer.batch_windows_ok(s, [(64, 8), (64, 4)], fused=True)
    assert trainer.batch_windows_ok(s, [(64, 8), (64, 4)], fused=False)


def test_interop_carries_bf16_tables_bit_for_bit():
    import ml_dtypes

    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 8)).astype(ml_dtypes.bfloat16)
    t = interop._table_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    back = interop._table_to_numpy(t)
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back.view(np.int16), a.view(np.int16))


# ------------------------------------------------------------------ the recorded iid step
# On the card train_chunk takes its iid steps through one CUDA graph
# (trainer.step_graph_ok); the CPU runs every step eagerly.  Here the
# predicate, the key, the CPU's eager steps and, with a stand-in for the
# recording (``tests.graph_stand_in``), the graph path's control flow
# and arithmetic; tests/test_torch_cuda.py holds the graph on the card bit
# for bit against the eager steps.

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL_CONFIGS = ("config/rgbd/rgbd_batch.yaml", "config/config_icra2023/maicity_batch.yaml")


def _cell_settings(path):
    cfg = SHINEConfig().load(os.path.join(_ROOT, path))
    top = cfg.tree_level_world
    return trainer.TrainSettings.from_config(
        cfg, tuple(range(top - cfg.tree_level_feat + 1, top + 1)))


@pytest.mark.parametrize("path", CELL_CONFIGS, ids=["room", "street"])
def test_step_graph_ok_takes_the_cells_settings(path):
    """The benchmark's cells (the batch CLI's single-card path on iid
    batches with pool lookups) take the recorded step."""
    s = _cell_settings(path)
    assert trainer.step_graph_ok(s, torch.device("cuda"), pre_lookups=())
    assert trainer.step_graph_ok(dataclasses_replace(s, fuse_update_levels=True), "cuda",
                                 pre_lookups=())


@pytest.mark.parametrize("case", [
    "cpu", "no_pre_lookups", "group", "batch_windows", "batch_indices", "continual_reg",
    "consistency", "ray_loss", "sparse", "dense", "sgd"])
def test_step_graph_ok_keeps_the_other_paths_eager(case):
    s = _cell_settings(CELL_CONFIGS[0])
    kw = dict(pre_lookups=())
    device = "cuda"
    if case == "cpu":
        device = "cpu"
    elif case == "no_pre_lookups":
        kw["pre_lookups"] = None
    elif case in ("group", "batch_windows"):
        kw[case] = object()
    elif case == "batch_indices":
        kw[case] = torch.zeros((1, s.bs), dtype=torch.int64)
    else:
        s = dataclasses_replace(s, **{
            "continual_reg": dict(continual_reg_on=True), "consistency":
            dict(consistency_loss_on=True), "ray_loss": dict(ray_loss=True),
            "sparse": dict(feature_update="sparse"), "dense": dict(feature_update="dense"),
            "sgd": dict(opt_adam=False)}[case])
    assert not trainer.step_graph_ok(s, device, **kw)


def _graph_setup(worlds, **kw):
    """The torch world's settings (``feature_update: pallas``), pool and
    lookups, and a fresh state with tables of its own."""
    s, dev, n, _, pre = _port_setup(worlds, **kw)
    cfg_t, grid_t, _ = worlds["torch"]
    params = trainer.init_params(cfg_t, grid_t, torch.Generator().manual_seed(0))
    params[FEATURES] = [f.clone() for f in params[FEATURES]]
    return s, dev, n, pre, params, init_opt_state(params)


@pytest.mark.parametrize("change", ["table", "n_valid", "zero_lr"])
def test_step_graph_key_changes_with_what_the_graph_bakes_in(worlds, change):
    """The key of the same inputs is equal; a table reallocated, another
    ``n_valid`` or a leaf whose lr became 0 give another key."""
    s, dev, n, pre, params, opt = _graph_setup(worlds)
    key = trainer.step_graph_key(params, opt, dev, pre, s, n)
    assert trainer.step_graph_key(params, opt, dev, pre, s, n) == key
    zero = frozenset()
    if change == "table":
        params[FEATURES][1] = params[FEATURES][1].clone()
    elif change == "n_valid":
        n -= 1
    else:
        zero = frozenset({"geo.lout.weight"})
    assert trainer.step_graph_key(params, opt, dev, pre, s, n, zero) != key


def _chunks(worlds, splits, adam_eps=1e-15, fresh_graph=False):
    """The iid steps of ``splits`` chunks from one start (one generator
    across them); ``fresh_graph``: the graph cleared before each chunk, so
    that every step is a first sighting."""
    s, dev, n, pre, params, opt = _graph_setup(worlds, adam_eps=adam_eps)
    gen, step, losses = torch.Generator().manual_seed(5), 0, []
    for k in splits:
        if fresh_graph:
            opt.graph = None
        params, opt, aux = trainer.train_chunk(params, opt, worlds["torch"][1].tables, dev, n,
                                               step, gen, s, k, pre_lookups=pre)
        losses.append(aux["last"]["total_loss"])
        step += k
    return params, opt, losses


def _state(params, opt):
    out = [p for _, p in sorted(trainer.dense_params(params).items())] + list(params[FEATURES])
    for st in (opt.m, opt.v):
        out += [st[k] for k in sorted(k for k in st if k != FEATURES)] + list(st[FEATURES])
    return out


def test_cpu_train_chunk_runs_every_step_eagerly(worlds):
    """CPU tensors: the settings the card records run eagerly, keep no
    graph, and a chunk is bit for bit its steps one chunk each."""
    trainer.reset_graph_counts()
    p1, o1, _ = _chunks(worlds, [4])
    assert trainer.GRAPH_COUNTS == {"eager": 4, "captured": 0, "replayed": 0}
    assert o1.graph is None and o1.step == 4
    p2, o2, _ = _chunks(worlds, [1, 1, 1, 1])
    for a, b in zip(_state(p1, o1), _state(p2, o2)):
        assert torch.equal(a, b)


def test_graph_path_counts_and_follows_the_eager_steps(worlds, stand_in_graph):
    """Three one-step chunks: the key's first step eager, the second
    records and replays, the third replays; a reallocated table starts a
    new key (eager, then recorded).  On the CPU the device's Adam divides
    by a reciprocal, so the steps agree with the eager ones (every step a
    first sighting) at rounding, adam_eps 1e-3."""
    p, o, losses = _chunks(worlds, [1, 1, 1], adam_eps=1e-3)
    assert trainer.GRAPH_COUNTS == {"eager": 1, "captured": 1, "replayed": 2}
    assert o.graph is not None and o.graph.replay is not None and o.step == 3
    trainer.reset_graph_counts()
    pe, oe, losses_e = _chunks(worlds, [1, 1, 1], adam_eps=1e-3, fresh_graph=True)
    assert trainer.GRAPH_COUNTS == {"eager": 3, "captured": 0, "replayed": 0}
    assert losses[0] == losses_e[0]  # the same eager first step
    for a, b in zip(losses[1:], losses_e[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    for a, b in zip(_state(p, o), _state(pe, oe)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    s, dev, n, pre, _, _ = _graph_setup(worlds, adam_eps=1e-3)
    p[FEATURES][0] = p[FEATURES][0].clone()
    trainer.reset_graph_counts()
    tables = worlds["torch"][1].tables
    for k in range(3):
        p, o, _ = trainer.train_chunk(p, o, tables, dev, n, 3 + k, torch.Generator(), s, 1,
                                      pre_lookups=pre)
    assert trainer.GRAPH_COUNTS == {"eager": 1, "captured": 1, "replayed": 2}
    assert o.step == 6


def test_graph_is_released_by_a_path_it_does_not_take(worlds, stand_in_graph):
    s, dev, n, pre, params, opt = _graph_setup(worlds)
    tables = worlds["torch"][1].tables
    params, opt, _ = trainer.train_chunk(params, opt, tables, dev, n, 0, torch.Generator(), s, 2,
                                         pre_lookups=pre)
    assert opt.graph is not None and opt.graph.replay is not None
    params, opt, _ = trainer.train_chunk(params, opt, tables, dev, n, 2, torch.Generator(), s, 1)
    assert opt.graph is None
    assert trainer.GRAPH_COUNTS == {"eager": 2, "captured": 1, "replayed": 1}


def test_adam_scalars_are_the_eager_divisors():
    """The device Adam's numbers: float32 lr * scale and the bias
    corrections' float64 reciprocals rounded to float32, row by step (at
    step 2 the second differs from the float32 reciprocal of the float32
    correction in the last bit)."""
    from shine_mapping_tpu_torch.train.optimizer import adam_scalars, bias_corrections

    rows = adam_scalars([0.01, 0.001], {"a": 1.0, "b": 0.0, "c": 0.5}, ["a", "b", "c"], [1, 2])
    assert rows.dtype == np.float32 and rows.shape == (2, 5)
    for r, lr, t in zip(rows, (0.01, 0.001), (1, 2)):
        assert list(r[:3]) == [np.float32(lr), 0.0, np.float32(lr * 0.5)]
        for got, bc in zip(r[3:], bias_corrections(t)):
            assert got == np.float32(1.0 / bc)
    assert rows[1, 4] != np.float32(1.0) / np.float32(bias_corrections(2)[1])
