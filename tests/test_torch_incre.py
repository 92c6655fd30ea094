"""The port's continual-learning pieces against the JAX package's, state by
state: incremental growth with last-frame snapshots, the reg on iid batches
(JAX ``body_fused``) and on fused windows (JAX ``body_winx`` with its cover
masks), decoder freezing, and the feature importance.

The world is tests/test_torch_trainer.py's (2 synthetic frames, 3 levels,
D 8, bs 256), read by both packages; weights cross through
``shine_mapping_tpu_torch.interop``.  The reg's shadow is made from a seed:
importance |N(0, 0.01)| per element, the last frame the features plus
N(0, 0.02), so ``p - last`` is nonzero from the first step.  Runs are 5
steps at adam_eps 1e-3 with the driver's ``"sum"`` reduction.

Tolerances: the trajectories are held as tests/test_torch_trainer.py holds
the non-reg path (features, m, v and decoders rtol 1e-4, atol 1e-5; with
bf16 moments its one-ulp tie rule), but for the f32 moments' atol, which is
1e-6 of the table's largest moment where that is above 10: at lambda 1e6
the reg gradients reach hundreds, p oscillates about the last frame, and a
moment summed from terms of opposite sign keeps their float32 rounding in
another summation order (measured: 26 of 65,536 elements of m, 4e-4 off on
moments of up to 941, while p agrees to 6e-8).  ``reg_loss`` and
``total_loss`` at rtol 1e-5; growth bit-equal; importance rtol 1e-5, atol
1e-6 of each table's largest value."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_mapping_tpu.ops.hashgrid import HashGridHost as JaxGrid
from shine_mapping_tpu.train import trainer as jtrainer
from shine_mapping_tpu.train.importance import cal_feature_importance as jax_importance
from shine_mapping_tpu.train.optimizer import init_opt_state as jinit_opt_state
from shine_mapping_tpu_torch import interop
from shine_mapping_tpu_torch.ops import adam_kernel
from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
from shine_mapping_tpu_torch.train import trainer
from shine_mapping_tpu_torch.train.importance import cal_feature_importance
from shine_mapping_tpu_torch.train.optimizer import init_opt_state
from tests.test_torch_trainer import BS, _jax_batch_indices, worlds  # noqa: F401

STEPS = 5


def _np(t):
    return np.asarray(t, np.float32)


# ------------------------------------------------------------------ growth


def _frames(seed=0, n_frames=4):
    """Point sets of a map that grows frame by frame: clustered points in
    the [-1, 1] cube, each frame a new cluster and part of an old one."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.6, 0.6, (n_frames, 3))
    out = []
    for f in range(n_frames):
        new = centers[f] + rng.normal(0, 0.05 + 0.02 * f, (3000 * (f + 1), 3))
        old = centers[max(f - 1, 0)] + rng.normal(0, 0.05, (500, 3))
        out.append(np.clip(np.concatenate([new, old]), -0.99, 0.99).astype(np.float32))
    return out


def test_incremental_growth_matches_jax_bit_for_bit():
    """Both packages grow from the same frames with incremental_on: equal
    features, importance and last-frame snapshots at every frame, through
    capacity doublings; the port's snapshot is a copy, not the table."""
    kw = dict(max_level=7, featured_level_num=3, feature_dim=8, feature_std=0.05, seed=3,
              init_node_capacity=1 << 8, init_corner_capacity=1 << 8)
    gj = JaxGrid(**kw)
    gt = HashGridHost(device="cpu", **kw)
    caps = []
    for f, pts in enumerate(_frames()):
        # importance accumulated between frames, as the driver does
        imp = [np.full(tuple(w.shape), f + 1.0, np.float32) for w in gt.importance_weight]
        imp = [np.where(np.arange(a.shape[0])[:, None] < hl.n_corners, a, 0.0)
               for a, hl in zip(imp, gt.host_levels)]
        gj.importance_weight = [jnp.asarray(a) for a in imp]
        gt.importance_weight = [torch.from_numpy(a.copy()) for a in imp]
        gj.update(pts, incremental_on=True)
        gt.update(pts, incremental_on=True)
        caps.append([hl.corner_capacity for hl in gt.host_levels])
        for i in range(3):
            for name, a, b in (("features", gj.features[i], gt.features[i]),
                               ("importance", gj.importance_weight[i], gt.importance_weight[i]),
                               ("last_frame", gj.features_last_frame[i],
                                gt.features_last_frame[i])):
                np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                              err_msg=f"frame {f} {name}[{i}]")
            assert gt.features_last_frame[i].data_ptr() != gt.features[i].data_ptr()
    assert caps[0] != caps[-1], f"no capacity doubling among the frames: {caps}"
    # the snapshot stays what it was when the features are trained in place
    before = [t.clone() for t in gt.features_last_frame]
    for f in gt.features:
        f.add_(1.0)
    for a, b in zip(before, gt.features_last_frame):
        assert torch.equal(a, b)


def test_only_incremental_updates_take_snapshots():
    """The batch driver's growth holds no snapshot (no table's worth of
    device memory); an incremental update takes a copy of every level, grown
    or not."""
    kw = dict(max_level=6, featured_level_num=2, feature_dim=4, feature_std=0.05)
    g = HashGridHost(device="cpu", **kw)
    pts = _frames(n_frames=1)[0]
    g.update(pts)
    assert g.features_last_frame == [None, None]
    g2 = HashGridHost.from_state_dict(g.state_dict(), device="cpu")
    assert g2.features_last_frame == [None, None]
    g2.update(pts, incremental_on=True)  # no new node: the snapshot all the same
    for f, last in zip(g2.features, g2.features_last_frame):
        assert torch.equal(f, last) and f.data_ptr() != last.data_ptr()


# ------------------------------------------------------------------ reg


def _shadow_np(feats, seed=7):
    rng = np.random.default_rng(seed)
    imp = tuple(np.abs(rng.normal(0, 0.01, f.shape)).astype(np.float32) for f in feats)
    last = tuple((np.asarray(f) + rng.normal(0, 0.02, f.shape)).astype(np.float32)
                 for f in feats)
    return {"importance": imp, "last_frame": last}


def _settings(worlds, lam, **kw):
    cfg_j, grid_j, _ = worlds["jax"]
    cfg_t, grid_t, _ = worlds["torch"]
    common = dict(continual_reg_on=True, lambda_forget=lam, adam_eps=1e-3,
                  loss_reduction="sum")
    s_j = jtrainer.TrainSettings.from_config(
        cfg_j, grid_j.levels, n_used=jtrainer.used_rows_for(grid_j),
        **{**common, **kw.get("jax", {})})
    s_t = trainer.TrainSettings.from_config(
        cfg_t, grid_t.levels, n_used=trainer.used_rows_for(grid_t),
        **{**common, **kw.get("torch", {})})
    return s_j, s_t


def _start(worlds, moments_bf16=False):
    """The JAX package's initial weights and Adam state (numpy), and the
    shadow made from them."""
    cfg_j, grid_j, _ = worlds["jax"]
    params = jax.device_get(jtrainer.init_params(cfg_j, grid_j, jax.random.PRNGKey(0)))
    opt = jax.device_get(jinit_opt_state(params, moments_bf16=moments_bf16))
    return params, opt, _shadow_np(params["features"])


def _jax_run(params_np, opt_np, shadow_np, s_j, worlds, key, **kw):
    _, grid_j, pool_j = worlds["jax"]
    cap = 1 << int(np.ceil(np.log2(len(pool_j))))
    dev_j, n_valid = jtrainer.pool_to_device(pool_j, cap, s_j)
    params = jax.tree_util.tree_map(jnp.array, params_np)
    opt = jax.tree_util.tree_map(jnp.array, opt_np)
    shadow = jax.tree_util.tree_map(jnp.array, shadow_np)
    params, opt, aux = jtrainer.train_chunk(
        params, opt, tuple(grid_j.tables), dev_j, shadow, n_valid, jnp.int32(0), key, s_j,
        STEPS, **kw)
    return jax.device_get(params), jax.device_get(opt), aux, int(n_valid), dev_j


def _port_run(params_np, opt_np, shadow_np, s_t, worlds, **kw):
    _, grid_t, pool_t = worlds["torch"]
    cap = 1 << int(np.ceil(np.log2(len(pool_t))))
    dev_t, n_t = trainer.pool_to_device(pool_t, cap, device="cpu")
    params = interop.params_from_jax(params_np, device="cpu")
    opt = interop.opt_state_from_jax(opt_np, params)
    shadow = interop.shadow_from_jax(shadow_np, device="cpu")
    last0 = [t.clone() for t in shadow["last_frame"]]
    adam_kernel.reset_launch_counts()
    params, opt, aux = trainer.train_chunk(params, opt, grid_t.tables, dev_t, n_t, 0, None,
                                           s_t, STEPS, shadow=shadow, **kw)
    assert not any(adam_kernel.LAUNCHES.values())  # CPU tensors: the plain versions
    for a, b in zip(last0, shadow["last_frame"]):
        assert torch.equal(a, b), "training wrote the last-frame snapshot"
    return interop.params_to_jax(params), interop.opt_state_to_jax(opt), aux


def _assert_losses(aux_t, aux_j):
    for k in ("mean", "last"):
        for name in ("reg_loss", "total_loss"):
            np.testing.assert_allclose(float(aux_t[k][name]), float(aux_j[k][name]),
                                       rtol=1e-5, err_msg=f"{k} {name}")
    assert float(aux_t["last"]["reg_loss"]) > 0


def _assert_trajectory(got, opt_got, want, opt_want, bf16_moments=False):
    for grp in ("geo", "sem"):
        for leaf in want[grp]:
            np.testing.assert_allclose(got[grp][leaf], want[grp][leaf], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{grp}.{leaf}")
    assert opt_got["step"] == int(opt_want.step) == STEPS
    for i in range(len(want["features"])):
        p, pw = _np(got["features"][i]), _np(want["features"][i])
        if not bf16_moments:
            np.testing.assert_allclose(p, pw, rtol=1e-4, atol=1e-5, err_msg=f"p{i}")
        else:
            np.testing.assert_allclose(p, pw, rtol=0, atol=2e-4, err_msg=f"p{i}")
            share = np.isclose(p, pw, rtol=1e-4, atol=1e-5).mean()
            assert share >= 0.999, f"p{i}: {share:.5f}"
        for name in ("m", "v"):
            a = _np(opt_got[name]["features"][i])
            b = _np(getattr(opt_want, name)["features"][i])
            if not bf16_moments:
                # a moment is a sum of entry gradients of up to ~2 lambda imp
                # |p - last| (hundreds at lambda 1e6); where they cancel, its
                # float32 sum keeps the terms' absolute error, ~1e-6 of the
                # largest moment (1e-5 at the non-reg path's scale)
                atol = max(1e-5, 1e-6 * float(np.abs(b).max()))
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol, err_msg=f"{name}{i}")
            else:
                assert (a == b).mean() >= 0.99, f"{name}{i}: {(a == b).mean():.4f}"
                np.testing.assert_allclose(a, b, rtol=2.0 ** -5, atol=1e-3 * np.abs(b).max(),
                                           err_msg=f"{name}{i}")


_JAX_IID = {}


@pytest.mark.parametrize("fuse", [False, True], ids=["K1-per-level", "K2-multi"])
@pytest.mark.parametrize("lam", [1e3, 1e6])
def test_reg_on_iid_batches_matches_jax_body_fused(worlds, lam, fuse):
    """5 reg steps on the JAX package's iid draws: JAX resolves reg to its
    dense ``fused`` body; the port folds the reg into the kernel's entries
    (K1 per level, or K2 with fuse_update_levels)."""
    s_j, s_t = _settings(worlds, lam, torch=dict(fuse_update_levels=fuse))
    params_np, opt_np, shadow_np = _start(worlds)
    key = jax.random.PRNGKey(11)
    if lam not in _JAX_IID:  # one JAX run serves both port layouts
        _JAX_IID[lam] = _jax_run(params_np, opt_np, shadow_np, s_j, worlds, key)
    want, opt_want, aux_j, n_valid, _ = _JAX_IID[lam]
    idx = torch.from_numpy(_jax_batch_indices(key, n_valid, STEPS, BS))
    got, opt_got, aux_t = _port_run(params_np, opt_np, shadow_np, s_t, worlds,
                                    batch_indices=idx)
    _assert_losses(aux_t, aux_j)
    _assert_trajectory(got, opt_got, want, opt_want)


def _jax_windows(worlds, s_j, dev_j, n_valid, feat_shapes):
    _, grid_j, _ = worlds["jax"]
    pre_j = jtrainer.precompute_pool_lookups(tuple(grid_j.tables), dev_j["coord"],
                                            tuple(grid_j.levels),
                                            tuple(sh[0] for sh in feat_shapes))
    return jtrainer.precompute_batch_windows_fused(
        pre_j, dev_j, n_valid, jax.random.PRNGKey(1), s_j, feat_shapes, reg_cover=True)


@pytest.mark.parametrize("moments_bf16", [False, True], ids=["f32-moments", "bf16-moments"])
def test_reg_on_fused_windows_matches_jax_body_winx(worlds, moments_bf16):
    """JAX's fused windows with its reg cover masks, handed to the port
    through ``window_indices``: the port's owner flags carry the same reg
    (K2 with the fold; bf16 moments round the entries after it)."""
    # the "mean" reduction, as in tests/test_torch_trainer.py's window
    # tests: JAX's window forward (_feat_winx) rounds the interpolation in
    # another order, and under "sum" the decoder biases' gradients (sums of
    # 256 terms that nearly cancel) reach the size where adam_eps 1e-3 no
    # longer smooths the step (measured: geo.b0/b1 5e-4 apart after 5
    # steps); the reg fold is the same under either reduction
    kw = dict(feature_update="pallas", loss_reduction="mean")
    s_j, s_t = _settings(worlds, 1e6, jax=kw, torch=kw)
    params_np, opt_np, shadow_np = _start(worlds, moments_bf16)
    _, grid_j, pool_j = worlds["jax"]
    cap = 1 << int(np.ceil(np.log2(len(pool_j))))
    dev_j, n_valid = jtrainer.pool_to_device(pool_j, cap, s_j)
    shapes = tuple(tuple(f.shape) for f in params_np["features"])
    win_j = _jax_windows(worlds, s_j, dev_j, int(n_valid), shapes)
    widx = np.array(win_j["idx"])
    want, opt_want, aux_j, _, _ = _jax_run(params_np, opt_np, shadow_np, s_j, worlds,
                                           jax.random.PRNGKey(3), batch_windows=win_j)

    _, grid_t, pool_t = worlds["torch"]
    dev_t, n_t = trainer.pool_to_device(pool_t, cap, device="cpu")
    pre_t = trainer.precompute_pool_lookups(grid_t.tables, dev_t["coord"], grid_t.levels,
                                            [sh[0] for sh in shapes])
    win_t = trainer.precompute_batch_windows(pre_t, n_t, None, s_t, shapes, fused=True,
                                             window_indices=torch.from_numpy(widx),
                                             reg_cover=True)
    got, opt_got, aux_t = _port_run(params_np, opt_np, shadow_np, s_t, worlds,
                                    pre_lookups=pre_t, batch_windows=win_t)
    _assert_losses(aux_t, aux_j)
    _assert_trajectory(got, opt_got, want, opt_want, bf16_moments=moments_bf16)


def test_reg_on_fused_windows_at_feature_dim_2(worlds):
    """feature_dim 2, where JAX's int32 cover masks (one bit per lane slot,
    64 slots per 128-lane row) overflow: the port's owner flags have no
    width.  Its fused windows with reg hold to JAX ``body_fused`` on the
    same batches (the JAX draws as windows)."""
    cfg_j, grid_j, pool_j = worlds["jax"]
    cfg_t, _, pool_t = worlds["torch"]
    pts = pool_j.coord[pool_j.weight > 0]
    kw = dict(max_level=cfg_j.tree_level_world, featured_level_num=cfg_j.tree_level_feat,
              feature_dim=2, feature_std=cfg_j.feature_std, seed=cfg_j.seed,
              init_node_capacity=1 << 12, init_corner_capacity=1 << 12)
    gj, gt = JaxGrid(**kw), HashGridHost(device="cpu", **kw)
    gj.update(pts)
    gt.update(pts)
    cj = dataclasses.replace(cfg_j, feature_dim=2)
    common = dict(continual_reg_on=True, lambda_forget=1e3, adam_eps=1e-3,
                  loss_reduction="sum")
    s_j = jtrainer.TrainSettings.from_config(cj, gj.levels, n_used=jtrainer.used_rows_for(gj),
                                             **common)
    s_t = trainer.TrainSettings.from_config(cfg_t, gt.levels, feature_update="pallas",
                                            n_used=trainer.used_rows_for(gt), **common)
    params_np = jax.device_get(jtrainer.init_params(cj, gj, jax.random.PRNGKey(0)))
    opt_np = jax.device_get(jinit_opt_state(params_np))
    shadow_np = _shadow_np(params_np["features"])
    cap = 1 << int(np.ceil(np.log2(len(pool_j))))
    dev_j, n_valid = jtrainer.pool_to_device(pool_j, cap, s_j)
    key = jax.random.PRNGKey(5)
    params, opt, aux_j = jtrainer.train_chunk(
        jax.tree_util.tree_map(jnp.array, params_np), jax.tree_util.tree_map(jnp.array, opt_np),
        tuple(gj.tables), dev_j, jax.tree_util.tree_map(jnp.array, shadow_np), n_valid,
        jnp.int32(0), key, s_j, STEPS)
    want, opt_want = jax.device_get(params), jax.device_get(opt)

    idx = torch.from_numpy(_jax_batch_indices(key, int(n_valid), STEPS, BS))
    dev_t, n_t = trainer.pool_to_device(pool_t, cap, device="cpu")
    shapes = [tuple(f.shape) for f in gt.features]
    assert shapes[0][1] == 2
    pre_t = trainer.precompute_pool_lookups(gt.tables, dev_t["coord"], gt.levels,
                                            [sh[0] for sh in shapes])
    win_t = trainer.precompute_batch_windows(pre_t, n_t, None, s_t, shapes, fused=True,
                                             window_indices=idx, reg_cover=True)
    params_t = interop.params_from_jax(params_np, device="cpu")
    opt_t = interop.opt_state_from_jax(opt_np, params_t)
    params_t, opt_t, aux_t = trainer.train_chunk(
        params_t, opt_t, gt.tables, dev_t, n_t, 0, None, s_t, STEPS, pre_lookups=pre_t,
        batch_windows=win_t, shadow=interop.shadow_from_jax(shadow_np, device="cpu"))
    _assert_losses(aux_t, aux_j)
    _assert_trajectory(interop.params_to_jax(params_t), interop.opt_state_to_jax(opt_t),
                       want, opt_want)


def test_owner_flags_pick_each_touched_row_once():
    corners = torch.tensor([[[0, 1, 2, 3, 4, 5, 6, 7]], [[7, 6, 9, 9, 9, 9, 9, 9]],
                            [[9, 9, 9, 9, 9, 9, 9, 9]]], dtype=torch.int32).reshape(3, 8)
    found = torch.tensor([True, True, False])
    own = trainer.owner_flags(corners, found)
    assert own[0].all()
    assert own[1].tolist() == [False, False, True] + [False] * 5
    assert not own[2].any()
    # windows: the leading dim is the window
    stacked = trainer.owner_flags(corners[None].expand(2, 3, 8), found[None].expand(2, 3))
    assert torch.equal(stacked[1], own)


def test_reg_needs_its_shadow_and_window_owner_flags(worlds):
    cfg_t, grid_t, pool_t = worlds["torch"]
    _, s_t = _settings(worlds, 1e3, torch=dict(feature_update="pallas"))
    params = trainer.init_params(cfg_t, grid_t, torch.Generator().manual_seed(0))
    params["features"] = [f.clone() for f in params["features"]]
    dev, n = trainer.pool_to_device(pool_t, len(pool_t), device="cpu")
    shapes = [tuple(f.shape) for f in params["features"]]
    with pytest.raises(ValueError, match="shadow"):
        trainer.train_chunk(params, init_opt_state(params), grid_t.tables, dev, n, 0,
                            torch.Generator(), s_t, 1)
    pre = trainer.precompute_pool_lookups(grid_t.tables, dev["coord"], grid_t.levels,
                                          [sh[0] for sh in shapes])
    win = trainer.precompute_batch_windows(pre, n, torch.Generator().manual_seed(0), s_t,
                                           shapes, fused=True)
    shadow = {"importance": [torch.zeros(sh) for sh in shapes],
              "last_frame": [torch.zeros(sh) for sh in shapes]}
    with pytest.raises(ValueError, match="reg_cover"):
        trainer.train_chunk(params, init_opt_state(params), grid_t.tables, dev, n, 0, None,
                            s_t, 1, pre_lookups=pre, batch_windows=win, shadow=shadow)
    # the per-level window layout refuses the reg, as batch_windows_ok says
    with pytest.raises(ValueError, match="continual reg"):
        trainer.precompute_batch_windows(pre, n, torch.Generator().manual_seed(0), s_t,
                                         shapes, fused=False, reg_cover=True)


# ------------------------------------------------------------------ freeze


def test_frozen_decoder_stays_bit_unchanged_as_in_jax(worlds):
    """A frozen chunk: the decoders do not move (their Adam moments do) and
    the features train, in both packages, on the same batches."""
    cfg_j, grid_j, _ = worlds["jax"]
    cfg_t, grid_t, _ = worlds["torch"]
    s_j = jtrainer.TrainSettings.from_config(cfg_j, grid_j.levels, freeze_decoder=True,
                                             n_used=jtrainer.used_rows_for(grid_j),
                                             adam_eps=1e-3)
    s_t = trainer.TrainSettings.from_config(cfg_t, grid_t.levels, freeze_decoder=True,
                                            n_used=trainer.used_rows_for(grid_t),
                                            adam_eps=1e-3)
    params_np, opt_np, shadow_np = _start(worlds)
    key = jax.random.PRNGKey(13)
    want, opt_want, _, n_valid, _ = _jax_run(params_np, opt_np,
                                             jtrainer.empty_shadow(params_np["features"]),
                                             s_j, worlds, key)
    idx = torch.from_numpy(_jax_batch_indices(key, n_valid, STEPS, BS))
    got, opt_got, _ = _port_run(params_np, opt_np, shadow_np, s_t, worlds,
                                batch_indices=idx)
    for grp in ("geo", "sem"):
        for leaf in want[grp]:
            np.testing.assert_array_equal(want[grp][leaf], params_np[grp][leaf])
            np.testing.assert_array_equal(got[grp][leaf], params_np[grp][leaf])
    assert np.abs(opt_got["m"]["geo"]["w0"]).max() > 0  # the moments advanced
    for i in range(len(want["features"])):
        assert not np.array_equal(got["features"][i], params_np["features"][i])
        np.testing.assert_allclose(got["features"][i], want["features"][i], rtol=1e-4,
                                   atol=1e-5, err_msg=f"p{i}")


# ------------------------------------------------------------------ importance


@pytest.mark.parametrize("down_rate", [1, 2])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_feature_importance_matches_jax(worlds, reduction, down_rate):
    cfg_j, grid_j, pool_j = worlds["jax"]
    bs = 200
    n = len(pool_j)
    assert n % (bs * down_rate), "the pool must end in a partial batch"
    params_np = jax.device_get(jtrainer.init_params(cfg_j, grid_j, jax.random.PRNGKey(0)))
    state = grid_j.state_dict()
    rng = np.random.default_rng(4)
    for i in range(grid_j.featured_level_num):  # importance accumulated before
        state[f"lvl{i}_importance"] = np.abs(rng.normal(
            0, 1e-3, state[f"lvl{i}_features"].shape)).astype(np.float32)
    gj = JaxGrid.from_state_dict(state)
    gt = HashGridHost.from_state_dict(state, device="cpu")
    sigma = cfg_j.logistic_gaussian_ratio * cfg_j.sigma_sigmoid_m * cfg_j.scale
    jax_importance(gj, jax.tree_util.tree_map(jnp.array, params_np["geo"]), pool_j.coord,
                   pool_j.sdf_label, sigma=sigma, bs=bs, down_rate=down_rate,
                   loss_reduction=reduction)
    geo = interop.decoder_from_jax(params_np["geo"], device="cpu")
    cal_feature_importance(gt, geo, pool_j.coord, pool_j.sdf_label, sigma=sigma, bs=bs,
                           down_rate=down_rate, loss_reduction=reduction)
    assert all(p.grad is None for p in geo.parameters())
    for i in range(len(gt.importance_weight)):
        a, b = gt.importance_weight[i].numpy(), np.asarray(gj.importance_weight[i])
        assert a[-1].max() == 0 and b.max() > 0
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * np.abs(b).max(),
                                   err_msg=f"importance[{i}]")


def _cancelling_entries(rng, C, D, n_used, M):
    """Entries whose rows nearly cancel, as at lambda 1e6: each row's first
    entry carries a large term N(0, 300), its other entries share -0.98 of
    it, all plus N(0, 0.1)."""
    rows = rng.integers(0, n_used, M)
    g = rng.normal(size=(M, D)) * 0.1
    big = rng.normal(size=(C, D)) * 300
    k = np.bincount(rows, minlength=C)
    first = np.zeros(M, bool)
    first[np.unique(rows, return_index=True)[1]] = True
    g += np.where(first[:, None], big[rows], -0.98 * big[rows] / np.maximum(k[rows] - 1, 1)[:, None])
    return torch.from_numpy(rows.astype(np.int32)), torch.from_numpy(g.astype(np.float32))


def test_smoke_k1_check_admits_sum_order_and_catches_faults():
    """chip_smoke.py's check of K1 against its plain version in phase 7
    (phase 2's tolerance plus each element's sum-order spread): the plain
    update with the entries summed in other orders (on the CPU
    ``index_add_`` sums in entry order, so a permutation is another order)
    passes it though it fails phase 2's tolerance alone; a lost entry, or one
    entry 1e-3 off, still fails it."""
    import chip_smoke

    rng = np.random.default_rng(5)
    C, D, n_used, M = 1024, 8, 1000, 6000
    rows, g = _cancelling_entries(rng, C, D, n_used, M)
    t0 = [torch.from_numpy(rng.normal(size=(C, D)).astype(np.float32)),
          torch.zeros(C, D), torch.zeros(C, D)]
    step = dict(lr=1e-2, bc1=0.1, bc2=0.01, n_used=n_used, eps=1e-3)

    def run(r, gg):
        tabs = [t.clone() for t in t0]
        adam_kernel.fused_adam_plain(*tabs, r, gg, **step)
        return tabs

    def passes(tabs, spread):
        try:
            chip_smoke._check_f32([[t] for t in tabs], [[t] for t in base], [[t] for t in t0],
                                  [n_used], moved_share=None, scale_of="after", spread=spread)
        except AssertionError:
            return False
        return True

    base = run(rows, g)
    spread = chip_smoke._sum_order_spread(t0, rows, g, **step)
    past_alone = 0
    for seed in range(3):
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(M))
        other = run(rows[perm], g[perm])
        assert passes(other, spread)
        past_alone += not passes(other, None)
    assert past_alone > 0, "no reordering left phase 2's tolerance: the case does not cancel"
    keep = torch.ones(M, dtype=torch.bool)
    keep[5] = False
    assert not passes(run(rows[keep], g[keep]), spread)
    off = g.clone()
    off[7] *= 1.001
    assert not passes(run(rows, off), spread)


def test_smoke_carried_allowance_admits_sum_order_and_catches_faults():
    """chip_smoke.py phase 7's end-state check after 5 reg-like steps (rows
    whose entries cancel to 1e-3 of their largest term, as at lambda 1e6):
    the tolerance it had plus the allowance carried from each step's
    sum-order spread (``_CarriedAllowance``, built from the checked run's
    own inputs, as on the card).  A run that differs only in the order of
    each row's entries (on the CPU ``index_add_`` sums in entry order)
    passes it, though some such run fails the tolerance alone; a run that
    lost one entry in one step, or took a row's largest entry 1e-3 off,
    fails it."""
    import chip_smoke

    rng = np.random.default_rng(8)
    C, D, n_used, M, steps, lr = 1024, 8, 1000, 6000, 5, 1e-2
    entries = []
    for _ in range(steps):
        rows = rng.integers(0, n_used, M)
        g = rng.normal(size=(M, D)) * 0.1
        big = rng.normal(size=(C, D)) * 300
        k = np.bincount(rows, minlength=C)
        first = np.zeros(M, bool)
        first[np.unique(rows, return_index=True)[1]] = True
        g += np.where(first[:, None], big[rows],
                      -0.999 * big[rows] / np.maximum(k[rows] - 1, 1)[:, None])
        entries.append((torch.from_numpy(rows.astype(np.int32)),
                        torch.from_numpy(g.astype(np.float32)), int(np.flatnonzero(first)[3])))
    t0 = [torch.from_numpy(rng.normal(size=(C, D)).astype(np.float32)),
          torch.zeros(C, D), torch.zeros(C, D)]

    def run(seed=None, fault=None):
        """5 plain steps; ``seed`` permutes each step's entries; ``fault``
        ("drop" / "scale") alters step 2's entries behind the allowance's
        back.  Returns (tables, the carried allowance)."""
        tabs = [t.clone() for t in t0]
        carried = chip_smoke._CarriedAllowance()
        for t, (rows, g, big) in enumerate(entries):
            bc1, bc2 = 1 - 0.9 ** (t + 1), 1 - 0.99 ** (t + 1)
            before = [x.clone() for x in tabs]
            plain = [x.clone() for x in tabs]
            adam_kernel.fused_adam_plain(*plain, rows, g, lr, bc1, bc2, n_used, eps=1e-3)
            r, gg = rows, g
            if seed is not None:
                perm = torch.from_numpy(np.random.default_rng(seed + t).permutation(M))
                r, gg = rows[perm], g[perm]
            if fault == "drop" and t == 2:
                keep = torch.ones(M, dtype=torch.bool)
                keep[big] = False
                r, gg = r[keep], gg[keep]
            if fault == "scale" and t == 2:
                gg = gg.clone()
                gg[big] *= 1.001
            adam_kernel.fused_adam_plain(*tabs, r, gg, lr, bc1, bc2, n_used, eps=1e-3)
            carried.step(0, before, plain, rows, g, lr, bc1, bc2, n_used, 1e-3)
        return tabs, carried

    ref, _ = run()

    def passes(tabs, carried, alone=False):
        try:
            for k, (a, b) in enumerate(zip(tabs, ref)):
                atol = 1e-5 if k == 0 else max(1e-5, 1e-6 * float(b.abs().max()))
                allow = torch.zeros_like(a, dtype=torch.float64) if alone else carried.A[0][k]
                chip_smoke._end_state_check("pmv"[k], a, b, atol, allow)
        except AssertionError:
            return False
        return True

    past_alone = 0
    for seed in (0, 10, 20):
        tabs, carried = run(seed)
        assert passes(tabs, carried)
        past_alone += not passes(tabs, carried, alone=True)
    assert past_alone > 0, "no reordering left the tolerance alone: the case does not cancel"
    for fault in ("drop", "scale"):
        assert not passes(*run(0, fault)), fault
