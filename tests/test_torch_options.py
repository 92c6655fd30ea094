"""The JAX package's flag matrix (tests/test_flag_matrix.py) against the port,
case by case: the same sphere world (tests/test_trainer.py's pools and
grid, the port's grid rebuilt from the JAX grid's state), the same weights
(interop), the same draws — JAX's per-step ``split(key, 3)`` batch indices,
its consistency near points (``split(k_loss)`` in the dense body,
``split(fold_in(k_loss, 7))`` in the fused one) and its epoch windows —
and ``STEPS`` steps in each package.  Cases JAX refuses raise in the port
too.  The matrix's second half is tests/test_torch_options_kernel.py's, the
other update modes' cases tests/test_torch_options_modes.py's.

Tolerances, at adam_eps 1e-3 as tests/test_torch_trainer.py (where the step
is a smooth function of the gradient): the loss to rtol 1e-4, every f32
parameter, moment and decoder weight to rtol 1e-4, atol 1e-5.  The bf16
cases are held as that file holds them (float32 sums in another order may
move a bf16 moment by one ulp, and JAX rounds a bf16 table's row gradients
where the port keeps them in f32): bf16 moments p to atol 2e-4 everywhere
and to rtol 1e-4, atol 1e-5 on 99.9% of elements; bf16 tables in
aggregate, loss rtol 2e-4 and 98% of the feature elements within one bf16
ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_mapping_tpu.train import trainer as jtrainer
from shine_mapping_tpu.train.optimizer import init_opt_state as jinit
from shine_mapping_tpu_torch import interop
from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
from shine_mapping_tpu_torch.train import trainer
from shine_mapping_tpu_torch.train.optimizer import init_opt_state
from tests.test_trainer import build, default_cfg, make_ray_pool, make_sphere_pool

STEPS = 10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's thread pools in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

COMBOS = [
    dict(time_conditioned=True),
    dict(loss_weight_on=True),
    dict(main_loss_type="sdf_l1", ekional_loss_on=True),
    dict(main_loss_type="sdf_l2", normal_loss_on=False),
    dict(proj_correction_on=True, normal_loss_on=False),
    dict(ekional_loss_on=True, proj_correction_on=True),
    dict(opt_adam=False),  # SGD (dense)
    dict(feature_update="dense", consistency_loss_on=True),
    dict(consistency_loss_on=True),  # kernel update, near entries
    dict(feature_update="sparse", consistency_loss_on=True),  # dense fallback
    dict(lr_iters_reduce_ratio=0.5, lr_decay_step=(2,)),
    dict(feature_update="pallas", consistency_loss_on=True),
    dict(feature_update="pallas", fuse_update_levels=True),
    dict(feature_update="pallas", sort_batch=True, _n_used=True),
    dict(feature_update="pallas", _moments_bf16=True, _n_used=True),
    dict(feature_update="pallas", _moments_bf16=True, _n_used=True,
         _batch_windows=True),
    dict(feature_update="pallas", _moments_bf16=True, _n_used=True,
         _batch_windows=True, _windows_fused=True),
    dict(feature_update="pallas", ekional_loss_on=True, _n_used=True,
         _batch_windows=True, _windows_fused=True),
    dict(feature_update="pallas", semantic_on=True, _n_used=True,
         _batch_windows=True, _windows_fused=True),
    dict(feature_update="pallas", _moments_bf16=True, _n_used=True,
         _batch_windows=True, _windows_fused=True, _params_bf16=True),
    dict(feature_update="pallas", _ray=True),
    dict(feature_update="pallas", time_conditioned=True, _n_used=True,
         _batch_windows=True, _windows_fused=True),
    dict(feature_update="pallas", proj_correction_on=True, _n_used=True,
         _batch_windows=True, _windows_fused=True),
    dict(feature_update="pallas", normal_loss_on=True, weight_n=0.01,
         _normals=True, _n_used=True, _batch_windows=True,
         _windows_fused=True),
]

# beyond the JAX matrix: the other update modes with the new terms
# (tests/test_torch_options_modes.py)
EXTRA = [
    dict(feature_update="sparse"),
    dict(feature_update="sparse", semantic_on=True, time_conditioned=True),
    dict(feature_update="dense", ekional_loss_on=True, semantic_on=True),
    dict(feature_update="pallas", semantic_on=True, sem_label_decimation=3),
    dict(feature_update="pallas", _ray=True, _neus=True, consistency_loss_on=True),
    dict(opt_adam=False, consistency_loss_on=True, normal_loss_on=True, _normals=True),
]


def _jax_draws(key, s, mode, n_valid, steps):
    """The batch (or ray) indices and consistency near draws JAX's body
    takes at each step (trainer.py:969-988, :1190-1198, :360-368)."""
    idx, near_i, near_s = [], [], []
    B = s.bs * (s.ray_sample_count if s.ray_loss else 1)
    hi = n_valid // s.ray_sample_count if s.ray_loss else n_valid
    for _ in range(steps):
        key, k_idx, k_loss = jax.random.split(key, 3)
        idx.append(np.asarray(jax.random.randint(k_idx, (s.bs,), 0, hi)))
        if s.consistency_loss_on:
            kc = k_loss if mode == "dense" else jax.random.fold_in(k_loss, 7)
            k1, k2 = jax.random.split(kc)
            cnt = min(s.consistency_count, B)
            r = s.consistency_range * s.scale
            near_i.append(np.asarray(jax.random.randint(k1, (cnt,), 0, B)))
            near_s.append(np.asarray(jax.random.uniform(k2, (cnt, 3), jnp.float32, -r, r)))
    out = {"batch_indices": torch.from_numpy(np.stack(idx))}
    if near_i:
        out["near_indices"] = torch.from_numpy(np.stack(near_i))
        out["near_shifts"] = torch.from_numpy(np.stack(near_s))
    return out


def _sr_noise(shapes, steps):
    R = sum(C * D // 128 for C, D in shapes)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.bits(jax.random.PRNGKey(t), (R, 128), jnp.uint32)
                   & jnp.uint32(0xFFFF)).astype(np.int32).reshape(-1)
        for t in range(steps)]))


def run_both(combo, steps=STEPS, adam_eps=1e-3, shadow=None, bs=None):
    """``steps`` steps of the flag-matrix case ``combo`` in each package.
    ``shadow``: a function of the feature shapes giving numpy importance /
    last-frame tables (continual reg).  Returns a dict of both sides'
    results (numpy, the JAX layout)."""
    combo = dict(combo)
    flags = {k: combo.pop(k) for k in list(combo) if k.startswith("_")}
    ray = flags.get("_ray", False)
    if ray:
        pool, surf, ray_kw = make_ray_pool()
        combo.update(ray_loss=True, main_loss_type="dr_neus" if flags.get("_neus") else "dr")
    else:
        pool, surf = make_sphere_pool(800, seed=13)
        ray_kw = {}
    if flags.get("_normals"):
        pool.normal_label = (pool.coord / np.maximum(
            np.linalg.norm(pool.coord, axis=1, keepdims=True), 1e-9)).astype(np.float32)
    if combo.get("semantic_on"):
        pool.sem_label = np.random.default_rng(1).integers(
            0, 20, pool.coord.shape[0]).astype(np.int32)
    if combo.get("time_conditioned"):
        pool.time = np.random.default_rng(2).integers(
            0, 5, pool.coord.shape[0]).astype(np.float32)
    cfg = default_cfg(bs=bs or (128 if ray else 512), **ray_kw)
    if combo.get("time_conditioned"):
        cfg.time_conditioned = True
    grid_j, s_j, params_j, _, dev_j, n_valid = build(cfg, pool, surf, adam_eps=adam_eps,
                                                     **combo)
    if flags.get("_n_used"):
        s_j = dataclasses.replace(s_j, n_used=jtrainer.used_rows_for(grid_j))
    if flags.get("_params_bf16"):
        params_j = dict(params_j, features=tuple(
            f.astype(jnp.bfloat16) for f in params_j["features"]))
    opt_j = jinit(params_j, moments_bf16=flags.get("_moments_bf16", False))
    shapes = tuple(tuple(f.shape) for f in params_j["features"])
    params_np, opt_np = jax.device_get(params_j), jax.device_get(opt_j)
    params_j = jax.tree_util.tree_map(jnp.array, params_np)

    # the port: its grid from the JAX grid's state, the same pool object
    grid_t = HashGridHost.from_state_dict(grid_j.state_dict(), device="cpu")
    s_t = trainer.TrainSettings(**dataclasses.asdict(s_j))
    params_t = interop.params_from_jax(params_np, device="cpu")
    opt_t = interop.opt_state_from_jax(opt_np, params_t)
    dev_t, n_t = trainer.pool_to_device(pool, 1 << 14, device="cpu", settings=s_t)
    assert n_t == int(n_valid)

    shadow_j, shadow_t = jtrainer.empty_shadow(params_j["features"]), None
    if shadow is not None:
        sh = shadow(shapes)
        shadow_j = {k: tuple(jnp.asarray(t) for t in v) for k, v in sh.items()}
        shadow_t = interop.shadow_from_jax(sh, device="cpu")
    kw_j, kw_t = {}, {}
    if flags.get("_batch_windows"):
        caps = tuple(C for C, _ in shapes)
        pre_j = jtrainer.precompute_pool_lookups(tuple(grid_j.tables), dev_j["coord"],
                                                 tuple(grid_j.levels), caps)
        pre_t = trainer.precompute_pool_lookups(grid_t.tables, dev_t["coord"],
                                                grid_t.levels, caps)
        fused = flags.get("_windows_fused", False)
        if fused:
            wx = jtrainer.precompute_batch_windows_fused(
                pre_j, dev_j, int(n_valid), jax.random.PRNGKey(3), s_j, shapes)
            kw_j = dict(batch_windows=wx)
        else:
            wx = jtrainer.precompute_batch_windows(pre_j, int(n_valid), jax.random.PRNGKey(3),
                                                   s_j, shapes)
            kw_j = dict(pre_lookups=pre_j, batch_windows=wx)
        win = trainer.precompute_batch_windows(
            pre_t, n_t, None, s_t, shapes, fused=fused,
            window_indices=torch.from_numpy(np.asarray(wx["idx"])))
        kw_t = dict(pre_lookups=pre_t, batch_windows=win)
        if flags.get("_params_bf16"):
            kw_t["sr_noise16"] = _sr_noise(shapes, steps)
    key = jax.random.PRNGKey(0)
    if not kw_t:
        mode = jtrainer.resolve_feature_update(s_j, shapes)
        kw_t = _jax_draws(key, s_t, mode, int(n_valid), steps)
    p_j, o_j, aux_j = jtrainer.train_chunk(
        params_j, opt_j, tuple(grid_j.tables), dev_j, shadow_j, n_valid, jnp.int32(0),
        key, s_j, steps, **kw_j)
    p_t, o_t, aux_t = trainer.train_chunk(
        params_t, opt_t, grid_t.tables, dev_t, n_t, 0, None, s_t, steps, shadow=shadow_t,
        **kw_t)
    return dict(flags=flags, settings=s_t, params_np=params_np,
                aux_j=jax.device_get(aux_j), aux_t=aux_t,
                got=interop.params_to_jax(p_t), opt_got=interop.opt_state_to_jax(o_t),
                want=jax.device_get(p_j), opt_want=jax.device_get(o_j))


def assert_trajectories_agree(r, steps=STEPS, rtol=1e-4, atol=1e-5, moment_atol_rel=0.0):
    """The tolerances of the module docstring, by case; ``moment_atol_rel``
    widens the f32 moments' atol to that share of the table's largest
    moment (the continual reg's, tests/test_torch_sparse_adam.py)."""
    flags = r["flags"]
    bf16_p = flags.get("_params_bf16", False)
    bf16_m = flags.get("_moments_bf16", False)
    loss_rtol = 2e-4 if bf16_p else rtol
    for k in ("mean", "last"):
        for term, want in r["aux_j"][k].items():
            np.testing.assert_allclose(float(r["aux_t"][k][term]), float(want),
                                       rtol=loss_rtol, atol=1e-7, err_msg=f"{k} {term}")
    got, want = r["got"], r["want"]
    assert r["opt_got"]["step"] == int(r["opt_want"].step) == steps
    dec_tol = dict(rtol=rtol, atol=atol)
    for grp in ("geo", "sem"):
        for leaf in want[grp]:
            if bf16_p:
                assert (np.linalg.norm(got[grp][leaf] - want[grp][leaf])
                        <= 0.05 * np.linalg.norm(want[grp][leaf]) + 1e-6), f"{grp}.{leaf}"
            else:
                np.testing.assert_allclose(got[grp][leaf], want[grp][leaf], **dec_tol,
                                           err_msg=f"{grp}.{leaf}")
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=rtol, atol=atol)
    for i, b in enumerate(want["features"]):
        a = np.asarray(got["features"][i], np.float32)
        b = np.asarray(b, np.float32)
        if bf16_p:
            ulp = np.abs(b) * 2.0 ** -7 + 1e-30
            assert np.mean(np.abs(a - b) <= ulp) >= 0.98, f"features[{i}]"
        elif bf16_m:
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4, err_msg=f"features[{i}]")
            assert np.mean(np.isclose(a, b, rtol=rtol, atol=atol)) >= 0.999
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"features[{i}]")
            for mom in ("m", "v"):
                w = np.asarray(getattr(r["opt_want"], mom)["features"][i])
                np.testing.assert_allclose(
                    r["opt_got"][mom]["features"][i], w, rtol=rtol,
                    atol=max(atol, moment_atol_rel * float(np.abs(w).max())),
                    err_msg=f"{mom} features[{i}]")


def combo_ids(combos):
    return [str(sorted(c.items())) for c in combos]


def check_combo(combo):
    r = run_both(combo)
    assert_trajectories_agree(r)
    assert all(np.isfinite(np.asarray(f, np.float32)).all() for f in r["got"]["features"])


# the matrix's first half here, its kernel and window half in
# tests/test_torch_options_kernel.py: pytest-xdist spreads files, not cases
@pytest.mark.parametrize("combo", COMBOS[:12], ids=combo_ids(COMBOS[:12]))
def test_flag_combo_matches_jax(combo):
    check_combo(combo)


REFUSED = [
    (dict(feature_update="sparse"), dict(moments_bf16=True), "moments_bf16"),
    (dict(feature_update="fused"), dict(moments_bf16=True), "moments_bf16"),
    (dict(opt_adam=False), dict(moments_bf16=True), "moments_bf16"),
    (dict(feature_update="pallas"), dict(params_bf16=True), "params_bf16"),
    (dict(feature_update="pallas", ray_loss=True, main_loss_type="dr"),
     dict(windows=True), "batch_windows"),
    (dict(feature_update="pallas", consistency_loss_on=True), dict(windows=True),
     "batch_windows"),
    (dict(feature_update="sparse"), dict(windows=True), "batch_windows"),
]


@pytest.mark.parametrize("settings_kw,state_kw,match", REFUSED,
                         ids=[f"{sorted(a.items())}-{sorted(b)}" for a, b, _ in REFUSED])
def test_refused_combos_raise_in_both(settings_kw, state_kw, match):
    """What the JAX package refuses (trainer.py:756-836) the port refuses:
    bf16 moments off the kernel update, bf16 tables off fused windows,
    windows under the ray loss, consistency or another update."""
    pool, surf = make_sphere_pool(400, seed=3)
    cfg = default_cfg(bs=256)
    grid_j, s_j, params_j, _, dev_j, n_valid = build(cfg, pool, surf, **settings_kw)
    shapes = tuple(tuple(f.shape) for f in params_j["features"])
    grid_t = HashGridHost.from_state_dict(grid_j.state_dict(), device="cpu")
    s_t = trainer.TrainSettings(**dataclasses.asdict(s_j))
    params_t = interop.params_from_jax(jax.device_get(params_j), device="cpu")
    if state_kw.get("params_bf16"):
        params_j = dict(params_j, features=tuple(f.astype(jnp.bfloat16)
                                                 for f in params_j["features"]))
        params_t["features"] = [f.to(torch.bfloat16) for f in params_t["features"]]
    bf16m = state_kw.get("moments_bf16", False) or state_kw.get("params_bf16", False)
    opt_j = jinit(params_j, moments_bf16=bf16m)
    opt_t = init_opt_state(params_t, moments_bf16=bf16m)
    dev_t, n_t = trainer.pool_to_device(pool, 1 << 14, device="cpu", settings=s_t)
    kw_j, kw_t = {}, {}
    if state_kw.get("windows"):
        caps = tuple(C for C, _ in shapes)
        pre_j = jtrainer.precompute_pool_lookups(tuple(grid_j.tables), dev_j["coord"],
                                                 tuple(grid_j.levels), caps)
        pre_t = trainer.precompute_pool_lookups(grid_t.tables, dev_t["coord"],
                                                grid_t.levels, caps)
        ok = dataclasses.replace(s_j, ray_loss=False, consistency_loss_on=False,
                                 feature_update="pallas")
        wx = jtrainer.precompute_batch_windows(pre_j, int(n_valid), jax.random.PRNGKey(3),
                                               ok, shapes)
        kw_j = dict(pre_lookups=pre_j, batch_windows=wx)
        win = trainer.precompute_batch_windows(
            pre_t, n_t, None, trainer.TrainSettings(**dataclasses.asdict(ok)), shapes,
            fused=False, window_indices=torch.from_numpy(np.asarray(wx["idx"])))
        kw_t = dict(pre_lookups=pre_t, batch_windows=win)
    with pytest.raises(ValueError, match=match):
        jtrainer.train_chunk(params_j, opt_j, tuple(grid_j.tables), dev_j,
                             jtrainer.empty_shadow(params_j["features"]), n_valid,
                             jnp.int32(0), jax.random.PRNGKey(0), s_j, 1, **kw_j)
    with pytest.raises(ValueError, match=match):
        trainer.train_chunk(params_t, opt_t, grid_t.tables, dev_t, n_t, 0,
                            torch.Generator().manual_seed(0), s_t, 1, **kw_t)
