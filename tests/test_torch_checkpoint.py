"""The checkpoint format both ways: the port's utils/checkpoint.py against
the JAX package's.

A map grown by JAX with random moments: its checkpoint loads into the port
and gives the same SDF at 10k points (atol 1e-6) and equal optimizer state;
the port's checkpoint of the same map loads into JAX the same way; the two
files hold the same keys, tree strings and arrays, key by key; bf16
moments cross as their bits."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shine_mapping_tpu.config import SHINEConfig as JaxConfig
from shine_mapping_tpu.ops.hashgrid import HashGridHost as JaxGrid
from shine_mapping_tpu.ops.query import query_feature as jax_query_feature
from shine_mapping_tpu.models import decoder as jdecoder
from shine_mapping_tpu.train import optimizer as joptimizer
from shine_mapping_tpu.train import trainer as jtrainer
from shine_mapping_tpu.utils import checkpoint as jckpt
from shine_mapping_tpu_torch.config import SHINEConfig
from shine_mapping_tpu_torch.interop import opt_state_from_jax, opt_state_to_jax, params_from_jax
from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
from shine_mapping_tpu_torch.ops.query import query_feature
from shine_mapping_tpu_torch.train import trainer
from shine_mapping_tpu_torch.train.optimizer import init_opt_state
from shine_mapping_tpu_torch.utils import checkpoint as ckpt


def _cfg(cls):
    cfg = cls()
    cfg.tree_level_world, cfg.tree_level_feat = 7, 3
    cfg.derive()
    return cfg


def _jax_map(moments_bf16=False):
    """A JAX grid, params with trained-looking features, and Adam state with
    random moments at step 37."""
    cfg = _cfg(JaxConfig)
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((3000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    grid = JaxGrid(7, 3, 8, 0.05, seed=0, init_node_capacity=1 << 12,
                   init_corner_capacity=1 << 12)
    grid.update((dirs * 0.5).astype(np.float32))
    params = jtrainer.init_params(cfg, grid, jax.random.PRNGKey(3))
    opt = joptimizer.init_opt_state(params, moments_bf16=moments_bf16)
    leaves, tdef = jax.tree_util.tree_flatten(opt.m)
    leaves = [jnp.asarray(rng.standard_normal(x.shape), x.dtype) for x in leaves]
    vleaves = [jnp.asarray(rng.uniform(0, 1, x.shape), x.dtype)
               for x in jax.tree_util.tree_leaves(opt.v)]
    opt = joptimizer.OptState(m=tdef.unflatten(leaves), v=tdef.unflatten(vleaves),
                              step=jnp.int32(37))
    return cfg, grid, params, opt


def _points(n=10_000, seed=1):
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (dirs * rng.uniform(0.4, 0.6, (n, 1))).astype(np.float32)


def _sdf_jax(grid, params, x):
    feat = jax_query_feature(jnp.asarray(x), grid.tables, list(params["features"]),
                             grid.levels, True)
    return np.asarray(jdecoder.sdf(params["geo"], feat))


@torch.no_grad()
def _sdf_port(grid, params, x):
    feat = query_feature(torch.from_numpy(x), grid.tables, params["features"], grid.levels, True)
    return params["geo"].sdf(feat).numpy()


def _port_skeleton():
    cfg = _cfg(SHINEConfig)
    grid = HashGridHost(7, 3, 8, 0.05, device="cpu")
    params = trainer.init_params(cfg, grid, torch.Generator().manual_seed(9))
    return params, init_opt_state(params)


def _assert_opt_equal(port_opt, jax_opt):
    want = jax.device_get(jax_opt)
    got = opt_state_to_jax(port_opt)
    for a, b in zip(jax.tree_util.tree_leaves((got["m"], got["v"])),
                    jax.tree_util.tree_leaves((want.m, want.v))):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16) if a.dtype.itemsize == 2 else a,
                                      b.view(np.uint16) if b.dtype.itemsize == 2 else b)
    assert got["step"] == int(want.step)


@pytest.mark.parametrize("moments_bf16", [False, True])
def test_jax_checkpoint_loads_into_port(tmp_path, moments_bf16):
    _, jgrid, jparams, jopt = _jax_map(moments_bf16)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jgrid, jparams, jopt, 37)
    skeleton, opt_like = _port_skeleton()
    grid, params, opt, iters = ckpt.load_checkpoint(path, skeleton, opt_like, device="cpu")
    assert iters == 37 and grid.corner_counts == [hl.n_corners for hl in jgrid.host_levels]
    x = _points()
    np.testing.assert_allclose(_sdf_port(grid, params, x), _sdf_jax(jgrid, jparams, x),
                               rtol=0, atol=1e-6)
    _assert_opt_equal(opt, jopt)


@pytest.mark.parametrize("moments_bf16", [False, True])
def test_port_checkpoint_loads_into_jax(tmp_path, moments_bf16):
    _, jgrid, jparams, jopt = _jax_map(moments_bf16)
    grid = HashGridHost.from_state_dict(jgrid.state_dict(), device="cpu")
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    opt = opt_state_from_jax(jax.device_get(jopt), params)
    path = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(path, grid, params, opt, 37)
    like = jtrainer.init_params(_cfg(JaxConfig), jgrid, jax.random.PRNGKey(0))
    grid2, params2, opt2, iters = jckpt.load_checkpoint(
        path, like, joptimizer.init_opt_state(like, moments_bf16=moments_bf16))
    assert iters == 37
    x = _points()
    np.testing.assert_allclose(_sdf_jax(grid2, params2, x), _sdf_port(grid, params, x),
                               rtol=0, atol=1e-6)
    _assert_opt_equal(opt, opt2)
    # and back into the port: the same bits as saved
    skeleton, opt_like = _port_skeleton()
    _, params3, opt3, _ = ckpt.load_checkpoint(path, skeleton, opt_like, device="cpu")
    _assert_opt_equal(opt3, jopt)
    for k, t in params["geo"].state_dict().items():
        assert torch.equal(params3["geo"].state_dict()[k], t)


def test_key_sets_and_arrays_equal_key_by_key(tmp_path):
    """The same map saved by each package: the same keys, in the same
    flatten order, with equal arrays (the treedef strings included)."""
    _, jgrid, jparams, jopt = _jax_map(moments_bf16=True)
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), jgrid, jparams, jopt, 5)
    grid = HashGridHost.from_state_dict(jgrid.state_dict(), device="cpu")
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    ckpt.save_checkpoint(str(tmp_path / "p.npz"), grid, params,
                         opt_state_from_jax(jax.device_get(jopt), params), 5)
    a, b = np.load(str(tmp_path / "p.npz")), np.load(str(tmp_path / "j.npz"))
    assert sorted(a.files) == sorted(b.files)
    assert any(k.endswith("__bf16") for k in a.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # decoders-only exports
    jckpt.save_decoders(str(tmp_path / "jd.npz"), jparams)
    ckpt.save_decoders(str(tmp_path / "pd.npz"), params)
    a, b = np.load(str(tmp_path / "pd.npz")), np.load(str(tmp_path / "jd.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    dec = ckpt.load_decoders(str(tmp_path / "jd.npz"), device="cpu")
    for k, t in params["geo"].state_dict().items():
        assert torch.equal(dec["geo"].state_dict()[k], t)


def test_bf16_tables_round_trip(tmp_path):
    """bf16 tables (the bf16 map mode) and bf16 moments: the checkpoint holds
    the tables' exact f32 upcast and the moments' bits, so casting back
    restores the same bits."""
    _, jgrid, jparams, jopt = _jax_map(moments_bf16=True)
    grid = HashGridHost.from_state_dict(jgrid.state_dict(), device="cpu")
    grid.cast_features(torch.bfloat16)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    params["features"] = list(grid.features)
    opt = opt_state_from_jax(jax.device_get(jopt), params)
    path = str(tmp_path / "bf16.npz")
    ckpt.save_checkpoint(path, grid, params, opt, 11)
    skeleton, opt_like = _port_skeleton()
    grid2, params2, opt2, _ = ckpt.load_checkpoint(path, skeleton, opt_like, device="cpu")
    grid2.cast_features(torch.bfloat16)
    for a, b in zip(grid2.features, grid.features):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for a, b in zip(opt2.m["features"] + opt2.v["features"], opt.m["features"] + opt.v["features"]):
        assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), b.view(torch.int16))
