"""The port's lazy Adam (``train/sparse_adam.py``, ``feature_update:
sparse``) against the JAX package's, mirroring tests/test_sparse_adam.py.

Tolerances: the port sums a row's duplicates directly (rtol 1e-5, atol
1e-6 against a float64 bincount) where JAX takes cumsum differences, which
carry an error of about eps * |prefix sum|: against JAX the summed
gradients are held to rtol 1e-5 and an atol of 8 eps times the largest
|prefix sum|.  Trajectories are held as tests/test_torch_trainer.py holds
the kernel's (rtol 1e-4, atol 1e-5 after 30 steps at adam_eps 1e-3), the
reg values and losses to rtol 1e-4; under the reg the moments are sums of
large terms of both signs, so their atol is also 1e-6 of the table's
largest moment, as tests/test_torch_incre.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_mapping_tpu.train.sparse_adam import segment_by_row as jsegment
from shine_mapping_tpu.train.sparse_adam import sparse_adam_level as jsparse_level
from shine_mapping_tpu_torch.train import sparse_adam
from tests.test_torch_options import _one_thread, assert_trajectories_agree, run_both  # noqa: F401
from tests.test_torch_trainer import _train_both, worlds  # noqa: F401  (fixture)


def _jax_rows(seg):
    valid = np.asarray(seg.valid)
    return np.asarray(seg.rows)[valid], np.asarray(seg.grads)[valid]


def test_segment_by_row_sums_duplicates_and_skips_the_trashbin():
    corners = torch.tensor([[0, 1, 1, 2, 2, 2, 5, 9]])
    seg = sparse_adam.segment_by_row(corners, torch.ones(1, 8, 4), table_rows=10)
    assert seg.rows.tolist() == [0, 1, 2, 5]
    assert seg.grads[:, 0].tolist() == [1.0, 2.0, 3.0, 1.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_by_row_matches_bincount_and_jax(seed):
    rng = np.random.default_rng(seed)
    B, D, R = 300, 8, 120
    corners = rng.integers(0, R, (B, 8)).astype(np.int32)
    contribs = rng.standard_normal((B, 8, D)).astype(np.float32)
    order = np.argsort(corners.reshape(-1), kind="stable")
    prefix = np.abs(np.cumsum(contribs.reshape(-1, D)[order], axis=0)).max()
    seg = sparse_adam.segment_by_row(torch.from_numpy(corners), torch.from_numpy(contribs), R)
    dense = np.zeros((R, D), np.float64)
    np.add.at(dense, corners.reshape(-1), contribs.reshape(-1, D))
    dense[R - 1] = 0.0
    got = np.zeros((R, D))
    got[seg.rows.numpy()] = seg.grads.numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-6)
    jrows, jgrads = _jax_rows(jsegment(jnp.asarray(corners), jnp.asarray(contribs), R))
    np.testing.assert_array_equal(seg.rows.numpy(), jrows)
    np.testing.assert_allclose(seg.grads.numpy(), jgrads, rtol=1e-5,
                               atol=8 * np.finfo(np.float32).eps * prefix)


@pytest.mark.parametrize("reg", [False, True], ids=["plain", "reg"])
def test_sparse_adam_level_matches_jax(reg):
    """One lazy step from the same state: touched rows stepped with the
    global step's bias corrections, untouched rows and their moments left
    as they are, the trashbin zero, the reg value and gradient as JAX's."""
    rng = np.random.default_rng(2)
    C, D, B, t, lr = 200, 8, 64, 7, 0.01
    p = rng.normal(0, 0.1, (C, D)).astype(np.float32)
    p[-1] = 0.0
    m = rng.normal(0, 1e-3, (C, D)).astype(np.float32)
    v = rng.uniform(0, 1e-5, (C, D)).astype(np.float32)
    m[-1] = v[-1] = 0.0
    corners = rng.integers(0, C, (B, 8)).astype(np.int32)
    corners[:5] = C - 1  # misses
    g = rng.normal(0, 1e-2, (B, 8, D)).astype(np.float32)
    imp = rng.uniform(0, 2, (C, D)).astype(np.float32)
    last = (p + rng.normal(0, 1e-2, (C, D))).astype(np.float32)
    kw_j = dict(reg_lambda=1e2, importance=jnp.asarray(imp), last_frame=jnp.asarray(last)) \
        if reg else {}
    fj, mj, vj, rj = jsparse_level(jnp.asarray(p), jnp.asarray(m), jnp.asarray(v),
                                   jsegment(jnp.asarray(corners), jnp.asarray(g), C),
                                   jnp.float32(lr), jnp.int32(t), eps=1e-3, **kw_j)
    pt, mt, vt = (torch.from_numpy(a.copy()) for a in (p, m, v))
    kw_t = dict(reg_lambda=1e2, importance=torch.from_numpy(imp),
                last_frame=torch.from_numpy(last)) if reg else {}
    rt = sparse_adam.sparse_adam_level(
        pt, mt, vt, sparse_adam.segment_by_row(torch.from_numpy(corners),
                                               torch.from_numpy(g), C),
        lr, 1 - 0.9 ** t, 1 - 0.99 ** t, eps=1e-3, **kw_t)
    for a, b in ((pt, fj), (mt, mj), (vt, vj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-7)
    touched = np.zeros(C, bool)
    touched[corners.reshape(-1)] = True
    touched[-1] = False
    np.testing.assert_array_equal(pt.numpy()[~touched], p[~touched])
    np.testing.assert_array_equal(mt.numpy()[~touched], m[~touched])
    assert not pt[-1].any() and not mt[-1].any() and not vt[-1].any()
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-5)
    assert (float(rt) > 0) == reg


def test_sparse_and_dense_gradients_are_equal():
    """The segment sums of d loss / d rows equal autodiff's dense table
    gradient (gather and scatter are linear)."""
    from shine_mapping_tpu_torch.train.trainer import feat_from_rows

    rng = np.random.default_rng(3)
    C, D, B = 150, 8, 200
    table = torch.from_numpy(rng.normal(0, 0.1, (C, D)).astype(np.float32))
    corners = torch.from_numpy(rng.integers(0, C - 1, (B, 8)))
    found = [torch.from_numpy(rng.uniform(size=B) > 0.2)]
    coords = torch.from_numpy(rng.uniform(-1, 1, (B, 3)).astype(np.float32))
    corners = torch.where(found[0][:, None], corners, C - 1)

    def loss(rows):
        f = feat_from_rows(coords, [rows], found, (4,), True)
        return torch.sum(torch.tanh(f) ** 2)

    tab = table.clone().requires_grad_()
    loss(tab[corners]).backward()
    G = table[corners].clone().requires_grad_()
    loss(G).backward()
    seg = sparse_adam.segment_by_row(corners, G.grad, C)
    got = torch.zeros(C, D)
    got[seg.rows] = seg.grads
    want = tab.grad.clone()
    assert not want[-1].any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)


def test_sparse_train_chunk_trajectory_matches_jax(worlds):  # noqa: F811
    """30 steps of feature_update: sparse on the synthetic world, as
    tests/test_torch_trainer.py holds the kernel update."""
    got, opt_got, want, opt_want = _train_both(worlds, "sparse", False, adam_eps=1e-3)
    for grp in ("geo", "sem"):
        for leaf in want[grp]:
            np.testing.assert_allclose(got[grp][leaf], want[grp][leaf], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{grp}.{leaf}")
    for i in range(len(want["features"])):
        for name, a, b in (("p", got["features"][i], want["features"][i]),
                           ("m", opt_got["m"]["features"][i], opt_want.m["features"][i]),
                           ("v", opt_got["v"]["features"][i], opt_want.v["features"][i])):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} features[{i}]")
        assert not np.any(got["features"][i][-1])


def _shadow(shapes):
    rng = np.random.default_rng(5)
    return {"importance": tuple(rng.uniform(0, 2, sh).astype(np.float32) for sh in shapes),
            "last_frame": tuple(rng.normal(0, 0.01, sh).astype(np.float32) for sh in shapes)}


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_continual_reg_trajectory_and_values_match_jax(mode):
    """Sparse + reg (JAX body_sparse) and dense + reg (``_continual_reg``):
    the reg values every step's mean and last, and the trajectory."""
    r = run_both(dict(feature_update=mode, continual_reg_on=True, lambda_forget=1e3),
                 shadow=_shadow)
    assert float(r["aux_t"]["last"]["reg_loss"]) > 0
    assert_trajectories_agree(r, moment_atol_rel=1e-6)
