"""The port's map ops (morton, interp, hashgrid, query) against the JAX
package's, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_mapping_tpu.ops import hashgrid as jhash
from shine_mapping_tpu.ops import interp as jinterp
from shine_mapping_tpu.ops import morton as jmorton
from shine_mapping_tpu.ops import query as jquery
from shine_mapping_tpu_torch.ops import hashgrid as thash
from shine_mapping_tpu_torch.ops import interp as tinterp
from shine_mapping_tpu_torch.ops import morton as tmorton
from shine_mapping_tpu_torch.ops import query as tquery


def _points(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    # exact cell faces, the cube's faces and values one ulp inside them
    x[:8] = np.array([-1, 1, 0, 0.5, -0.5, 0.25, np.nextafter(1, 0, dtype=np.float32),
                      np.nextafter(-1, 0, dtype=np.float32)], np.float32)[:, None]
    return x


@pytest.mark.parametrize("level", [1, 5, 12, 15])
def test_quantize_points_bit_exact(level):
    x = _points(4096, level)
    want = np.asarray(jmorton.quantize_points(jnp.asarray(x), level))
    got = tmorton.quantize_points(torch.from_numpy(x), level).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tmorton.quantize_points_np(x, level))


def test_morton_codecs_identical():
    q = np.random.default_rng(0).integers(0, 1 << 15, (1000, 3)).astype(np.int32)
    code = tmorton.points_to_morton_np(q)
    np.testing.assert_array_equal(code, jmorton.points_to_morton_np(q))
    np.testing.assert_array_equal(tmorton.morton_to_points_np(code), q)
    np.testing.assert_array_equal(tmorton.CORNER_OFFSETS, jmorton.CORNER_OFFSETS)


@pytest.mark.parametrize("poly", [True, False])
def test_corner_weights_match_jax(poly):
    """atol 1e-6: the same float32 formula, rounded in another order."""
    x = _points(4096, 1)
    for level in (3, 8):
        want = np.asarray(jinterp.corner_weights(jnp.asarray(x), level, poly))
        got = tinterp.corner_weights(torch.from_numpy(x), level, poly).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def _grow_both(seed=0):
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((3000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    surf = (dirs * rng.uniform(0.45, 0.55, (3000, 1))).astype(np.float32)
    kw = dict(max_level=7, featured_level_num=3, feature_dim=8, feature_std=0.05,
              seed=11, init_node_capacity=1 << 8, init_corner_capacity=1 << 8)
    jg = jhash.HashGridHost(**kw)
    tg = thash.HashGridHost(**kw, device="cpu")
    # two growth steps: the second inserts incrementally, and the small
    # initial capacities force table rebuilds and feature-table doubling
    for part in (surf[:1500], surf[1500:]):
        jg.update(part)
        tg.update(part)
    return jg, tg


def test_hashgrid_growth_identical():
    jg, tg = _grow_both()
    sj, st = jg.state_dict(), tg.state_dict()
    assert sj.keys() == st.keys()
    for k in sj:
        np.testing.assert_array_equal(np.asarray(sj[k]), np.asarray(st[k]), err_msg=k)
    for a, b in zip(jg.tables, tg.tables):
        np.testing.assert_array_equal(np.asarray(a.keys), b.keys.numpy())
        np.testing.assert_array_equal(np.asarray(a.corner_idx), b.corner_idx.numpy())
    assert jg.corner_counts == tg.corner_counts


def test_bf16_tables_grow_as_the_jax_tables_cast():
    """``cast_features(bfloat16)`` between two growth steps: the tables stay
    bf16 through the second step's inserts and doublings and hold the JAX
    package's float32 tables rounded to nearest even (the JAX batch
    driver's cast), bit for bit."""
    import ml_dtypes

    jg, _ = _grow_both()
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((3000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    surf = (dirs * rng.uniform(0.45, 0.55, (3000, 1))).astype(np.float32)
    tg = thash.HashGridHost(max_level=7, featured_level_num=3, feature_dim=8,
                            feature_std=0.05, seed=11, init_node_capacity=1 << 8,
                            init_corner_capacity=1 << 8, device="cpu")
    tg.update(surf[:1500])
    rows_before = [f.shape[0] for f in tg.features]
    tg.cast_features(torch.bfloat16)
    tg.update(surf[1500:])
    assert [f.shape[0] for f in tg.features] != rows_before  # a doubling happened
    for a, b in zip(jg.features, tg.features):
        assert b.dtype == torch.bfloat16
        want = np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(b.view(torch.int16).numpy().view(np.uint16), want)
    with pytest.raises(ValueError):
        tg.cast_features(torch.float16)


def test_lookup_level_identical():
    jg, tg = _grow_both()
    x = np.concatenate([_points(2000, 3) * 0.6, _points(500, 4)]).astype(np.float32)
    n_found = 0
    for i, level in enumerate(tg.levels):
        cj, fj = jhash.lookup_level(jg.tables[i], jnp.asarray(x), level)
        ct, ft = thash.lookup_level(tg.tables[i], torch.from_numpy(x), level)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        n_found += int(ft.sum())
    assert 0 < n_found < 3 * x.shape[0]  # both hits and misses exercised


def test_query_feature_and_coord_gradient_match_jax():
    """Feature and d(sum feature)/d coord: atol 1e-6 (float32 sums)."""
    jg, tg = _grow_both()
    x = (_points(1000, 5) * 0.6).astype(np.float32)

    def jfeat(c):
        return jquery.query_feature(c, jg.tables, jg.features, jg.levels, True)

    fj = np.asarray(jfeat(jnp.asarray(x)))
    gj = np.asarray(jax.grad(lambda c: jnp.sum(jfeat(c) ** 2))(jnp.asarray(x)))
    c = torch.from_numpy(x).requires_grad_()
    ft = tquery.query_feature(c, tg.tables, tg.features, tg.levels, True)
    (gt,) = torch.autograd.grad((ft ** 2).sum(), c)
    np.testing.assert_allclose(ft.detach().numpy(), fj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gt.numpy(), gj, atol=1e-5, rtol=1e-5)
