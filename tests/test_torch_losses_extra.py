"""The port's rendering, normal, consistency and semantic losses against the
JAX package's on the same numpy inputs: values and gradients to rtol 1e-5
(float32, the same formulas in the same order; atol 1e-7 for gradient
entries that cancel to ~0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_mapping_tpu.train import losses as jl
from shine_mapping_tpu_torch.train import losses as tl

RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's thread pools in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(jfn, tfn, *arrays, argnums=(0,)):
    """Value and gradients w.r.t. ``argnums`` of both packages' loss."""
    jv, jg = jax.value_and_grad(jfn, argnums=argnums)(*[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=(i in argnums)) for i, a in enumerate(arrays)]
    tv = tfn(*ts)
    tv.backward()
    tg = [ts[i].grad.numpy() for i in argnums]
    return float(jv), [np.asarray(g) for g in jg], float(tv.detach()), tg


def _check(jfn, tfn, *arrays, argnums=(0,)):
    jv, jg, tv, tg = _both(jfn, tfn, *arrays, argnums=argnums)
    np.testing.assert_allclose(tv, jv, rtol=RTOL)
    for a, b in zip(tg, jg):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _rays(rng, R=64, S=7, saturate=False):
    depth = rng.uniform(1.0, 20.0, (R, S)).astype(np.float32)
    occ = rng.uniform(0.0, 1.0, (R, S)).astype(np.float32)
    if saturate:
        # occupancy jumping 0 -> 1 along a ray: the NeuS alpha clips at 1
        occ = np.where(np.argsort(np.argsort(depth, 1), 1) >= S // 2, 1.0, 0.0).astype(np.float32)
    meas = rng.uniform(1.0, 20.0, (R,)).astype(np.float32)
    return depth, occ, meas


@pytest.mark.parametrize("neus_on", [True, False], ids=["dr_neus", "dr"])
@pytest.mark.parametrize("saturate", [False, True], ids=["soft", "saturated"])
def test_batch_ray_rendering_loss_matches_jax(neus_on, saturate):
    rng = np.random.default_rng(1)
    x, y, d = _rays(rng, saturate=saturate)
    _check(lambda a, b, c: jl.batch_ray_rendering_loss(a, b, c, neus_on),
           lambda a, b, c: tl.batch_ray_rendering_loss(a, b, c, neus_on),
           x, y, d, argnums=(1,))


def test_normal_loss_matches_jax():
    rng = np.random.default_rng(2)
    g = rng.normal(size=(200, 3)).astype(np.float32)
    g[:5] = 0.0  # all-levels-missed samples: zero point gradient, zero subgradient
    n = rng.normal(size=(200, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    mask = rng.uniform(size=200) > 0.4
    _check(lambda a, b: jl.normal_loss(a, b, jnp.asarray(mask)),
           lambda a, b: tl.normal_loss(a, b, torch.from_numpy(mask)), g, n)


def test_consistency_loss_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(300, 3)).astype(np.float32)
    b = (a + 0.3 * rng.normal(size=(300, 3))).astype(np.float32)
    a[:3] = 0.0
    _check(jl.consistency_loss, tl.consistency_loss, a, b, argnums=(0, 1))


def test_sem_nll_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(257, 21)).astype(np.float32)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=1))
    label = rng.integers(0, 21, 257).astype(np.int32)
    _check(lambda a: jl.sem_nll_loss(a, jnp.asarray(label)),
           lambda a: tl.sem_nll_loss(a, torch.from_numpy(label)), logp)
