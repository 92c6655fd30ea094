"""The port's fused scatter + dense-Adam step against the JAX package's.

The port's plain version (``adam_kernel.fused_adam_plain`` /
``fused_adam_multi_plain``, what the wrappers run on the CPU) is held
against the JAX wrappers ``fused_adam_packed(lanes=True)`` (K1) and
``fused_adam_packed_multi`` (K2) with the REAL Pallas kernels run in
interpret mode (as tests/test_batch_windows.py runs them), and against their
XLA twins, with tolerance atol 5e-6 (as there).  The Pallas kernels sum the
gradient entries with a bf16 hi+lo one-hot matmul.  Run in interpret mode on
the CPU with random normal gradients, they missed the f32 sum by ~3e-5 in
about one test run in six (cause not traced), so against them the gradients
are small integers times 2**-10, which every bf16 or f32 partial sum holds
exactly.  Against the twins the gradients are random normals.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_mapping_tpu.ops import adam_kernel as jak
from shine_mapping_tpu_torch.ops import adam_kernel as tak

D = 8
PACK = 128 // D
LR, BC1, BC2 = 0.01, 0.3439, 0.0394  # bias corrections of step 4


def _level(rng, C, n_used, M, exact_grads=False):
    """One level: tables with zero moments past the used head (the n_used
    contract), M entries with duplicate rows and ~10% trashbin rows whose
    gradients are zero (as lookups produce them).  ``exact_grads``: integer
    multiples of 2**-10 below 2**-5, exact in any sum of a row's entries."""
    p = rng.normal(size=(C, D)).astype(np.float32) * 0.1
    m = rng.normal(size=(C, D)).astype(np.float32) * 0.01
    v = np.abs(rng.normal(size=(C, D))).astype(np.float32) * 1e-4
    m[n_used:] = 0.0
    v[n_used:] = 0.0
    rows = rng.integers(0, n_used, M).astype(np.int32)
    rows[M // 2: M // 2 + M // 8] = rows[: M // 8]  # duplicate rows
    trash = rng.random(M) < 0.1
    rows[trash] = C - 1
    if exact_grads:
        g = (rng.integers(-32, 33, (M, D)) * 2.0 ** -10).astype(np.float32)
    else:
        g = rng.normal(size=(M, D)).astype(np.float32) * 1e-3
    g[trash] = 0.0
    return p, m, v, rows, g


def _lanes(g, rows):
    """Narrow (M, D) gradients -> the JAX kernels' (M, 128) lane rows."""
    out = np.zeros((g.shape[0], 128), np.float32)
    lane0 = (rows % PACK) * D
    for k in range(g.shape[0]):
        out[k, lane0[k]:lane0[k] + D] = g[k]
    return out


@pytest.fixture
def interpret_pallas():
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interpreted(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pl.pallas_call = interpreted
    yield
    pl.pallas_call = orig


def _t(*arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


@pytest.mark.parametrize("n_used", [None, 2500])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_single_level_matches_jax(interpret_pallas, n_used, use_pallas):
    rng = np.random.default_rng(1)
    C, M = 4096, 2048
    p, m, v, rows, g = _level(rng, C, n_used or C - 1, M, exact_grads=use_pallas)
    if use_pallas:  # the kernel's tile windows hold these entries: no XLA fallback
        assert bool(jak.entry_prep_lanes(jnp.asarray(rows), C, D, n_used).ok)
    want = jak.fused_adam_packed(
        jnp.asarray(p.reshape(-1, 128)), jnp.asarray(m.reshape(-1, 128)),
        jnp.asarray(v.reshape(-1, 128)), jnp.asarray(rows),
        jnp.asarray(_lanes(g, rows)), jnp.float32(LR), jnp.float32(BC1),
        jnp.float32(BC2), C, D, use_pallas=use_pallas, lanes=True, n_used=n_used)
    pt, mt, vt, rt, gt = _t(p, m, v, rows, g)
    dropped = tak.fused_adam_plain(pt, mt, vt, rt, gt, LR, BC1, BC2, n_used)
    assert int(dropped) == 0
    for name, a, b in zip("pmv", (pt, mt, vt), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(C, D),
                                   atol=5e-6, rtol=0, err_msg=name)
    if n_used is not None:  # headroom rows untouched, bit for bit
        for a, b in zip((pt, mt, vt), (p, m, v)):
            np.testing.assert_array_equal(a.numpy()[n_used:], b[n_used:])


@pytest.mark.parametrize("use_pallas", [True, False])
def test_multi_level_matches_jax(interpret_pallas, use_pallas):
    rng = np.random.default_rng(2)
    sizes, n_used, M = (4096, 2048, 2048), (3000, 2048, 1500), 2048
    lr_scales = (1.0, 0.5, 0.25)
    levels = [_level(rng, C, nu, M, exact_grads=use_pallas)
              for C, nu in zip(sizes, n_used)]
    p, m, v = (np.concatenate([lv[k] for lv in levels]) for k in range(3))
    rows_l = [lv[3] for lv in levels]
    g_l = [lv[4] for lv in levels]
    want = jak.fused_adam_packed_multi(
        jnp.asarray(p.reshape(-1, 128)), jnp.asarray(m.reshape(-1, 128)),
        jnp.asarray(v.reshape(-1, 128)), [jnp.asarray(r) for r in rows_l],
        [jnp.asarray(_lanes(g, r)) for g, r in zip(g_l, rows_l)],
        jnp.float32(LR), jnp.float32(BC1), jnp.float32(BC2),
        tuple((C, D) for C in sizes), lr_scales, use_pallas=use_pallas,
        n_used=n_used)
    tabs = [[torch.from_numpy(lv[k].copy()) for lv in levels] for k in range(3)]
    dropped = tak.fused_adam_multi_plain(
        *tabs, _t(*rows_l), _t(*g_l), LR, BC1, BC2, lr_scales, n_used)
    assert int(dropped) == 0
    for name, a, b in zip("pmv", tabs, want):
        np.testing.assert_allclose(torch.cat(a).numpy(), np.asarray(b).reshape(-1, D),
                                   atol=5e-6, rtol=0, err_msg=name)
    for lv, C, nu, l in zip(levels, sizes, n_used, range(3)):  # headroom, bit for bit
        for a, b in zip(tabs, lv[:3]):
            np.testing.assert_array_equal(a[l].numpy()[nu:], b[nu:])


def test_multi_level_equals_per_level_calls():
    """K2 over all levels == K1 on each level with its lr."""
    rng = np.random.default_rng(3)
    sizes, n_used, lr_scales = (1024, 512), (700, 512), (1.0, 0.5)
    levels = [_level(rng, C, nu, 512) for C, nu in zip(sizes, n_used)]
    tabs = [[torch.from_numpy(lv[k].copy()) for lv in levels] for k in range(3)]
    tak.fused_adam_multi(*tabs, [torch.from_numpy(lv[3]) for lv in levels],
                         [torch.from_numpy(lv[4]) for lv in levels],
                         LR, BC1, BC2, lr_scales, n_used)
    for l, (lv, nu, sc) in enumerate(zip(levels, n_used, lr_scales)):
        p, m, v, rows, g = _t(*lv)
        tak.fused_adam(p, m, v, rows, g, LR * sc, BC1, BC2, nu)
        for a, b in zip((p, m, v), tabs):
            np.testing.assert_array_equal(a.numpy(), b[l].numpy())


def test_trash_gradients_are_zeroed_and_stale_heads_counted():
    rng = np.random.default_rng(4)
    C, nu = 2048, 1000
    p, m, v, rows, g = _level(rng, C, nu, 1024)
    ref = _t(p, m, v)
    tak.fused_adam(*ref, torch.from_numpy(rows), torch.from_numpy(g), LR, BC1, BC2, nu)
    # nonzero gradients on trashbin entries change nothing
    g_dirty = g.copy()
    g_dirty[rows == C - 1] = 7.0
    dirty = _t(p, m, v)
    tak.fused_adam(*dirty, torch.from_numpy(rows), torch.from_numpy(g_dirty),
                   LR, BC1, BC2, nu)
    for a, b in zip(dirty, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # entries past the used head break the n_used promise: counted, ignored
    rows_bad = rows.copy()
    rows_bad[:5] = nu + 3
    assert int(tak.fused_adam(*_t(p, m, v), torch.from_numpy(rows_bad),
                              torch.from_numpy(g), LR, BC1, BC2, nu)) == 5


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p = torch.zeros(64, D)
    rows = torch.zeros(4, dtype=torch.int32)
    g = torch.zeros(4, D)
    with pytest.raises(TypeError):
        tak.fused_adam(p.bfloat16(), p.bfloat16(), p.bfloat16(), rows, g, LR, BC1, BC2)
    with pytest.raises(ValueError):
        tak.fused_adam(p, p.clone(), p.clone(), rows, g, LR, BC1, BC2, n_used=65)
    with pytest.raises(ValueError):
        tak.fused_adam(p, p.clone()[:, :4].contiguous(), p.clone(), rows, g, LR, BC1, BC2)
    with pytest.raises(ValueError):  # one lr scale per level
        tak.fused_adam_multi([p], [p.clone()], [p.clone()], [rows], [g], LR, BC1, BC2,
                             [1.0, 0.5])
    with pytest.raises(ValueError):  # levels of different D
        narrow = [[p.clone(), p[:, :4].contiguous()] for _ in range(3)]
        tak.fused_adam_multi(*narrow, [rows] * 2, [g, g[:, :4]], LR, BC1, BC2, [1.0, 0.5])


def test_used_rows_hint_matches_jax():
    n_corners, sizes = (0, 1, 3001, 4095, 2048), (4096, 4096, 4096, 4096, 2048)
    want = jak.used_rows_hint(n_corners, [(C, D) for C in sizes])
    assert tak.used_rows_hint(n_corners, sizes) == want


# ------------------------------------------------------------------ bf16 modes
#
# bf16 moments (tpu.moments_bf16: bf16 m/v, gradient entries rounded to bf16)
# and bf16 tables (tpu.params_bf16: stochastic rounding of the new p).  The
# moments are compared bit for bit where the f32 values they round from
# agree: at most 0.1% of them may land one bf16 ulp apart (an FMA or a sum
# order moves an f32 value across a rounding tie).


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _f32(a):
    """A JAX / numpy / torch array as float32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _assert_bf16_equal_but_ties(a, b, share=0.999, err_msg=""):
    a, b = _f32(a), _f32(b)
    assert (a == b).mean() >= share, f"{err_msg}: only {(a == b).mean():.5f} bit-equal"
    np.testing.assert_array_less(np.abs(a - b), 2.0 ** -7 * np.abs(b) + 1e-30,
                                 err_msg=err_msg)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_bf16_moments_single_level_matches_jax(interpret_pallas, use_pallas):
    """K1's bf16-moment branch: the port's plain version against JAX
    ``fused_adam_packed(grads_bf16=True)`` on bf16 m/v (the Pallas kernel in
    interpret mode with gradients exact in bf16, or the XLA twin)."""
    rng = np.random.default_rng(11)
    C, M, n_used = 4096, 2048, 3000
    p, m, v, rows, g = _level(rng, C, n_used, M, exact_grads=use_pallas)
    m16, v16 = _bf16(m), _bf16(v)
    want = jak.fused_adam_packed(
        jnp.asarray(p.reshape(-1, 128)), m16.reshape(-1, 128), v16.reshape(-1, 128),
        jnp.asarray(rows), jnp.asarray(_lanes(g, rows)), jnp.float32(LR),
        jnp.float32(BC1), jnp.float32(BC2), C, D, use_pallas=use_pallas, lanes=True,
        n_used=n_used, grads_bf16=True)
    pt = torch.from_numpy(p.copy())
    mt, vt = (torch.from_numpy(_f32(a)).bfloat16() for a in (m16, v16))
    tak.fused_adam_plain(pt, mt, vt, torch.from_numpy(rows), torch.from_numpy(g),
                         LR, BC1, BC2, n_used, grads_bf16=True)
    assert mt.dtype == vt.dtype == torch.bfloat16
    np.testing.assert_allclose(pt.numpy(), np.asarray(want[0]).reshape(C, D),
                               atol=5e-6, rtol=0)
    for name, a, b in (("m", mt, want[1]), ("v", vt, want[2])):
        _assert_bf16_equal_but_ties(a, np.asarray(b).reshape(C, D), err_msg=name)
    np.testing.assert_array_equal(pt.numpy()[n_used:], p[n_used:])


def _multi_pre_inputs(rng, sizes, n_used, M_l, exact_grads):
    """Per-level tables and entries, and the JAX package's concatenated
    packed inputs of ``fused_adam_packed_multi_pre``: global packed rows,
    lane-aligned gradients in entry order and its EntryPrep."""
    from shine_mapping_tpu.ops.adam_kernel import _multi_geometry

    shapes = tuple((C, D) for C in sizes)
    levels = [_level(rng, C, nu, M_l, exact_grads) for C, nu in zip(sizes, n_used)]
    _, _, roffs, *_ = _multi_geometry(shapes, M_l * len(sizes), n_used)
    # trashbin entries (zero gradients) spread over each used head, as the
    # JAX window precompute spreads its pad entries
    prow = np.concatenate([
        np.where(lv[3] == C - 1, np.arange(M_l) % ((nu * D + 127) // 128), lv[3] // PACK)
        + int(roffs[i]) for i, (lv, C, nu) in enumerate(zip(levels, sizes, n_used))])
    trash = np.concatenate([lv[3] == C - 1 for lv, C in zip(levels, sizes)])
    g128 = np.concatenate([_lanes(lv[4], lv[3]) for lv in levels])
    pre = jak.entry_prep_multi(jnp.asarray(prow), jnp.asarray(trash), shapes, n_used)
    return shapes, levels, jnp.asarray(prow), jnp.asarray(g128), pre


@pytest.mark.parametrize("use_pallas", [True, False])
def test_bf16_moments_multi_pre_matches_jax(interpret_pallas, use_pallas):
    """K2's bf16-moment branch against JAX ``fused_adam_packed_multi_pre``
    (the epoch-window caller) with ``grads_bf16``, per-level lr scales."""
    rng = np.random.default_rng(12)
    sizes, n_used, lr_scales = (4096, 2048), (3000, 1500), (1.0, 0.5)
    shapes, levels, prow, g128, pre = _multi_pre_inputs(rng, sizes, n_used, 1024,
                                                        use_pallas)
    if use_pallas:
        assert bool(pre.ok)
    p = np.concatenate([lv[0] for lv in levels])
    m16 = _bf16(np.concatenate([lv[1] for lv in levels]))
    v16 = _bf16(np.concatenate([lv[2] for lv in levels]))
    want = jak.fused_adam_packed_multi_pre(
        jnp.asarray(p.reshape(-1, 128)), m16.reshape(-1, 128), v16.reshape(-1, 128),
        g128, prow, pre, jnp.float32(LR), jnp.float32(BC1), jnp.float32(BC2),
        shapes, lr_scales, use_pallas=use_pallas, n_used=n_used, grads_bf16=True)
    ps = [torch.from_numpy(lv[0].copy()) for lv in levels]
    ms = [torch.from_numpy(_f32(jnp.asarray(lv[1]).astype(jnp.bfloat16))).bfloat16()
          for lv in levels]
    vs = [torch.from_numpy(_f32(jnp.asarray(lv[2]).astype(jnp.bfloat16))).bfloat16()
          for lv in levels]
    tak.fused_adam_multi_plain(ps, ms, vs, _t(*[lv[3] for lv in levels]),
                               _t(*[lv[4] for lv in levels]), LR, BC1, BC2, lr_scales,
                               n_used, grads_bf16=True)
    np.testing.assert_allclose(torch.cat(ps).numpy(), np.asarray(want[0]).reshape(-1, D),
                               atol=5e-6, rtol=0)
    for name, a, b in (("m", ms, want[1]), ("v", vs, want[2])):
        _assert_bf16_equal_but_ties(torch.cat(a), np.asarray(b, np.float32).reshape(-1, D),
                                    err_msg=name)


def _jax_noise(seed, shape):
    """The 16-bit noise JAX ``sr_round_bf16`` draws for ``seed``."""
    import jax

    return np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)
                      & jnp.uint32(0xFFFF)).astype(np.int32)


def test_sr_round_bf16_plain_is_bit_exact_to_jax():
    """Same 16 noise bits -> the same bf16 bits: carries into the exponent
    (and up to infinity), negatives, subnormals, exact bf16 values, and
    non-finite values passed through."""
    rng = np.random.default_rng(13)
    bits = np.concatenate([
        rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32),
        np.array([0x3F7FFFFF, 0x3F7F8000, 0xBF7FFFFF, 0x7F7FFFFF, 0xFF7FFFFF,
                  0x0000FFFF, 0x80000001, 0x3F800000, 0x00000000, 0x80000000],
                 np.uint32)])
    x = bits.view(np.float32).copy()
    x[:200] = np.array([np.inf, -np.inf, np.nan, 1.0] * 50, np.float32)
    x = x.reshape(-1, 10)
    seed = 7
    want = jak.sr_round_bf16(jnp.asarray(x), seed)
    got = tak.sr_round_bf16_plain(torch.from_numpy(x), torch.from_numpy(_jax_noise(seed, x.shape)))
    assert got.dtype == torch.bfloat16
    gb = got.view(torch.int16).numpy().view(np.uint16)
    wb = np.asarray(want).view(np.uint16)
    finite = np.isfinite(x)
    np.testing.assert_array_equal(gb[finite], wb[finite])
    np.testing.assert_array_equal(gb[np.isinf(x)], wb[np.isinf(x)])
    assert np.isnan(got.float().numpy()[np.isnan(x)]).all()
    # the carries really happened: 0x3F7FFFFF rounds to 1.0 for some noise
    assert (got.float().numpy() == np.float32(np.inf)).any()


def test_sr_rounding_is_unbiased_and_seed_deterministic():
    """The plain bf16-table update: each new p is one of the two bf16
    neighbours of the f32 step, the rounding is unbiased (mean rounding
    error within 5 sigma of 0 over all elements), the same sr_seed gives the
    same bits and another seed other bits."""
    rng = np.random.default_rng(14)
    C, nu = 8192, 8192
    p, m, v, rows, g = _level(rng, C, nu - 1, 4096)
    p16 = torch.from_numpy(p).bfloat16()
    m16, v16 = torch.from_numpy(m).bfloat16(), torch.from_numpy(v).bfloat16()
    rows_t, g_t = [torch.from_numpy(rows)], [torch.from_numpy(g)]

    def step(seed, p_dtype=torch.bfloat16):
        tabs = [[p16.clone().to(p_dtype)], [m16.clone()], [v16.clone()]]
        tak.fused_adam_multi_plain(*tabs, rows_t, g_t, LR, BC1, BC2, [1.0], [nu],
                                   grads_bf16=True, sr_seed=seed)
        return tabs[0][0]

    exact = step(None, torch.float32).numpy()  # f32 p: the unrounded step
    out = step(3)
    assert out.dtype == torch.bfloat16
    o = out.float().numpy()
    bits = exact.view(np.uint32) & np.uint32(0xFFFF0000)
    down = bits.view(np.float32)  # truncated: the bf16 neighbour towards zero
    up = (bits + np.uint32(0x10000)).view(np.float32)  # the one away from zero
    assert np.all((o == down) | (o == up)), "not one of the two bf16 neighbours"
    ulp = np.abs(up - down)
    frac = np.abs(exact - down) / ulp
    err = np.abs(o - down) / ulp - frac  # in ulps, magnitude-wise
    sigma = np.sqrt(np.sum(frac * (1 - frac))) / err.size
    assert abs(err.mean()) < 5 * sigma, (err.mean(), sigma)
    assert torch.equal(step(3).view(torch.int16), out.view(torch.int16))
    assert (step(4).view(torch.int16) != out.view(torch.int16)).float().mean() > 0.1


def test_bf16_params_multi_pre_matches_jax_with_the_same_noise():
    """K2's bf16-table branch against JAX ``fused_adam_packed_multi_pre``
    with bf16 p/m/v (its XLA twin, which rounds with ``sr_round_bf16``; the
    Pallas kernel draws its bits from the TPU's per-tile generator, which
    interpret mode does not reproduce):
    handed JAX's noise bits, the port's plain version gives the same bf16
    tables.  Gradients exact in bf16, so only an f32 operation order can
    separate the two; at most 0.1% of the elements may differ by one ulp."""
    rng = np.random.default_rng(15)
    sizes, n_used, lr_scales = (4096, 2048), (3000, 1500), (1.0, 0.5)
    shapes, levels, prow, g128, pre = _multi_pre_inputs(rng, sizes, n_used, 1024, True)
    cat = [_bf16(np.concatenate([lv[k] for lv in levels])) for k in range(3)]
    seed = 21
    want = jak.fused_adam_packed_multi_pre(
        *(c.reshape(-1, 128) for c in cat), g128, prow, pre, jnp.float32(LR),
        jnp.float32(BC1), jnp.float32(BC2), shapes, lr_scales, use_pallas=False,
        n_used=n_used, grads_bf16=True, sr_seed=jnp.int32(seed))
    noise = _jax_noise(seed, (sum(sizes) * D // 128, 128)).reshape(-1)
    noise_l = torch.split(torch.from_numpy(noise), [C * D for C in sizes])
    tabs = [list(torch.split(torch.from_numpy(_f32(c)).bfloat16(), list(sizes)))
            for c in cat]
    tabs = [[t.contiguous() for t in lv] for lv in tabs]
    tak.fused_adam_multi_plain(*tabs, _t(*[lv[3] for lv in levels]),
                               _t(*[lv[4] for lv in levels]), LR, BC1, BC2, lr_scales,
                               n_used, grads_bf16=True, sr_seed=seed, noise16=noise_l)
    for name, a, b in zip("pmv", tabs, want):
        assert a[0].dtype == torch.bfloat16
        _assert_bf16_equal_but_ties(torch.cat(a), np.asarray(b, np.float32).reshape(-1, D),
                                    err_msg=name)
    with pytest.raises(ValueError, match="sr_seed"):  # as JAX, :394-395
        tak.fused_adam_multi_plain(*tabs, _t(*[lv[3] for lv in levels]),
                                   _t(*[lv[4] for lv in levels]), LR, BC1, BC2,
                                   lr_scales, n_used, grads_bf16=True)


@pytest.mark.parametrize("variant", ["f32", "bf16m", "bf16p"])
def test_precomputed_prep_gives_the_live_step(variant):
    """A step with ``pre=entry_prep(...)`` is bit-identical to the live
    prep, in every variant and through both entry points."""
    rng = np.random.default_rng(16)
    sizes, n_used = (2048, 1024), (1500, 1024)
    levels = [_level(rng, C, nu, 512) for C, nu in zip(sizes, n_used)]
    pd = torch.bfloat16 if variant == "bf16p" else torch.float32
    md = torch.float32 if variant == "f32" else torch.bfloat16
    rows, grads = _t(*[lv[3] for lv in levels]), _t(*[lv[4] for lv in levels])

    def tables():
        return [[torch.from_numpy(lv[k].copy()).to(dt) for lv in levels]
                for k, dt in ((0, pd), (1, md), (2, md))]

    kw = dict(grads_bf16=variant != "f32", sr_seed=5 if variant == "bf16p" else None)
    live, given = tables(), tables()
    tak.fused_adam_multi(*live, rows, grads, LR, BC1, BC2, (1.0, 0.5), n_used, **kw)
    pre = tak.entry_prep(rows, sizes, n_used, D)
    tak.fused_adam_multi(*given, rows, grads, LR, BC1, BC2, (1.0, 0.5), n_used,
                         pre=pre, **kw)
    for a, b in zip(live, given):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    if variant != "bf16p":  # K1 with a per-level prep
        live, given = tables(), tables()
        tak.fused_adam(live[0][0], live[1][0], live[2][0], rows[0], grads[0], LR, BC1,
                       BC2, n_used[0], grads_bf16=kw["grads_bf16"])
        tak.fused_adam(given[0][0], given[1][0], given[2][0], rows[0], grads[0], LR,
                       BC1, BC2, n_used[0], grads_bf16=kw["grads_bf16"],
                       pre=tak.entry_prep(rows[:1], sizes[:1], n_used[:1], D))
        for a, b in zip(live, given):
            assert torch.equal(a[0], b[0])
    with pytest.raises(ValueError, match="pre was built"):  # a prep of other heads
        tak.fused_adam_multi(*tables(), rows, grads, LR, BC1, BC2, (1.0, 0.5),
                             (1400, 1024), pre=pre, **kw)


def test_bf16_gates():
    """bf16 tables need bf16 moments and an sr_seed, and ride K2 only (the
    JAX package's fused_adam_packed refuses them); levels share one
    variant."""
    p = torch.zeros(64, D)
    rows = torch.zeros(4, dtype=torch.int32)
    g = torch.zeros(4, D)
    b = p.bfloat16()
    with pytest.raises(TypeError, match="bfloat16/bfloat16"):  # bf16 p, f32 moments
        tak.fused_adam_multi([b], [p.clone()], [p.clone()], [rows], [g], LR, BC1, BC2,
                             [1.0], sr_seed=1)
    with pytest.raises(TypeError, match="fused_adam_multi"):
        tak.fused_adam(b, b.clone(), b.clone(), rows, g, LR, BC1, BC2)
    with pytest.raises(ValueError, match="sr_seed"):
        tak.fused_adam_multi([b], [b.clone()], [b.clone()], [rows], [g], LR, BC1, BC2,
                             [1.0])
    with pytest.raises(TypeError, match="share the table dtypes"):
        tak.fused_adam_multi([p, p.clone()], [p.clone(), b.clone()],
                             [p.clone(), b.clone()], [rows] * 2, [g] * 2, LR, BC1, BC2,
                             [1.0, 1.0])


# ------------------------------------------------------------------ entry prep and SR noise


def _prep_numpy(rows_list, sizes, n_used, tb):
    """An independent numpy transcription of the prep for one batch: global
    rows (sentinel for trashbin and out-of-head entries), a stable argsort,
    each tile's first position, the dropped count."""
    sentinel = 2 ** 31 - 1
    keys, dropped, bounds, off = [], 0, [], 0
    for rows, C, nu in zip(rows_list, sizes, n_used):
        r = np.asarray(rows, np.int64).reshape(-1)
        trash = r == C - 1
        inside = (r >= 0) & (r < nu) & ~trash
        dropped += int((~inside & ~trash).sum())
        keys.append(np.where(inside, r + off, sentinel))
        bounds += [off + k for k in range(0, nu, tb)]
        off += C
    keys = np.concatenate(keys)
    order = np.argsort(keys, kind="stable")
    srt = keys[order]
    tile_off = [int(np.searchsorted(srt, b)) for b in bounds] + [int((srt < sentinel).sum())]
    return srt, order, np.array(tile_off), dropped


def test_entry_prep_plain_matches_numpy():
    """The prep's plain version (the wrapper's prep on CPU tensors, and the
    card prep's plain version): sentinel rows, stable order, tile offsets
    and dropped count as an independent numpy transcription, on entries
    with trashbin rows, rows past a used head, negative rows, int32 and
    int64 rows and a level with an empty used head; batch by batch of a
    stack."""
    rng = np.random.default_rng(17)
    sizes, n_used, W = (4096, 2048, 1024), (3001, 0, 1024), 3
    tb = tak.tile_rows(D)
    assert tb == 256 and tak.tile_rows(4) == 512 and tak.tile_rows(16) == 128
    assert tak.tile_rows(3) == 680 and tak.tile_rows(2048) == 8
    stack = []
    for l, (C, nu) in enumerate(zip(sizes, n_used)):
        r = rng.integers(0, max(nu, 1), (W, 700))
        r[:, :5] = r[:, 5:10]  # duplicates
        r[rng.random(r.shape) < 0.2] = C - 1  # trashbin
        r[:, 10:13] = [nu + 7, -1, C - 2]  # past the head, negative, last real row
        stack.append(torch.from_numpy(r.astype(np.int64 if l == 1 else np.int32)))
    pre = tak.entry_prep_stack(stack, sizes, n_used, D)
    assert pre.tb == tb and tuple(pre.rows.shape) == (W, 2100)
    for w in range(W):
        want = _prep_numpy([s[w].numpy() for s in stack], sizes, n_used, tb)
        one = tak.window_prep(pre, w)
        np.testing.assert_array_equal(one.rows.numpy(), want[0])
        np.testing.assert_array_equal(one.order.numpy(), want[1])
        np.testing.assert_array_equal(one.tile_off.numpy(), want[2])
        assert int(one.dropped) == want[3] > 0
        assert one.rows.dtype == one.order.dtype == one.tile_off.dtype == torch.int32
    single = tak.entry_prep([s[1] for s in stack], sizes, n_used, D)
    np.testing.assert_array_equal(single.order.numpy(), tak.window_prep(pre, 1).order.numpy())


def _work_list_numpy(rows_list, sizes, n_used, tb, chunk):
    """An independent numpy transcription of the update's work list for one
    batch, from the entries themselves: each tile's kept entries counted
    (trashbin and out-of-head entries excluded), a tile of n > chunk
    entries split into ceil(n / chunk) items, the k - 1 extra ones listed
    tile by tile as (tile, j)."""
    counts = []
    for rows, C, nu in zip(rows_list, sizes, n_used):
        r = np.asarray(rows, np.int64).reshape(-1)
        keep = (r >= 0) & (r < nu) & (r != C - 1)
        counts += list(np.bincount(r[keep] // tb, minlength=-(-nu // tb)))
    first, items = [], []
    for t, n in enumerate(counts):
        first.append(len(items))
        k = -(-int(n) // chunk) if n > chunk else 1
        items += [(t, j) for j in range(1, k)]
    return np.array(first), np.array(items, np.int64).reshape(-1, 2), len(items)


@pytest.mark.parametrize("chunk", [16, 512])
def test_work_list_plain_matches_numpy(chunk):
    """The update's work list (``work_list_plain``, the plain twin of
    csrc/entry_prep.cu's scan) as an independent numpy count of each tile's
    entries: hot tiles (a row taking 1,500 entries, another level's 900
    entries on one tile), an empty level, heads that are not a multiple of
    the tile, trashbin, negative and out-of-head entries, int32 and int64
    rows; batch by batch of a stack, zero past each batch's count."""
    rng = np.random.default_rng(19)
    sizes, n_used, W = (4096, 2048, 1024, 4096), (3001, 0, 1000, 300), 3
    tb = tak.tile_rows(D)
    stack = []
    for l, (C, nu) in enumerate(zip(sizes, n_used)):
        r = rng.integers(0, max(nu, 1), (W, 2000))
        if l == 0:
            r[:, :1500] = 1234  # a hot row
        if l == 3:
            r[:, 100:1000] = rng.integers(0, 256, (W, 900))  # a hot tile
        r[rng.random(r.shape) < 0.2] = C - 1  # trashbin
        r[:, 1500:1504] = [nu + 7, -1, C - 2, C - 1]
        stack.append(torch.from_numpy(r.astype(np.int64 if l == 2 else np.int32)))
    pre = tak.entry_prep_stack_plain(stack, sizes, n_used, tb, chunk)
    E_max = 4 * 2000 // chunk + 1
    assert pre.chunk == chunk and tuple(pre.split_items.shape) == (W, E_max, 2)
    assert pre.split_off.dtype == pre.split_items.dtype == pre.n_split.dtype == torch.int32
    for w in range(W):
        first, items, n = _work_list_numpy([s[w].numpy() for s in stack], sizes, n_used, tb,
                                           chunk)
        one = tak.window_prep(pre, w)
        np.testing.assert_array_equal(one.split_off.numpy(), first)
        assert int(one.n_split) == n > 0
        np.testing.assert_array_equal(one.split_items[:n].numpy(), items)
        assert not one.split_items[n:].any()
    # the default prep carries the kernel's chunk
    assert tak.entry_prep([s[0] for s in stack], sizes, n_used, D).chunk == tak.ENTRY_CHUNK


@pytest.mark.parametrize("deterministic", [False, True])
def test_levels_step_equals_per_level_plain_calls(deterministic):
    """K1's per-level step in one call (``fused_adam_levels``) on the CPU is
    the L per-level ``fused_adam_plain`` calls bit for bit, and so is the
    arithmetic of the card's one launch: the plain multi-level step on ONE
    prep of all levels (``fused_adam_multi_plain`` with each level's lr
    scale), hot rows, trashbin entries and heads past a tile included."""
    rng = np.random.default_rng(23)
    sizes, n_used, scales = (2048, 1024, 512, 512), (1500, 1024, 300, 257), (1.0, .5, .25, .125)
    levels = [_level(rng, C, nu, 3000) for C, nu in zip(sizes, n_used)]
    for lv in levels[2:]:
        lv[3][:2000] = 17  # a hot row
    rows = [torch.from_numpy(lv[3]) for lv in levels]
    grads = [torch.from_numpy(lv[4]) for lv in levels]
    want = [[torch.from_numpy(lv[k].copy()) for lv in levels] for k in range(3)]
    for l in range(4):
        tak.fused_adam_plain(*(t[l] for t in want), rows[l], grads[l], LR * scales[l], BC1,
                             BC2, n_used[l])
    one_call = [[torch.from_numpy(lv[k].copy()) for lv in levels] for k in range(3)]
    dropped = tak.fused_adam_levels(*one_call, rows, grads, LR, BC1, BC2, scales, n_used,
                                    deterministic=deterministic)
    assert int(dropped) == 0
    one_prep = [[torch.from_numpy(lv[k].copy()) for lv in levels] for k in range(3)]
    pre = tak.entry_prep(rows, sizes, n_used, D)
    assert int(pre.n_split) > 0
    tak.fused_adam_multi_plain(*one_prep, rows, grads, LR, BC1, BC2, scales, n_used, pre=pre)
    for got in (one_call, one_prep):
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), y.numpy())
    with pytest.raises(TypeError, match="float32 parameters"):
        tak.fused_adam_levels(*[[t.bfloat16() for t in tabs] for tabs in want], rows, grads,
                              LR, BC1, BC2, scales, n_used)


def _philox_numpy(seed, level, n):
    """Philox4x32-10 (Salmon et al., SC'11) in numpy uint64: counter
    (k lo, k hi, level, 0), key (seed, 0x53524E44), 16 bits per element."""
    mask = np.uint64(0xFFFFFFFF)
    k = np.arange((n + 7) // 8, dtype=np.uint64)
    c = [k & mask, k >> np.uint64(32), np.full_like(k, level), np.zeros_like(k)]
    key = [np.uint64(seed & 0xFFFFFFFF), np.uint64(0x53524E44)]
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]  # exact: < 2**64
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ key[0], p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ key[1], p0 & mask]
        key = [(key[0] + np.uint64(0x9E3779B9)) & mask, (key[1] + np.uint64(0xBB67AE85)) & mask]
    words = np.stack(c, axis=1)
    halves = np.stack([words & np.uint64(0xFFFF), words >> np.uint64(16)], axis=2)
    return halves.reshape(-1)[:n].astype(np.int64)


def test_philox_noise16_matches_numpy_transcription():
    """The kernel's rounding noise in torch equals an independent numpy
    transcription of Philox4x32-10, across a 2**32 group boundary of the
    seed's key words, for several levels and a length that ends mid-group;
    the bits are 16-bit and look uniform."""
    for seed, level, n in ((0, 0, 8), (7, 0, 1003), (123456789, 2, 4099), (2 ** 32 + 5, 1, 64)):
        got = tak.philox_noise16(seed, level, n).numpy()
        np.testing.assert_array_equal(got, _philox_numpy(seed, level, n))
    x = tak.philox_noise16(3, 1, 1 << 16).numpy()
    assert x.min() >= 0 and x.max() < 1 << 16
    assert abs(x.mean() / 65535 - 0.5) < 0.01
    # the transcription's rounds give Random123's known answer (kat_vectors,
    # philox4x32_10, zero counter and key)
    assert _philox_kat() == (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)


def _philox_kat():
    """Philox4x32-10 of a zero counter under a zero key, in Python ints."""
    mask = 0xFFFFFFFF
    c, k = [0, 0, 0, 0], [0, 0]
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & mask, (p0 >> 32) ^ c[3] ^ k[1], p0 & mask]
        k = [(k[0] + 0x9E3779B9) & mask, (k[1] + 0xBB67AE85) & mask]
    return tuple(c)


def test_bf16_params_plain_rounds_with_the_kernel_noise():
    """With bf16 p and no ``noise16`` the plain step takes
    ``philox_noise16(sr_seed, level, ...)``: handed those bits through the
    ``noise16`` seam it gives the same tables bit for bit, and the bits
    depend on the seed."""
    rng = np.random.default_rng(18)
    sizes, n_used = (2048, 1024), (1500, 1024)
    levels = [_level(rng, C, nu, 512) for C, nu in zip(sizes, n_used)]
    rows, grads = _t(*[lv[3] for lv in levels]), _t(*[lv[4] for lv in levels])

    def step(seed, noise=None):
        tabs = [[torch.from_numpy(lv[k].copy()).bfloat16() for lv in levels] for k in range(3)]
        tak.fused_adam_multi_plain(*tabs, rows, grads, LR, BC1, BC2, (1.0, 0.5), n_used,
                                   grads_bf16=True, sr_seed=seed, noise16=noise)
        return tabs

    noise = [tak.philox_noise16(9, l, C * D) for l, C in enumerate(sizes)]
    for a, b in zip(step(9), step(9, noise)):
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    assert not torch.equal(step(9)[0][0].view(torch.int16), step(10)[0][0].view(torch.int16))


def test_plain_step_rounds_each_operation_once():
    """On rows with at most one entry the plain f32 step equals a numpy
    float32 transcription that rounds every product, quotient, root and sum
    once (what the kernel computes with __fmul_rn and friends), so the card
    can hold the kernel bit for bit against it there."""
    rng = np.random.default_rng(19)
    C, nu = 4096, 3000
    p, m, v, _, _ = _level(rng, C, nu, 8)
    rows = rng.permutation(nu)[:1500].astype(np.int32)  # unique rows
    g = (rng.normal(size=(1500, D)) * 1e-3).astype(np.float32)
    tabs = _t(p, m, v)
    tak.fused_adam_plain(*tabs, torch.from_numpy(rows), torch.from_numpy(g), LR, BC1, BC2, nu)
    f = np.float32
    gl = np.zeros((nu, D), np.float32)
    gl[rows] = g
    m_new = f(0.9) * m[:nu] + f(1 - 0.9) * gl
    v_new = f(0.99) * v[:nu] + (f(1 - 0.99) * gl) * gl
    p_new = p[:nu] - (f(LR) * (m_new / f(BC1))) / (np.sqrt(v_new / f(BC2)) + f(1e-15))
    for a, b in zip(tabs, (p_new, m_new, v_new)):
        np.testing.assert_array_equal(a.numpy()[:nu], b)


def _probe_module():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "probe_k2_shards.py")
    spec = importlib.util.spec_from_file_location("probe_k2_shards", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("design", sorted(_probe_module().DESIGNS))
def test_k2_shard_probe_alters_the_kernel_source(design):
    """scripts/probe_k2_shards.py builds each design from
    csrc/fused_adam.cu (this commit's kernel, which also stands in for the
    parent commit's here) or scripts/probes/fused_adam_ring.cu by replacing
    functions and lines it names: every anchor is still in its source (so
    the probe runs on this commit), each alteration changes the text, and
    the shape lines it alters (the ring's stages, grid, CTAs an SM and
    shared memory; the kernel's launch bounds) are the ones the sources
    launch with."""
    import os

    probe = _probe_module()
    src = os.path.join(os.path.dirname(tak.__file__), os.pardir, "csrc", "fused_adam.cu")
    with open(src) as f:
        kernel = f.read()
    with open(probe.RING_SOURCE) as f:
        ring = f.read()
    out = probe.design_source(design, {"kernel": kernel, "parent": kernel, "ring": ring})
    base = {"kernel": kernel, "parent": kernel, "ring": ring}[probe.DESIGNS[design][0]]
    assert out is not None
    # the launch-bounds designs may ask what the source already asks
    assert (out == base) == (probe.DESIGNS[design][1] is None) or design.startswith(
        ("kernel_p", "kernel_m"))
    for line in (probe.STAGES_LINE, probe.GRID_LINE, probe.CTAS_LINE, probe.SMEM_LINE):
        assert ring.count(line) == 1
    assert len(probe.MIN_CTAS.findall(kernel)) == 1 and kernel.count(probe.IDLE_LINE) == 1
    if design.endswith("_arith"):
        assert "0x7FC00001u" in out
