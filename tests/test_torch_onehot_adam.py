"""The port's one-hot study kernels (K3, K4, K5) against the JAX scripts'.

``shine_mapping_tpu_torch.ops.onehot_adam``'s wrappers run their plain torch
version on CPU tensors; here they are held against the TPU kernels of
``experiments/exp_fused_adam.py`` (K3), ``exp_pallas_debug.py`` (K4, all six
variants) and ``exp_pallas_trainer.py`` (K5, rebuilt from ``main2``), run in
interpret mode, with the scripts loaded from their paths (nothing under
``experiments/`` is imported as a package or changed).  Gradients are small
integers times 2**-10, so every partial sum in bf16 or f32 is exact and the
sum order cannot matter (see tests/test_torch_adam_kernel.py); p, m and v
are held within atol 5e-6.  The CUDA kernel itself runs only on the card:
tests/test_torch_cuda.py.
"""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_mapping_tpu.ops import adam_kernel as jak
from shine_mapping_tpu_torch.ops import onehot_adam as oa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, PACK = 8, 16
LR, BC1, BC2 = 0.01, 0.3439, 0.0394  # bias corrections of step 4


def _script(name):
    path = os.path.join(REPO, "experiments", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_study_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def _tables(rng, C):
    p = rng.normal(size=(C, D)).astype(np.float32)
    m = (rng.normal(size=(C, D)) * 0.01).astype(np.float32)
    v = (np.abs(rng.normal(size=(C, D))) * 1e-4).astype(np.float32)
    return p, m, v


def _entries(rng, C, M, hot=0):
    """Sorted corner rows with duplicates and a trashbin tail (zero
    gradients), gradients exact in any sum; ``hot`` entries crowd the
    corner rows of packed tile 3 (tb 64) so its window overflows."""
    rows = rng.integers(0, C - 1, M)
    if hot:
        rows[:hot] = rng.integers(3 * 64 * PACK, 4 * 64 * PACK, hot)
    rows = np.sort(rows).astype(np.int32)
    rows[-32:] = C - 1
    g = (rng.integers(-32, 33, (M, D)) * 2.0 ** -10).astype(np.float32)
    g[-32:] = 0.0
    return rows, g


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _close(got, want, names="pmv"):
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy().reshape(-1), np.asarray(b).reshape(-1),
                                   atol=5e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("hot", [0, 1500], ids=["windows_hold", "window_overflow"])
def test_k3_matches_pallas_fused_adam(interpret_pallas, hot):
    """K3 against ``pallas_fused_adam`` (interpret mode) and, where the
    windows hold every entry, against ``xla_scatter_adam``; where tile 3's
    window overflows, both drop the same entries."""
    efa = _script("exp_fused_adam")
    rng = np.random.default_rng(31)
    C, M, tb, w = 16384, 2048, 64, 256
    p, m, v = _tables(rng, C)
    rows, g = _entries(rng, C, M, hot)
    args = [jnp.asarray(a) for a in (p, m, v, rows, g)]
    scal = (jnp.float32(LR), jnp.float32(BC1), jnp.float32(BC2))
    want = efa.pallas_fused_adam(*args, *scal, tb=tb, w=w)
    exact = efa.xla_scatter_adam(*args, *scal)
    got = oa.fused_adam_onehot(*_t(p, m, v, rows, g), LR, BC1, BC2, tb=tb, w=w)
    _close(got, want)
    prow = torch.from_numpy(rows // PACK).int()
    prow_p, _, _, offs = oa.window_inputs(*_t(rows, g), C, tb, w)
    ok = bool(oa.windows_ok(prow, offs, tb, w))
    assert ok == (hot == 0)
    if ok:
        _close(got, exact)
    else:  # the dropped entries really change the step
        assert np.abs(got[1].numpy() - np.asarray(exact[1])).max() > 1e-4


def _debug_inputs(rng, C, M, tb, w, rows, grads):
    """exp_pallas_debug.main's input arithmetic (:151-164), in numpy/jax."""
    prow = (rows // PACK).astype(np.int32)
    R = C // PACK
    T = R // tb
    Mpad = ((M + w - 1) // w) * w + w
    prow_p = np.full((1, Mpad), -1, np.int32)
    prow_p[0, :M] = prow
    g128 = np.zeros((Mpad, 128), np.float32)
    lane = np.arange(128)
    mask = (lane[None, :] // D) == (rows % PACK)[:, None]
    g128[:M] = np.where(mask, np.tile(grads, (1, PACK)), 0.0)
    g_hi = jnp.asarray(g128).astype(jnp.bfloat16)
    g_lo = (jnp.asarray(g128) - g_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    wstart = np.searchsorted(prow, np.arange(T) * tb)
    offs = np.minimum(wstart // w, Mpad // w - 2).astype(np.int32)
    return prow_p, g_hi, g_lo, offs


def _bf16_np(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


def test_window_inputs_match_the_scripts_arithmetic():
    """``window_inputs`` (lane rows, hi/lo split, padded rows, offsets)
    equals exp_pallas_debug's prep bit for bit, on gradients whose lo part
    is not zero; ``windows_ok`` equals exp_pallas_trainer's predicate."""
    rng = np.random.default_rng(32)
    C, M, tb, w = 16384, 2048, 64, 256
    rows = np.sort(rng.integers(0, C - 1, M)).astype(np.int32)
    grads = rng.normal(size=(M, D)).astype(np.float32)
    want = _debug_inputs(rng, C, M, tb, w, rows, grads)
    got = oa.window_inputs(*_t(rows, grads), C, tb, w)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for a, b in zip(got[1:3], want[1:3]):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), _bf16_np(b).view(torch.int16))
    assert got[2].float().abs().max() > 0
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    prow = rows // PACK
    Mpad = got[0].shape[1]
    for tb_k in (tb, 4, 1024):
        T = C // PACK // tb_k
        offs = np.minimum(np.searchsorted(prow, np.arange(T) * tb_k) // w, Mpad // w - 2)
        ws = np.searchsorted(prow, np.arange(T + 1) * tb_k)
        want_ok = bool(np.all(ws[1:] <= offs * w + 2 * w))
        assert bool(oa.windows_ok(torch.from_numpy(prow).int(),
                                  torch.from_numpy(offs.astype(np.int32)), tb_k, w)) == want_ok
    # a crowded row overflows its tile's window
    crowded = np.sort(np.concatenate([rows, np.full(600, 100)])).astype(np.int32) // PACK
    T = C // PACK // tb
    offs = oa.window_offsets(torch.from_numpy(crowded), T, tb, w, oa.padded_len(M + 600, w))
    assert not bool(oa.windows_ok(torch.from_numpy(crowded), offs, tb, w))


@pytest.mark.parametrize("variant", ["copy", "sweep", "window", "onehot", "dot_bf16",
                                     "dot_hi"])
def test_k4_variant_matches_fused(interpret_pallas, variant):
    epd = _script("exp_pallas_debug")
    rng = np.random.default_rng(33)
    C, M, tb, w = 16384, 2048, 64, 256
    p, m, v = _tables(rng, C)
    rows, g = _entries(rng, C, M)
    prow_p, g_hi, g_lo, offs = _debug_inputs(rng, C, M, tb, w, rows, g)
    scal = np.array([LR, BC1, BC2, 0.0], np.float32)
    want = epd.fused(jnp.asarray(p), jnp.asarray(m), jnp.asarray(v), jnp.asarray(prow_p),
                     g_hi, g_lo, jnp.asarray(offs), jnp.asarray(scal), tb, w, variant)
    pt, mt, vt = _t(p, m, v)
    got = oa.fused_adam_onehot_variant(pt, mt, vt, *_t(prow_p), _bf16_np(g_hi),
                                       _bf16_np(g_lo), *_t(offs, scal), tb, w, variant)
    _close(got, want)
    for a, b in zip(got, (pt, mt, vt)):  # new outputs, inputs untouched
        assert a.data_ptr() != b.data_ptr() and a.shape == (C, D)
    np.testing.assert_array_equal(pt.numpy(), p)
    if variant == "copy":
        for a, b in zip(got, (p, m, v)):
            np.testing.assert_array_equal(a.numpy(), b)
    if variant == "dot_bf16":  # the full step moved every table
        assert (got[1].numpy() != m).mean() > 0.99


def _kernel4():
    """``_kernel4`` rebuilt from ``main2``'s code object; its one free
    variable is the ``pl`` module main2 imports."""
    from jax.experimental import pallas as pl

    ept = _script("exp_pallas_trainer")
    code = next(c for c in ept.main2.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "_kernel4")
    assert code.co_freevars == ("pl",)
    return types.FunctionType(code, ept.__dict__, "_kernel4", None, (types.CellType(pl),))


def _pallas4(kernel4, p128, m128, v128, prow_p, g_hi, g_lo, offs, scal, copy_dtype, tb, w):
    """exp_pallas_trainer.py:335-367 with the tile sizes as arguments, in
    interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    R = p128.shape[0]
    T = R // tb
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2,
        grid=(T,),
        in_specs=[
            pl.BlockSpec((tb, 128), lambda t, offs, scal: (t, 0)),
            pl.BlockSpec((tb, 128), lambda t, offs, scal: (t, 0)),
            pl.BlockSpec((tb, 128), lambda t, offs, scal: (t, 0)),
            pl.BlockSpec((1, w), lambda t, offs, scal: (0, offs[t])),
            pl.BlockSpec((1, w), lambda t, offs, scal: (0, offs[t] + 1)),
            pl.BlockSpec((w, 128), lambda t, offs, scal: (offs[t], 0)),
            pl.BlockSpec((w, 128), lambda t, offs, scal: (offs[t], 0)),
            pl.BlockSpec((w, 128), lambda t, offs, scal: (offs[t] + 1, 0)),
            pl.BlockSpec((w, 128), lambda t, offs, scal: (offs[t] + 1, 0)),
        ],
        out_specs=[
            pl.BlockSpec((tb, 128), lambda t, offs, scal: (t, 0)),
            pl.BlockSpec((tb, 128), lambda t, offs, scal: (t, 0)),
            pl.BlockSpec((tb, 128), lambda t, offs, scal: (t, 0)),
            pl.BlockSpec((tb, 128), lambda t, offs, scal: (t, 0)),
        ],
    )
    return pl.pallas_call(
        functools.partial(kernel4, tb=tb, w=w, b1=0.9, b2=0.99, eps=1e-15,
                          copy_dtype=copy_dtype),
        grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((R, 128), jnp.float32)] * 3
        + [jax.ShapeDtypeStruct((R, 128), copy_dtype)],
        input_output_aliases={2: 0, 3: 1, 4: 2},
        compiler_params=pltpu.CompilerParams(dimension_semantics=("arbitrary",)),
        interpret=True,
    )(offs, scal, p128, m128, v128, prow_p, prow_p, g_hi, g_lo, g_hi, g_lo)


@pytest.mark.parametrize("copy", ["f32", "bf16"])
def test_k5_matches_kernel4(copy):
    """K5 in place against ``_kernel4``: p, m, v within atol 5e-6; the f32
    copy equals p; the bf16 copy is bit-equal to the port's own p rounded to
    nearest even and within one bf16 ulp of JAX's copy."""
    rng = np.random.default_rng(34)
    C, M = 16384, 2048
    tb, w = oa.choose_tiles(C, D, M)
    assert (tb, w) == jak.choose_tiles(C, D, M)
    p, m, v = _tables(rng, C)
    rows, g = _entries(rng, C, M)
    prow_p, g_hi, g_lo, offs = _debug_inputs(rng, C, M, tb, w, rows, g)
    scal = np.array([LR, BC1, BC2, 0.0], np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[copy]
    want = _pallas4(_kernel4(), *(jnp.asarray(a.reshape(-1, 128)) for a in (p, m, v)),
                    jnp.asarray(prow_p), g_hi, g_lo, jnp.asarray(offs), jnp.asarray(scal),
                    jdt, tb, w)
    tabs = [t.view(-1, 128) for t in _t(p, m, v)]
    out = oa.fused_adam_onehot_copy(*tabs, *_t(prow_p), _bf16_np(g_hi), _bf16_np(g_lo),
                                    *_t(offs, scal), tb, w, tdt)
    for a, b in zip(out[:3], tabs):  # in place
        assert a is b
    _close(out[:3], want[:3])
    pc, p_new = out[3], out[0]
    assert pc.dtype == tdt and pc.shape == p_new.shape
    if copy == "f32":
        assert torch.equal(pc, p_new)
    else:
        assert torch.equal(pc.view(torch.int16), p_new.to(torch.bfloat16).view(torch.int16))
        jpc = np.asarray(want[3].astype(jnp.float32))
        np.testing.assert_array_less(np.abs(pc.float().numpy() - jpc),
                                     2.0 ** -7 * np.abs(jpc) + 1e-30)


def test_choose_tiles_matches_jax():
    for C, M, n_used in ((1 << 22, 65536, None), (1 << 22, 65536, 3_000_000),
                         (16384, 2048, None), (1 << 20, 1 << 18, None),
                         (1 << 16, 100_000, 40_000), (4096, 2048, 1)):
        assert oa.choose_tiles(C, D, M, n_used) == jak.choose_tiles(C, D, M, n_used), (C, M)


def test_lane_rows_match_the_scripts_arithmetic():
    rng = np.random.default_rng(35)
    rows = rng.integers(0, 4096, 300).astype(np.int32)
    g = rng.normal(size=(300, D)).astype(np.float32)
    lane = np.arange(128)
    mask = (lane[None, :] // D) == (rows % PACK)[:, None]
    want = np.where(mask, np.tile(g, (1, PACK)), 0.0)
    got = oa.lane_rows(*_t(g, rows), n=512)
    np.testing.assert_array_equal(got.numpy()[:300], want)
    assert not got[300:].any()


def test_wrappers_reject_what_the_kernel_does_not_take():
    C, M, w = 4096, 256, 256
    rows = torch.arange(M, dtype=torch.int32) * 8
    g = torch.zeros(M, D)
    p = torch.zeros(C, D)
    with pytest.raises(ValueError, match="whole tiles"):  # R = 256 rows, tb 96
        oa.fused_adam_onehot(p, p.clone(), p.clone(), rows, g, LR, BC1, BC2, tb=96, w=w)
    with pytest.raises(ValueError, match="float32"):
        oa.fused_adam_onehot(p.double(), p.clone(), p.clone(), rows, g, LR, BC1, BC2)
    prow_p, g_hi, g_lo, offs = oa.window_inputs(rows, g, C, 64, w)
    scal = torch.tensor([LR, BC1, BC2, 0.0])
    with pytest.raises(ValueError, match="variant"):
        oa.fused_adam_onehot_variant(p, p, p, prow_p, g_hi, g_lo, offs, scal, 64, w, "dot")
    with pytest.raises(ValueError, match="offs"):  # offs of another tiling
        oa.fused_adam_onehot_variant(p, p, p, prow_p, g_hi, g_lo, offs, scal, 32, w, "sweep")
    with pytest.raises(ValueError, match="g_hi"):
        oa.fused_adam_onehot_variant(p, p, p, prow_p, g_hi.float(), g_lo, offs, scal, 64, w,
                                     "sweep")
    with pytest.raises(ValueError, match="copy_dtype"):
        oa.fused_adam_onehot_copy(p.view(-1, 128), p.view(-1, 128).clone(),
                                  p.view(-1, 128).clone(), prow_p, g_hi, g_lo, offs, scal,
                                  64, w, torch.float16)
