"""The port's sweep (K6) and tile read-modify-write (K7) against the JAX
scripts' kernels, and the kernel-study programs on the CPU.

``experiments/exp_narrow_blocks.py`` and ``experiments/pallas_tile_rmw.py``
do their work when imported, so their kernels (``sweep_kernel``,
``rmw_kernel`` and its wrapper ``rmw``) are taken out of the source with
``ast`` and run in interpret mode at small shapes, with the module constants
they read (``PIPE``, ``N``) bound.  Both ports are held bit for bit (one
multiply-add per element; one add per element on unique rows).  The
programs of ``shine_mapping_tpu_torch.experiments`` run end to end on the CPU
(``--device cpu --small``), where every wrapper runs its plain version.
"""

import ast
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from shine_mapping_tpu_torch.ops import sweep as sw
from shine_mapping_tpu_torch.ops import tile_rmw as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _take(script, names, **consts):
    """The top-level functions ``names`` of experiments/<script>.py, defined
    in a namespace holding jax, jnp, pl, pltpu, functools and ``consts``."""
    path = os.path.join(REPO, "experiments", f"{script}.py")
    tree = ast.parse(open(path).read(), path)
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(d.name for d in defs) == sorted(names)
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools, **consts)
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return [ns[n] for n in names]


@pytest.fixture
def interpret_pallas():
    orig = pl.pallas_call

    def interpreted(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pl.pallas_call = interpreted
    yield
    pl.pallas_call = orig


def test_k6_sweep_matches_sweep_kernel():
    """K6 bit for bit against ``sweep_kernel`` in (TB, 8) blocks, as the
    script's ``run`` calls it, on values that include negatives, zeros,
    subnormals and large magnitudes."""
    (sweep_kernel,) = _take("exp_narrow_blocks", ["sweep_kernel"])
    C, D, TB = 16384, 8, 1024
    rng = np.random.default_rng(41)
    p = (rng.standard_normal((C, D)) * 10.0 ** rng.integers(-40, 30, (C, D))).astype(np.float32)
    p[0, :4] = [0.0, -0.0, 1e-45, -3e38]
    f = pl.pallas_call(
        sweep_kernel,
        grid=(C // TB,),
        in_specs=[pl.BlockSpec((TB, D), lambda t: (t, 0))],
        out_specs=pl.BlockSpec((TB, D), lambda t: (t, 0)),
        out_shape=jax.ShapeDtypeStruct((C, D), jnp.float32),
        interpret=True,
    )
    want = np.asarray(f(jnp.asarray(p)))
    got = sw.sweep(torch.from_numpy(p))
    assert got.dtype == torch.float32 and got.shape == (C, D)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_k7_tile_rmw_matches_rmw_kernel(interpret_pallas):
    """K7 in place, bit for bit against the script's ``rmw`` (its 16-deep
    DMA pipeline run in interpret mode) and ``table[tiles] += deltas``."""
    T, N, PIPE = 1024, 64, 16
    rmw_kernel, rmw = _take("pallas_tile_rmw", ["rmw_kernel", "rmw"], PIPE=PIPE, N=N)
    rng = np.random.default_rng(42)
    table = rng.standard_normal((T, 128)).astype(np.float32)
    tiles = np.sort(rng.choice(T, N, replace=False)).astype(np.int32)
    deltas = rng.standard_normal((N, 128)).astype(np.float32)
    want = np.asarray(rmw(jnp.asarray(table), jnp.asarray(tiles), jnp.asarray(deltas)))
    ref = table.copy()
    ref[tiles] += deltas
    np.testing.assert_array_equal(want, ref)  # the JAX kernel ran and did the job
    got = torch.from_numpy(table.copy())
    out = tr.tile_rmw(got, torch.from_numpy(tiles), torch.from_numpy(deltas))
    assert out is got  # in place, as the TPU kernel's aliased output
    np.testing.assert_array_equal(got.numpy(), want)


def test_study_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="float32"):
        sw.sweep(torch.zeros(64, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        sw.sweep(torch.zeros(8, 64).t())
    table = torch.zeros(16, 128)
    tiles = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tr.tile_rmw(table, tiles.long(), torch.zeros(2, 128))
    with pytest.raises(ValueError, match="deltas"):
        tr.tile_rmw(table, tiles, torch.zeros(3, 128))
    with pytest.raises(ValueError, match="table"):
        tr.tile_rmw(torch.zeros(16, 64), tiles, torch.zeros(2, 128))


def test_k7_skips_rows_outside_the_table():
    """K7's one contract on every device: a job on a row outside [0, T) is
    skipped, as the kernel skips it (csrc/tile_rmw.cu); the other jobs land
    exactly as index_add_ puts them."""
    rng = np.random.default_rng(5)
    T = 16
    table = torch.from_numpy(rng.standard_normal((T, 128)).astype(np.float32))
    tiles = torch.tensor([-1, 0, 7, T - 1, T, 1 << 20], dtype=torch.int32)
    deltas = torch.from_numpy(rng.standard_normal((6, 128)).astype(np.float32))
    want = table.clone().index_add_(0, tiles[1:4].long(), deltas[1:4])
    got = tr.tile_rmw(table.clone(), tiles, deltas)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name, lines", [
    ("exp_fused_adam", ["correctness OK", "onehot fused tb=512 w=512:"]),
    ("exp_pallas_debug", ["correctness dot_bf16:", "onehot   :", "dot_hi   :"]),
    ("exp_pallas_trainer", ["gather_nodep  :", "pcopy_f32     :", "pcopy_bf16    :"]),
    ("exp_narrow_blocks", ["narrow-block sweep:"]),
    ("pallas_tile_rmw", ["correctness max err: 0.0", "tile-RMW 512 tiles (512B):"]),
])
def test_study_program_runs_on_the_cpu(capsys, name, lines):
    """Each program runs its path end to end on the CPU at the cut shapes and
    prints its script's lines; nothing ran when it was imported."""
    mod = importlib.import_module(f"shine_mapping_tpu_torch.experiments.{name}")
    assert capsys.readouterr() == ("", "")
    argv = ["--device", "cpu", "--small", "--iters", "1", "--reps", "1"]
    if name == "exp_pallas_debug":
        argv += ["--variants", "copy,sweep,window,onehot,dot_bf16,dot_hi"]
    assert mod.main(argv) == 0
    out = capsys.readouterr()
    text = out.out + out.err
    for line in lines:
        assert line in text, (line, text)
