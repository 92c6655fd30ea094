"""The port's CUDA kernel on the card, against its plain torch version.

Marked ``cuda``; every test skips without an NVIDIA card (the kernel has no
CPU mode).  This file imports torch and the port only, so it also runs on a
machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance rtol 1e-5, atol 1e-6: shared-memory atomics sum duplicate rows in
another order than ``index_add_``, and nvcc contracts multiply-adds.
"""

import numpy as np
import pytest
import torch

from shine_mapping_tpu_torch.ops import adam_kernel as ak

D = 8
LR, BC1, BC2 = 0.01, 0.3439, 0.0394  # bias corrections of step 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _tables_and_entries(rng, sizes, n_used, M, device):
    """Per-level numpy tables [p, m, v] (zero moments past each used head)
    and per-level entries with duplicate rows and trashbin rows (zero
    gradients)."""
    tabs = [[], [], []]
    rows_l, g_l = [], []
    for C, nu in zip(sizes, n_used):
        m = rng.normal(0, 0.01, (C, D)).astype(np.float32)
        v = np.abs(rng.normal(0, 1e-4, (C, D))).astype(np.float32)
        m[nu:] = 0.0
        v[nu:] = 0.0
        for k, t in enumerate((rng.normal(0, 0.1, (C, D)).astype(np.float32), m, v)):
            tabs[k].append(t)
        rows = rng.integers(0, nu, M).astype(np.int32)
        rows[M // 2: M // 2 + M // 8] = rows[: M // 8]
        trash = rng.random(M) < 0.2
        rows[trash] = C - 1
        g = rng.normal(0, 1e-3, (M, D)).astype(np.float32)
        g[trash] = 0.0
        rows_l.append(torch.from_numpy(rows).to(device))
        g_l.append(torch.from_numpy(g).to(device))
    return tabs, rows_l, g_l


def _on(tabs, device):
    return [[torch.from_numpy(a.copy()).to(device) for a in lv] for lv in tabs]


def _assert_close_and_moved(kern, plain, ref, n_used):
    """Kernel == plain per level, and every table's used head moved (v by
    ~1% in a step, far beyond the tolerance), so a kernel that skips a
    store cannot pass; headroom rows bit-identical."""
    for k, p, r in zip(kern, plain, ref):
        for a, b, a0, nu in zip(k, p, r, n_used):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            moved = (b.cpu().numpy()[:nu] != a0[:nu]).mean()
            assert moved > 0.99, f"only {moved:.3f} of the used head moved"
            np.testing.assert_array_equal(a.cpu().numpy()[nu:], a0[nu:])


@pytest.mark.cuda
@pytest.mark.parametrize("lr_scales", [(1.0, 1.0, 1.0), (1.0, 0.5, 0.25)])
def test_multi_level_kernel_matches_plain(cuda_device, lr_scales):
    rng = np.random.default_rng(5)
    sizes, n_used = (8192, 4096, 2048), (6000, 4096, 1111)
    tabs, rows_l, g_l = _tables_and_entries(rng, sizes, n_used, 4096, cuda_device)
    plain, kern = _on(tabs, cuda_device), _on(tabs, cuda_device)
    ak.fused_adam_multi_plain(*plain, rows_l, g_l, LR, BC1, BC2, lr_scales, n_used)
    before = ak.LAUNCHES["fused_adam_multi"]
    dropped = ak.fused_adam_multi(*kern, rows_l, g_l, LR, BC1, BC2, lr_scales, n_used)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["fused_adam_multi"] == before + 1
    assert int(dropped) == 0
    _assert_close_and_moved(kern, plain, tabs, n_used)


@pytest.mark.cuda
@pytest.mark.parametrize("n_used", [None, 5000])
def test_single_level_kernel_matches_plain(cuda_device, n_used):
    rng = np.random.default_rng(6)
    C = 8192
    tabs, rows_l, g_l = _tables_and_entries(rng, [C], [n_used or C], 8192, cuda_device)
    plain, kern = _on(tabs, cuda_device), _on(tabs, cuda_device)
    ak.fused_adam_plain(*(t[0] for t in plain), rows_l[0], g_l[0], LR, BC1, BC2, n_used)
    before = ak.LAUNCHES["fused_adam"]
    ak.fused_adam(*(t[0] for t in kern), rows_l[0], g_l[0], LR, BC1, BC2, n_used)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["fused_adam"] == before + 1
    _assert_close_and_moved(kern, plain, tabs, [n_used or C])


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_what_it_does_not_take(cuda_device):
    p = torch.zeros(64, D, device=cuda_device)
    rows = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    g = torch.zeros(4, D, device=cuda_device)
    with pytest.raises(TypeError):
        ak.fused_adam(p.half(), p.half(), p.half(), rows, g, LR, BC1, BC2)
    with pytest.raises(ValueError):  # entries on another device
        ak.fused_adam(p, p.clone(), p.clone(), rows.cpu(), g.cpu(), LR, BC1, BC2)
    with pytest.raises(ValueError):  # non-contiguous table
        ak.fused_adam(p.t().contiguous().t(), p.clone(), p.clone(), rows, g, LR, BC1, BC2)


# ------------------------------------------------------------------ bf16 modes


def _bf16_toward(x, direction):
    """float32 ``x`` rounded to bfloat16 towards -inf (``direction`` -1) or
    +inf (1)."""
    x = x.astype(np.float32)
    t = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)  # towards zero
    away = (t.view(np.uint32) + np.uint32(0x10000)).view(np.float32)
    return np.where((t == x) | ((x > 0) == (direction < 0)), t, away)


def _sr_range(e):
    """The range of bf16 values stochastic rounding may give for an f32
    value within 16 f32 ulps of ``e`` plus 8 of the largest |e| (the sum
    order of the step, and p - lr m / sqrt(v) where it nearly cancels)."""
    slack = 2.0 ** -19 * np.abs(e) + 2.0 ** -20 * np.abs(e).max()
    return _bf16_toward(e - slack, -1), _bf16_toward(e + slack, 1)


def _bf16_bits_equal_but_ties(a, b, share=0.999):
    """bf16 tables equal bit for bit except a share of one-ulp ties (a sum
    in another order moves the f32 value across a rounding midpoint)."""
    a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
    assert (a == b).mean() >= share, f"only {(a == b).mean():.5f} bit-equal"
    np.testing.assert_array_less(np.abs(a - b), 2.0 ** -7 * np.abs(b) + 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["fused_adam", "fused_adam_multi"])
def test_bf16_moment_kernel_matches_plain(cuda_device, entry):
    """f32 p, bf16 m/v, entries rounded to bf16: p within rtol 1e-5, atol
    1e-6 of the plain version, m and v bit-equal but for ties; heads moved,
    headroom untouched; one launch counted under the variant."""
    rng = np.random.default_rng(7)
    sizes, n_used = ((8192, 4096, 2048), (6000, 4096, 1111))
    if entry == "fused_adam":
        sizes, n_used = sizes[:1], n_used[:1]
    tabs, rows_l, g_l = _tables_and_entries(rng, sizes, n_used, 4096, cuda_device)

    def on():
        out = _on(tabs, cuda_device)
        return [out[0], [t.bfloat16() for t in out[1]], [t.bfloat16() for t in out[2]]]

    plain, kern = on(), on()
    scales = (1.0, 0.5, 0.25)[:len(sizes)]
    key = entry + "_bf16m"
    before = ak.LAUNCHES[key]
    if entry == "fused_adam":
        ak.fused_adam_plain(*(t[0] for t in plain), rows_l[0], g_l[0], LR, BC1, BC2,
                            n_used[0], grads_bf16=True)
        ak.fused_adam(*(t[0] for t in kern), rows_l[0], g_l[0], LR, BC1, BC2, n_used[0],
                      grads_bf16=True)
    else:
        ak.fused_adam_multi_plain(*plain, rows_l, g_l, LR, BC1, BC2, scales, n_used,
                                  grads_bf16=True)
        ak.fused_adam_multi(*kern, rows_l, g_l, LR, BC1, BC2, scales, n_used,
                            grads_bf16=True)
    torch.cuda.synchronize()
    assert ak.LAUNCHES[key] == before + 1
    for a, b, a0, nu in zip(kern[0], plain[0], tabs[0], n_used):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert (b.cpu().numpy()[:nu] != a0[:nu]).mean() > 0.99
        np.testing.assert_array_equal(a.cpu().numpy()[nu:], a0[nu:])
    for k in (1, 2):
        for a, b, nu in zip(kern[k], plain[k], n_used):
            assert a.dtype == torch.bfloat16
            _bf16_bits_equal_but_ties(a, b)
            assert not a[nu:].any()


@pytest.mark.cuda
def test_bf16_table_kernel_rounds_stochastically(cuda_device):
    """bf16 p/m/v: every new p is one of the two bf16 neighbours of the
    plain f32 step (16 f32 ulps of slack for the sum order), the rounding
    is unbiased (5 sigma), a seed reruns bit for bit and another seed
    differs; headroom untouched."""
    rng = np.random.default_rng(8)
    sizes, n_used = (8192, 4096), (6000, 4096)
    tabs, rows_l, g_l = _tables_and_entries(rng, sizes, n_used, 4096, cuda_device)
    base = [[t.bfloat16() for t in lv] for lv in _on(tabs, cuda_device)]

    def run(seed):
        t = [[x.clone() for x in lv] for lv in base]
        ak.fused_adam_multi(*t, rows_l, g_l, LR, BC1, BC2, (1.0, 0.5), n_used,
                            grads_bf16=True, sr_seed=seed)
        return t

    # the unrounded step: f32 p through the plain bf16-moment version
    ref = [[x.float() for x in base[0]], [x.clone() for x in base[1]],
           [x.clone() for x in base[2]]]
    ak.fused_adam_multi_plain(*ref, rows_l, g_l, LR, BC1, BC2, (1.0, 0.5), n_used,
                              grads_bf16=True)
    out = run(11)
    torch.cuda.synchronize()
    errs, fracs = [], []
    for a, exact, a0, nu in zip(out[0], ref[0], base[0], n_used):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a[nu:].view(torch.int16), a0[nu:].view(torch.int16))
        e = exact[:nu].cpu().numpy()
        bits = e.view(np.uint32) & np.uint32(0xFFFF0000)
        down = bits.view(np.float32)
        up = (bits + np.uint32(0x10000)).view(np.float32)
        o = a[:nu].float().cpu().numpy()
        lo, hi = _sr_range(e)
        ok = (o >= lo) & (o <= hi)
        assert ok.all(), f"{(~ok).sum()} elements off both neighbours"
        assert ((o == down) | (o == up)).mean() > 1 - 1e-4
        ulp = np.abs(up - down)
        frac = np.abs(e - down) / ulp
        errs.append((np.abs(o - down) / ulp - frac).ravel())
        fracs.append(frac.ravel())
    err, frac = np.concatenate(errs), np.concatenate(fracs)
    sigma = np.sqrt(np.sum(frac * (1 - frac))) / err.size
    assert abs(err.mean()) < 5 * sigma, (err.mean(), sigma)
    again, other = run(11), run(12)
    for a, b, c in zip(out[0], again[0], other[0]):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        assert (a.view(torch.int16) != c.view(torch.int16)).float().mean() > 0.1
    for k in (1, 2):
        for a, b in zip(out[k], ref[k]):
            _bf16_bits_equal_but_ties(a, b)


@pytest.mark.cuda
def test_kernel_pre_matches_live_prep_and_bf16_gates(cuda_device):
    rng = np.random.default_rng(9)
    sizes, n_used = (8192, 4096), (6000, 4096)
    tabs, rows_l, g_l = _tables_and_entries(rng, sizes, n_used, 4096, cuda_device)
    live, given = _on(tabs, cuda_device), _on(tabs, cuda_device)
    ak.fused_adam_multi(*live, rows_l, g_l, LR, BC1, BC2, (1.0, 0.5), n_used)
    pre = ak.entry_prep(rows_l, sizes, n_used)
    ak.fused_adam_multi(*given, rows_l, g_l, LR, BC1, BC2, (1.0, 0.5), n_used, pre=pre)
    torch.cuda.synchronize()
    for a, b in zip(live, given):  # shared-memory atomics: sum order varies
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    b16 = [[t.bfloat16() for t in lv] for lv in given]
    with pytest.raises(ValueError, match="sr_seed"):
        ak.fused_adam_multi(*b16, rows_l, g_l, LR, BC1, BC2, (1.0, 0.5), n_used)
    with pytest.raises(ValueError, match="noise16"):
        ak.fused_adam_multi(*b16, rows_l, g_l, LR, BC1, BC2, (1.0, 0.5), n_used,
                            sr_seed=1, noise16=[torch.zeros(1)] * 2)


# ------------------------------------------------------------------ kernel-study kernels
#
# K3-K5 (csrc/onehot_adam.cu), K6 (Triton, csrc/sweep_triton.py) and K7
# (csrc/tile_rmw.cu) against their plain versions, run by the same wrappers
# on CPU copies of the inputs.  Gradients are small integers times 2**-10,
# so every sum is exact in any order: p, m, v within rtol 1e-6, atol 1e-7
# (the kernel rounds each operation as torch does), K6 and K7 bit for bit.


def _study_inputs(rng, C, M, hot=0):
    """(C, 8) tables and sorted entries with duplicates; ``hot`` entries
    crowd tile 3's rows (tb 64) so its window overflows."""
    p = rng.normal(0, 1, (C, D)).astype(np.float32)
    m = rng.normal(0, 0.01, (C, D)).astype(np.float32)
    v = np.abs(rng.normal(0, 1e-4, (C, D))).astype(np.float32)
    rows = rng.integers(0, C - 1, M)
    if hot:
        rows[:hot] = rng.integers(3 * 1024, 4 * 1024, hot)
    rows = np.sort(rows).astype(np.int32)
    g = (rng.integers(-32, 33, (M, D)) * 2.0 ** -10).astype(np.float32)
    return [torch.from_numpy(a) for a in (p, m, v, rows, g)]


def _both(ts, device):
    return [t.clone() for t in ts], [t.to(device) for t in ts]


def _close_study(kern, plain):
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [0, 3000])
def test_onehot_k3_kernel_matches_plain(cuda_device, hot):
    from shine_mapping_tpu_torch.ops import onehot_adam as oa

    rng = np.random.default_rng(21)
    cpu, dev = _both(_study_inputs(rng, 65536, 8192, hot), cuda_device)
    plain = oa.fused_adam_onehot(*cpu, LR, BC1, BC2, tb=64, w=256)
    before = oa.LAUNCHES["fused_adam_onehot"]
    kern = oa.fused_adam_onehot(*dev, LR, BC1, BC2, tb=64, w=256)
    torch.cuda.synchronize()
    assert oa.LAUNCHES["fused_adam_onehot"] == before + 1
    _close_study(kern, plain)
    assert (plain[1] != cpu[1]).float().mean() > 0.99  # every row's m decayed


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["copy", "sweep", "window", "onehot", "dot_bf16",
                                     "dot_hi"])
def test_onehot_k4_variant_kernel_matches_plain(cuda_device, variant):
    from shine_mapping_tpu_torch.ops import onehot_adam as oa

    rng = np.random.default_rng(22)
    C, M, tb, w = 65536, 8192, 64, 256
    p, m, v, rows, g = _study_inputs(rng, C, M)
    inputs = [p, m, v, *oa.window_inputs(rows, g, C, tb, w),
              torch.tensor([LR, BC1, BC2, 0.0])]
    cpu, dev = _both(inputs, cuda_device)
    plain = oa.fused_adam_onehot_variant(*cpu, tb, w, variant)
    key = f"fused_adam_onehot_{variant}"
    before = oa.LAUNCHES[key]
    kern = oa.fused_adam_onehot_variant(*dev, tb, w, variant)
    torch.cuda.synchronize()
    assert oa.LAUNCHES[key] == before + 1
    _close_study(kern, plain)
    for a, b in zip(kern, dev[:3]):
        assert a.data_ptr() != b.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("copy_dtype", [torch.float32, torch.bfloat16])
def test_onehot_k5_kernel_matches_plain(cuda_device, copy_dtype):
    from shine_mapping_tpu_torch.ops import onehot_adam as oa

    rng = np.random.default_rng(23)
    C, M = 65536, 8192
    tb, w = oa.choose_tiles(C, D, M)
    p, m, v, rows, g = _study_inputs(rng, C, M)
    inputs = [t.view(-1, 128) for t in (p, m, v)] + [
        *oa.window_inputs(rows, g, C, tb, w), torch.tensor([LR, BC1, BC2, 0.0])]
    cpu, dev = _both(inputs, cuda_device)
    plain = oa.fused_adam_onehot_copy(*cpu, tb, w, copy_dtype)
    name = "f32" if copy_dtype == torch.float32 else "bf16"
    before = oa.LAUNCHES[f"fused_adam_onehot_copy_{name}"]
    kern = oa.fused_adam_onehot_copy(*dev, tb, w, copy_dtype)
    torch.cuda.synchronize()
    assert oa.LAUNCHES[f"fused_adam_onehot_copy_{name}"] == before + 1
    for a, b in zip(kern[:3], dev[:3]):  # in place
        assert a is b
    _close_study(kern[:3], plain[:3])
    pc = kern[3]
    assert pc.dtype == copy_dtype
    assert torch.equal(pc, kern[0].to(copy_dtype))  # the new p, rounded to nearest even


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["k3", "window", "dot_bf16"])
def test_onehot_kernel_launches_at_the_largest_window(cuda_device, entry):
    """The largest window block the wrappers accept fits the kernel's shared
    memory (its 2 w staged ids beside its static reduction slots); one more
    entry is refused by the wrapper and by the kernel's host check."""
    from shine_mapping_tpu_torch.ops import onehot_adam as oa

    rng = np.random.default_rng(26)
    C, M, tb, w = 16384, 2048, 64, oa._MAX_W
    p, m, v, rows, g = _study_inputs(rng, C, M)
    if entry == "k3":
        cpu, dev = _both([p, m, v, rows, g], cuda_device)
        plain = oa.fused_adam_onehot(*cpu, LR, BC1, BC2, tb=tb, w=w)
        kern = oa.fused_adam_onehot(*dev, LR, BC1, BC2, tb=tb, w=w)
        with pytest.raises(ValueError, match="outside"):
            oa.fused_adam_onehot(*dev, LR, BC1, BC2, tb=tb, w=w + 1)
    else:
        inputs = [p, m, v, *oa.window_inputs(rows, g, C, tb, w),
                  torch.tensor([LR, BC1, BC2, 0.0])]
        cpu, dev = _both(inputs, cuda_device)
        plain = oa.fused_adam_onehot_variant(*cpu, tb, w, entry)
        kern = oa.fused_adam_onehot_variant(*dev, tb, w, entry)
        with pytest.raises(ValueError, match="exceed"):
            oa.fused_adam_onehot_variant(*dev, tb, w + 1, entry)
    torch.cuda.synchronize()
    _close_study(kern, plain)
    outs = [torch.empty_like(t) for t in dev[:3]]
    args = (*dev[:3], *outs, None, None, None, None, None, None, LR, BC1, BC2, 0, tb)
    oa._launch(oa._MODE["sweep"], 0, *args, w, 0, oa.B1, oa.B2, oa.EPS)  # no tiles: accepted
    with pytest.raises(RuntimeError, match="CUDA error"):
        oa._launch(oa._MODE["sweep"], 0, *args, w + 1, 0, oa.B1, oa.B2, oa.EPS)


@pytest.mark.cuda
def test_sweep_triton_kernel_matches_plain(cuda_device):
    from shine_mapping_tpu_torch.ops import sweep as sw

    rng = np.random.default_rng(24)
    p = torch.from_numpy(rng.normal(0, 100, (65536 + 37, D)).astype(np.float32))
    before = sw.LAUNCHES["sweep"]
    out = sw.sweep(p.to(cuda_device))
    torch.cuda.synchronize()
    assert sw.LAUNCHES["sweep"] == before + 1
    assert torch.equal(out.cpu(), sw.sweep_plain(p))


@pytest.mark.cuda
def test_tile_rmw_kernel_matches_plain(cuda_device):
    from shine_mapping_tpu_torch.ops import tile_rmw as tr

    rng = np.random.default_rng(25)
    T, N = 8192, 1000
    table = torch.from_numpy(rng.standard_normal((T, 128)).astype(np.float32))
    tiles = torch.from_numpy(np.sort(rng.choice(T, N, replace=False)).astype(np.int32))
    deltas = torch.from_numpy(rng.standard_normal((N, 128)).astype(np.float32))
    plain = tr.tile_rmw_plain(table.clone(), tiles, deltas)
    kern = table.to(cuda_device)
    before = tr.LAUNCHES["tile_rmw"]
    assert tr.tile_rmw(kern, tiles.to(cuda_device), deltas.to(cuda_device)) is kern
    torch.cuda.synchronize()
    assert tr.LAUNCHES["tile_rmw"] == before + 1
    assert torch.equal(kern.cpu(), plain)
