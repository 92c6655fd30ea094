"""The port's CUDA kernel on the card, against its plain torch version.

Marked ``cuda``; every test skips without an NVIDIA card (the kernel has no
CPU mode).  This file imports torch and the port only, so it also runs on a
machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance rtol 1e-5, atol 1e-6: shared-memory atomics sum duplicate rows in
another order than ``index_add_``.  The update kernel rounds every
operation as torch does, so on rows with at most one entry it is held bit
for bit against the plain version run on CPU copies.
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
def test_single_level_kernel_at_four_levels_matches_plain(cuda_device):
    """K1 as the RGB-D configs run it (config/rgbd: 4 feature levels), one
    launch a level a step: four tables of their own sizes and used heads,
    each step held against the plain version, bit-equal on rows with at
    most one entry."""
    rng = np.random.default_rng(11)
    sizes, n_used = (32768, 16384, 8192, 4096), (30000, 12000, 8192, 1500)
    tabs, rows_l, g_l = _tables_and_entries(rng, sizes, n_used, 8192, cuda_device)
    plain, kern = _on(tabs, cuda_device), _on(tabs, cuda_device)
    before = ak.LAUNCHES["fused_adam"]
    for lv in range(4):
        ak.fused_adam_plain(*(t[lv] for t in plain), rows_l[lv], g_l[lv], LR, BC1, BC2,
                            n_used[lv])
        ak.fused_adam(*(t[lv] for t in kern), rows_l[lv], g_l[lv], LR, BC1, BC2, n_used[lv])
    torch.cuda.synchronize()
    assert ak.LAUNCHES["fused_adam"] == before + 4
    _assert_close_and_moved(kern, plain, tabs, n_used)
    for lv, (C, nu) in enumerate(zip(sizes, n_used)):
        r = rows_l[lv].long()
        keep = (r >= 0) & (r < nu) & (r != C - 1)
        single = torch.bincount(r[keep], minlength=C) <= 1
        for k in range(3):
            assert torch.equal(kern[k][lv][single], plain[k][lv][single])


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


# ------------------------------------------------------------------ prep, widths, edges


def _edge_inputs(rng, D, sizes, n_used, M, hot=3000):
    """Tables and entries for the edge cases: level 0 has a hot row with
    ``hot`` duplicate entries, every level ~20% trashbin entries (zero
    gradients); a level with an empty used head gets trashbin entries
    only."""
    tabs = [[], [], []]
    rows_l, g_l = [], []
    for l, (C, nu) in enumerate(zip(sizes, n_used)):
        for k, t in enumerate((rng.normal(0, 0.1, (C, D)), rng.normal(0, 0.01, (C, D)),
                               np.abs(rng.normal(0, 1e-4, (C, D))))):
            t = t.astype(np.float32)
            if k:
                t[nu:] = 0.0
            tabs[k].append(t)
        rows = rng.integers(0, max(nu, 1), M).astype(np.int32)
        if l == 0 and hot:
            rows[:hot] = nu // 2
        trash = (rng.random(M) < 0.2) | (nu == 0)
        rows[trash] = C - 1
        g = rng.normal(0, 1e-3, (M, D)).astype(np.float32)
        g[trash] = 0.0
        rows_l.append(rows)
        g_l.append(g)
    return tabs, rows_l, g_l


def _entries_per_row(rows, C, nu):
    r = rows[(rows >= 0) & (rows < nu) & (rows != C - 1)]
    return np.bincount(r, minlength=C)


@pytest.mark.cuda
def test_kernel_prep_matches_plain(cuda_device):
    """csrc/entry_prep.cu against its plain version (the stable sort) on a
    stack of 3 batches: the same tile offsets and dropped count, and in
    each tile, and among the excluded entries, the same (row, entry)
    pairs (the kernel leaves the order inside a tile to its atomics)."""
    rng = np.random.default_rng(30)
    sizes, n_used, W = (8192, 4096, 2048), (6001, 0, 2048), 3
    stack = []
    for C, nu in zip(sizes, n_used):
        r = rng.integers(0, max(nu, 1), (W, 3000))
        r[:, :2000] = r[:, :1]  # a hot row
        r[(rng.random(r.shape) < 0.2) | (nu == 0)] = C - 1  # trashbin
        r[:, 2000:2005] = nu + 5  # past the head: dropped
        stack.append(torch.from_numpy(r.astype(np.int32)))
    plain = ak.entry_prep_stack(stack, sizes, n_used, D)
    before = ak.LAUNCHES["entry_prep"]
    kern = ak.entry_prep_stack([s.to(cuda_device) for s in stack], sizes, n_used, D)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["entry_prep"] == before + 1
    assert torch.equal(kern.tile_off.cpu(), plain.tile_off)
    assert torch.equal(kern.dropped.cpu(), plain.dropped) and int(plain.dropped[0]) == 15
    # the update's work list: the hot row's tile is split into chunks
    assert kern.chunk == plain.chunk == ak.ENTRY_CHUNK
    assert torch.equal(kern.n_split.cpu(), plain.n_split) and int(plain.n_split[0]) > 0
    assert torch.equal(kern.split_off.cpu(), plain.split_off)
    for w in range(W):
        n = int(plain.n_split[w])
        assert torch.equal(kern.split_items[w, :n].cpu(), plain.split_items[w, :n])
    for w in range(W):
        bounds = plain.tile_off[w].tolist() + [plain.rows.shape[1]]
        for a, b in zip(bounds[:-1], bounds[1:]):
            got = sorted(zip(kern.rows[w, a:b].tolist(), kern.order[w, a:b].tolist()))
            want = sorted(zip(plain.rows[w, a:b].tolist(), plain.order[w, a:b].tolist()))
            assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("D_", [3, 4, 8, 16])
def test_f32_kernel_bit_equal_on_single_entry_rows(cuda_device, D_):
    """f32 p/m/v at widths D 3, 4, 8, 16: used heads ending mid-tile (and,
    for D 3 and 4, mid-group of 8 elements), a hot row with 3,000
    duplicate entries, a level with an empty used head.  Against the plain
    version run on CPU copies: bit-equal on every row with at most one
    entry (the kernel rounds each operation as torch does), within rtol
    1e-5, atol 1e-6 on the rest (atomics sum duplicates in another order);
    headroom untouched."""
    rng = np.random.default_rng(31)
    sizes, n_used = (8192, 2048, 4096), (5001, 0, 3333)
    tabs, rows_np, g_np = _edge_inputs(rng, D_, sizes, n_used, 6000)
    cpu = [[torch.from_numpy(a.copy()) for a in lv] for lv in tabs]
    ak.fused_adam_multi_plain(*cpu, [torch.from_numpy(r) for r in rows_np],
                              [torch.from_numpy(g) for g in g_np], LR, BC1, BC2,
                              (1.0, 0.5, 0.25), n_used)
    kern = _on(tabs, cuda_device)
    ak.fused_adam_multi(*kern, [torch.from_numpy(r).to(cuda_device) for r in rows_np],
                        [torch.from_numpy(g).to(cuda_device) for g in g_np], LR, BC1, BC2,
                        (1.0, 0.5, 0.25), n_used)
    torch.cuda.synchronize()
    for l, (C, nu) in enumerate(zip(sizes, n_used)):
        single = _entries_per_row(rows_np[l], C, nu) <= 1
        assert nu == 0 or single[:nu].mean() > 0.3
        for k in range(3):
            a, b = kern[k][l].cpu(), cpu[k][l]
            assert torch.equal(a[torch.from_numpy(single)], b[torch.from_numpy(single)]), \
                f"level {l} table {'pmv'[k]}: rows with at most one entry differ"
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(a.numpy()[nu:], tabs[k][l][nu:])


@pytest.mark.cuda
def test_bf16p_kernel_bit_equal_to_plain_with_philox_noise(cuda_device):
    """bf16 p/m/v with stochastic rounding: the plain version on CPU copies
    rounds with ``philox_noise16`` (the kernel's keying by seed, level and
    element, unchanged from the parent kernel), so p, m and v are bit-equal
    to the kernel's on every row with at most one entry, and another seed
    gives other bits."""
    rng = np.random.default_rng(32)
    sizes, n_used = (8192, 4096), (6001, 4096)
    tabs, rows_np, g_np = _edge_inputs(rng, D, sizes, n_used, 4096)
    base = [[torch.from_numpy(a).bfloat16() for a in lv] for lv in tabs]
    rows_c = [torch.from_numpy(r) for r in rows_np]
    g_c = [torch.from_numpy(g) for g in g_np]
    cpu = [[t.clone() for t in lv] for lv in base]
    ak.fused_adam_multi_plain(*cpu, rows_c, g_c, LR, BC1, BC2, (1.0, 0.5), n_used,
                              grads_bf16=True, sr_seed=41)

    def run(seed):
        t = [[x.to(cuda_device) for x in lv] for lv in base]
        ak.fused_adam_multi(*t, [r.to(cuda_device) for r in rows_c],
                            [g.to(cuda_device) for g in g_c], LR, BC1, BC2, (1.0, 0.5),
                            n_used, grads_bf16=True, sr_seed=seed)
        return t

    kern, other = run(41), run(42)
    torch.cuda.synchronize()
    for l, (C, nu) in enumerate(zip(sizes, n_used)):
        single = torch.from_numpy(_entries_per_row(rows_np[l], C, nu) <= 1)
        for k in range(3):
            a, b = kern[k][l].cpu().view(torch.int16), cpu[k][l].view(torch.int16)
            assert torch.equal(a[single], b[single]), f"level {l} table {'pmv'[k]}"
        p, q = kern[0][l][:nu].view(torch.int16), other[0][l][:nu].view(torch.int16)
        assert float((p != q).float().mean()) > 0.1


@pytest.mark.cuda
def test_misaligned_views_raise(cuda_device):
    """A table or gradient view that does not start on a 16-byte boundary
    is refused before any launch (the kernel reads 16 bytes at a time)."""
    C = 1024
    flat = torch.zeros(C * D + 4, device=cuda_device)
    p = flat[4:].view(C, D)  # 16 bytes in: aligned
    bad = flat[1:C * D + 1].view(C, D)  # 4 bytes in
    rows = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    g = torch.zeros(8, D, device=cuda_device)
    ak.fused_adam(p, torch.zeros_like(p), torch.zeros_like(p), rows, g, LR, BC1, BC2)
    for tabs in ((bad, torch.zeros_like(p), torch.zeros_like(p)),
                 (p, bad, torch.zeros_like(p)), (p, torch.zeros_like(p), bad)):
        with pytest.raises(ValueError, match="16-byte"):
            ak.fused_adam(*tabs, rows, g, LR, BC1, BC2)
    gflat = torch.zeros(8 * D + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        ak.fused_adam(p, torch.zeros_like(p), torch.zeros_like(p), rows,
                      gflat[1:].view(8, D), LR, BC1, BC2)


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
    pre = ak.entry_prep(rows_l, sizes, n_used, D)
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


# ------------------------------------------------ the persistent grids of K7 and K3-K5
# Both kernels walk their work with a persistent grid computed in C (the
# SMs times the CTAs resident on one); each library reports its grid.  The
# cases put the work below, at and past one pass of it, and at its edges.


def _rmw_pass_jobs():
    import ctypes

    from shine_mapping_tpu_torch.ops import cuda_build

    fn = cuda_build.load("tile_rmw").tile_rmw_pass_jobs
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    jobs = int(fn())
    assert jobs > 0
    return jobs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "one", "ragged", "past_one_pass", "edge_rows",
                                  "out_of_range"])
def test_tile_rmw_grid_cases_bit_equal_to_index_add(cuda_device, case):
    """K7 on the card bit-equal to index_add_: no job, one job, a job count
    that is no multiple of the 8-job groups nor of a CTA's 64 jobs, more
    jobs than one pass of the persistent grid takes, the table's first and
    last rows, and rows outside the table, which are left untouched."""
    from shine_mapping_tpu_torch.ops import tile_rmw as tr

    rng = np.random.default_rng(27)
    T, N = 4096, 323
    if case == "empty":
        N = 0
    elif case == "one":
        N = 1
    elif case == "past_one_pass":
        N = _rmw_pass_jobs() + 37
        T = 2 * N
    tiles = np.sort(rng.choice(T, N, replace=False))
    if case == "edge_rows":
        tiles[0], tiles[-1] = 0, T - 1
    deltas = rng.standard_normal((N, 128)).astype(np.float32)
    table = torch.from_numpy(rng.standard_normal((T, 128)).astype(np.float32))
    plain = tr.tile_rmw_plain(table.clone(), torch.from_numpy(tiles.astype(np.int32)),
                              torch.from_numpy(deltas))
    if case == "out_of_range":  # jobs on rows -1 and T beside the others
        tiles = np.concatenate([[-1], tiles, [T]])
        deltas = np.concatenate([np.ones((1, 128), np.float32), deltas,
                                 np.ones((1, 128), np.float32)])
    kern = table.to(cuda_device)
    tr.tile_rmw(kern, torch.from_numpy(tiles.astype(np.int32)).to(cuda_device),
                torch.from_numpy(deltas).to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(kern.cpu(), plain)


def _onehot_ctas(mode, pc_kind, w):
    import ctypes

    from shine_mapping_tpu_torch.ops import cuda_build

    fn = cuda_build.load("onehot_adam").onehot_adam_ctas
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    ctas = int(fn(mode, pc_kind, w))
    assert ctas > 0
    return ctas


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["single", "below", "equal", "ragged"])
@pytest.mark.parametrize("entry", ["k3", "copy", "window", "dot_bf16", "k5"])
def test_onehot_grid_cases_match_plain(cuda_device, entry, tiles):
    """K3, K4 (copy, window, dot_bf16) and K5 at one tile, one tile fewer
    than the persistent grid has CTAs, as many, and two passes and a
    remainder of it (tiles of 8 packed rows, so the CTAs' warps have one row
    each); K4 and K5 (in place) bit-equal to their plain versions on the
    card, K3 (whose plain version divides by Python floats, which torch
    rounds as a product on the card) within 1e-6."""
    from shine_mapping_tpu_torch.ops import onehot_adam as oa

    mode, pc_kind = {"k3": (oa._MODE["narrow"], 0), "k5": (oa._MODE["dot_bf16"], 1)}.get(
        entry, (oa._MODE.get(entry), 0))
    tb, w = 8, 256
    ctas = _onehot_ctas(mode, pc_kind, w)
    T = {"single": 1, "below": ctas - 1, "equal": ctas, "ragged": 2 * ctas + 3}[tiles]
    C = T * tb * oa.PACK
    rng = np.random.default_rng(28)
    p, m, v, rows, g = _study_inputs(rng, C, 4 * T)
    if entry == "k3":
        plain = oa.fused_adam_onehot(p, m, v, rows, g, LR, BC1, BC2, tb=tb, w=w)
        kern = oa.fused_adam_onehot(*(t.to(cuda_device) for t in (p, m, v, rows, g)), LR, BC1,
                                    BC2, tb=tb, w=w)
        torch.cuda.synchronize()
        _close_study(kern, plain)
        return
    inputs = [p, m, v, *oa.window_inputs(rows, g, C, tb, w),
              torch.tensor([LR, BC1, BC2, 0.0])]
    dev = [t.to(cuda_device) for t in inputs]
    if entry == "k5":
        plain = oa.fused_adam_onehot_copy_plain(*(t.clone().view(-1, 128) for t in dev[:3]),
                                                *dev[3:], tb, w)
        kern = oa.fused_adam_onehot_copy(*(t.view(-1, 128) for t in dev[:3]), *dev[3:], tb, w)
        for a, b in zip(kern[:3], dev[:3]):
            assert a.data_ptr() == b.data_ptr()  # in place
    else:
        plain = oa.fused_adam_onehot_variant_plain(*dev, tb, w, entry)
        kern = oa.fused_adam_onehot_variant(*dev, tb, w, entry)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["k3", "dot_bf16", "k5"])
def test_onehot_grid_at_the_largest_window(cuda_device, entry):
    """At the largest window (w 6140: 49,120 B of staged ids a CTA, fewer
    CTAs resident), a tile count of two passes of that grid and a
    remainder; as test_onehot_grid_cases_match_plain."""
    from shine_mapping_tpu_torch.ops import onehot_adam as oa

    mode, pc_kind = {"k3": (oa._MODE["narrow"], 0), "k5": (oa._MODE["dot_bf16"], 1),
                     "dot_bf16": (oa._MODE["dot_bf16"], 0)}[entry]
    tb, w = 8, oa._MAX_W
    T = 2 * _onehot_ctas(mode, pc_kind, w) + 3
    C = T * tb * oa.PACK
    rng = np.random.default_rng(29)
    p, m, v, rows, g = _study_inputs(rng, C, 4 * T)
    if entry == "k3":
        plain = oa.fused_adam_onehot(p, m, v, rows, g, LR, BC1, BC2, tb=tb, w=w)
        kern = oa.fused_adam_onehot(*(t.to(cuda_device) for t in (p, m, v, rows, g)), LR, BC1,
                                    BC2, tb=tb, w=w)
        torch.cuda.synchronize()
        _close_study(kern, plain)
        return
    dev = [t.to(cuda_device) for t in [p, m, v, *oa.window_inputs(rows, g, C, tb, w),
                                       torch.tensor([LR, BC1, BC2, 0.0])]]
    if entry == "k5":
        plain = oa.fused_adam_onehot_copy_plain(*(t.clone().view(-1, 128) for t in dev[:3]),
                                                *dev[3:], tb, w)
        kern = oa.fused_adam_onehot_copy(*(t.view(-1, 128) for t in dev[:3]), *dev[3:], tb, w)
    else:
        plain = oa.fused_adam_onehot_variant_plain(*dev, tb, w, entry)
        kern = oa.fused_adam_onehot_variant(*dev, tb, w, entry)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_onehot_copy_ring_wraps_and_ends_mid_chunk(cuda_device):
    """K4's copy (TMA bulk copies through a ring of 32 KB chunks): tables of
    3,001 tiles of 8 packed rows (12 MB each, so every CTA of the grid
    reuses its ring many times and each table ends in a part chunk) come
    back equal to their inputs."""
    from shine_mapping_tpu_torch.ops import onehot_adam as oa

    tb, w, T = 8, 256, 3001
    C = T * tb * oa.PACK
    rng = np.random.default_rng(30)
    p, m, v, rows, g = _study_inputs(rng, C, 4 * T)
    dev = [t.to(cuda_device) for t in [p, m, v, *oa.window_inputs(rows, g, C, tb, w),
                                       torch.tensor([LR, BC1, BC2, 0.0])]]
    kern = oa.fused_adam_onehot_variant(*dev, tb, w, "copy")
    torch.cuda.synchronize()
    for a, b in zip(kern, (p, m, v)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_mesher_card_equals_cpu_bit_for_bit(cuda_device):
    """The mesher on the card and on CPU tensors: the same mask and, with
    its sums in a fixed order, the same sdf bits, on both the dense lattice
    grid and the octree blocks."""
    import copy

    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.mesher import Mesher
    from shine_mapping_tpu_torch.models.decoder import Decoder
    from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost

    rng = np.random.default_rng(31)
    dirs = rng.standard_normal((4000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    cfg = SHINEConfig()
    cfg.tree_level_world, cfg.tree_level_feat, cfg.leaf_vox_size = 7, 3, 0.5
    cfg.derive()
    cpu_grid = HashGridHost(7, 3, 8, 0.3, seed=2, init_node_capacity=1 << 12,
                            init_corner_capacity=1 << 12, device="cpu")
    cpu_grid.update((dirs * 0.5).astype(np.float32))
    dec = Decoder(8, generator=torch.Generator().manual_seed(3), device="cpu")
    bbx = (np.full(3, -0.6) / cfg.scale, np.full(3, 0.6) / cfg.scale)
    vs = 0.013 / cfg.scale
    m = Mesher(cfg, cpu_grid, dec)
    vn, vo = m.grid_shape_from_bbx(bbx, vs)
    sdf, _, mask = m.query_grid_lattice(vn, vo, vs)
    with torch.no_grad():  # centre the field on the map, so that it has a surface
        dec.lout.bias += float(np.median(sdf[mask]))
    meshers = [m, Mesher(cfg, HashGridHost.from_state_dict(cpu_grid.state_dict(),
                                                           device=cuda_device),
                         copy.deepcopy(dec).to(cuda_device))]
    (s0, _, m0), (s1, _, m1) = (m.query_grid_lattice(vn, vo, vs) for m in meshers)
    assert m0.any() and np.array_equal(m0, m1)
    assert np.array_equal(s0.view(np.int32), s1.view(np.int32))
    ql = cfg.mc_query_level
    v0, v1 = (m.recon_octree_mesh(ql, 2 ** (1 - ql) / cfg.scale / 5, "", "",
                                  filter_isolated_mesh=False) for m in meshers)
    assert v0.triangles.shape[0] > 0
    np.testing.assert_array_equal(v0.triangles, v1.triangles)
    np.testing.assert_array_equal(v0.vertices, v1.vertices)


@pytest.mark.cuda
@pytest.mark.parametrize("fused_windows", [False, True], ids=["iid-K1", "fused-windows-K2"])
def test_reg_steps_card_equals_cpu(cuda_device, fused_windows):
    """The continual-learning reg folded into the update's entries at
    lambda 1e6 (entries ~1e6 times the loss's): 5 steps on the card (K1 per
    level on iid batches, or K2 on fused windows with the owner flags)
    against the same steps on the CPU (plain versions), from the same map,
    shadow and batches; adam_eps 1e-3.  p and the reg loss rtol 1e-4 /
    1e-5; the moments at an atol of 1e-6 of their largest value."""
    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.optimizer import init_opt_state

    rng = np.random.default_rng(6)
    n = 6000
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    disp = rng.uniform(-0.04, 0.04, (n, 1))
    coord = (dirs * (0.5 + disp)).astype(np.float32)
    label = disp[:, 0].astype(np.float32)
    cfg = SHINEConfig()
    cfg.tree_level_world, cfg.tree_level_feat, cfg.bs, cfg.adam_eps = 7, 3, 512, 1e-3
    cfg.derive()
    idx = torch.from_numpy(rng.integers(0, n, (5, cfg.bs)))
    out = {}
    for side, device in (("cpu", "cpu"), ("card", cuda_device)):
        grid = HashGridHost(7, 3, D, 0.05, seed=3, init_node_capacity=1 << 12,
                            init_corner_capacity=1 << 12, device=device)
        grid.update(coord, incremental_on=True)
        s = trainer.TrainSettings.from_config(
            cfg, grid.levels, sigma_sigmoid=0.05, continual_reg_on=True, lambda_forget=1e6,
            loss_reduction="sum", feature_update="pallas", n_used=trainer.used_rows_for(grid))
        params = trainer.init_params(cfg, grid, torch.Generator(device).manual_seed(0))
        if side == "cpu":
            init = {k: {n: t.clone() for n, t in params[k].state_dict().items()}
                    for k in ("geo", "sem")}
        for k in ("geo", "sem"):
            params[k].load_state_dict(init[k])
        shapes = [tuple(f.shape) for f in grid.features]
        shadow = {"importance": [torch.from_numpy(np.abs(np.random.default_rng(l).normal(
                      0, 0.01, sh)).astype(np.float32)).to(device) for l, sh in enumerate(shapes)],
                  "last_frame": [f + 0.01 for f in grid.features_last_frame]}
        pool = {"coord": torch.from_numpy(coord).to(device),
                "sdf_label": torch.from_numpy(label).to(device),
                "weight": torch.ones(n, device=device)}
        kw = dict(batch_indices=idx)
        if fused_windows:
            pre = trainer.precompute_pool_lookups(grid.tables, pool["coord"], grid.levels,
                                                  [sh[0] for sh in shapes])
            kw = dict(pre_lookups=pre, batch_windows=trainer.precompute_batch_windows(
                pre, n, None, s, shapes, fused=True, window_indices=idx, reg_cover=True))
        ak.reset_launch_counts()
        params, opt, aux = trainer.train_chunk(params, init_opt_state(params), grid.tables,
                                               pool, n, 0, None, s, 5, shadow=shadow, **kw)
        out[side] = (params, opt, aux, dict(ak.LAUNCHES))
        if side == "card" and not fused_windows:
            assert ak.LEVEL_STEPS["fused_adam"] == 15
    (pc, oc, ac, lc), (pp, op, ap, _) = out["card"], out["cpu"]
    # iid: K1's per-level step, one launch a step over the 3 levels
    key = "fused_adam_multi" if fused_windows else "fused_adam"
    assert lc[key] == 5
    np.testing.assert_allclose(float(ac["mean"]["reg_loss"]), float(ap["mean"]["reg_loss"]),
                               rtol=1e-5)
    assert float(ap["last"]["reg_loss"]) > 0
    for a, b in zip(pc["features"], pp["features"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    for a, b in zip(oc.m["features"] + oc.v["features"], op.m["features"] + op.v["features"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                   atol=max(1e-5, 1e-6 * float(b.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(10))
def test_option_steps_card_equals_cpu(cuda_device, case):
    """chip_smoke.py phase 5's cases of the trainer's other update modes and
    loss terms (sparse, sparse + reg, semantic on K1 and on K2 windows,
    consistency, normal + projective correction + sdf_l1, dr_neus, time
    conditioning, dense Adam, SGD), 5 steps each: card = CPU at phase 5's
    tolerances, every K1 / K2 launch of the semantic and consistency cases
    held against its plain version."""
    import chip_smoke

    assert len(chip_smoke.OPTION_CASES) == 10
    chip_smoke.phase_agreement_options(steps=5, cases=chip_smoke.OPTION_CASES[case:case + 1])


def _shard_case(rng, device, variant, n=2, C=1 << 13, L=3, M=4000):
    """Whole tables and entries, and one row shard's blocks and entries."""
    pdt = torch.bfloat16 if variant == "bf16p" else torch.float32
    mdt = torch.float32 if variant == "f32" else torch.bfloat16
    tabs, rows_l, g_l = _tables_and_entries(rng, [C] * L, [C] * L, M, "cpu")
    whole = [[torch.from_numpy(a).to(dt) for a in lv] for lv, dt in zip(tabs, (pdt, mdt, mdt))]
    return whole, rows_l, g_l


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "bf16m", "bf16p"])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_kernel_matches_plain_and_unsharded_k2(cuda_device, variant, n):
    """K2's row-sharded caller on the card: each of n shards against its
    plain version on CPU copies (f32 rtol 1e-5 / atol 1e-6; every table
    bit-equal on rows with at most one entry, bf16 p's rounding included),
    and the n shards' blocks concatenated against one unsharded K2 launch
    on the same entries (the same tolerance; bf16 bit-equal on rows with at
    most one entry)."""
    rng = np.random.default_rng(3)
    C, L = 1 << 13, 3
    whole, rows_l, g_l = _shard_case(rng, cuda_device, variant, n, C, L)
    kw = dict(grads_bf16=variant != "f32", sr_seed=11 if variant == "bf16p" else None)
    k2 = [[t.to(cuda_device) for t in lv] for lv in whole]
    ak.fused_adam_multi(*k2, [r.to(cuda_device) for r in rows_l],
                        [g.to(cuda_device) for g in g_l], LR, BC1, BC2, [1.0, 0.5, 0.25], **kw)
    b = C // n
    single = [torch.bincount(r[r != C - 1].long(), minlength=C) <= 1 for r in rows_l]
    ak.reset_launch_counts()
    blocks = []
    for k in range(n):
        rl, gl = [], []
        for l in range(L):
            r = rows_l[l].long()
            sel = (r // b == k) & (r != C - 1)
            rl.append(r[sel] - k * b + l * b)
            gl.append(g_l[l][sel])
        perm = torch.from_numpy(rng.permutation(sum(len(x) for x in rl)))
        rows = torch.cat(rl)[perm].to(torch.int32)
        g = torch.cat(gl)[perm]
        loc = [[t[k * b:(k + 1) * b].clone() for t in lv] for lv in whole]
        card = [[t.to(cuda_device) for t in lv] for lv in loc]
        base = ak.shard_row_base([(C, D)] * L, n, k)
        ak.fused_adam_shard(*card, rows.to(cuda_device), g.to(cuda_device), LR, BC1, BC2,
                            [1.0, 0.5, 0.25], base, **kw)
        ak.fused_adam_shard_plain(*loc, rows, g, LR, BC1, BC2, [1.0, 0.5, 0.25], base, **kw)
        for t in range(3):
            for l in range(L):
                a, c, s_ = card[t][l].cpu(), loc[t][l], single[l][k * b:(k + 1) * b]
                assert torch.equal(a[s_].view(torch.int16) if a.itemsize == 2 else a[s_],
                                   c[s_].view(torch.int16) if c.itemsize == 2 else c[s_])
                if a.dtype == torch.float32:
                    torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
        blocks.append(card)
    assert ak.LAUNCHES["fused_adam_multi_shard" + ak._SUFFIX[variant]] == n
    for t in range(3):
        for l in range(L):
            got = torch.cat([blk[t][l] for blk in blocks]).cpu()
            want = k2[t][l].cpu()
            s_ = single[l]
            if got.dtype == torch.bfloat16:
                assert torch.equal(got[s_].view(torch.int16), want[s_].view(torch.int16))
            else:
                assert torch.equal(got[s_], want[s_])
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _held(card, cpu, single, every_row=False):
    """Card tables against the plain version's on the CPU: bit-equal on the
    rows ``single`` (per level; bf16 p's noise included), f32 tables within
    rtol 1e-5 / atol 1e-6 elsewhere; ``every_row``: bit-equal everywhere."""
    for t in range(3):
        for a, c, s_ in zip(card[t], cpu[t], single):
            a = a.cpu()
            bits = torch.int16 if a.itemsize == 2 else torch.int32
            if every_row:
                assert torch.equal(a.view(bits), c.view(bits)), f"table {t} parted"
                continue
            diff = int((a[s_].view(bits) != c[s_].view(bits)).sum())
            assert diff == 0, f"table {t}: {diff} elements of single-entry rows differ"
            if a.dtype == torch.float32:
                torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)


def _single(rows_l, sizes, trash=True):
    """Per level the rows with at most one entry (``trash``: the last row is
    the trashbin, whose entries are left out)."""
    return [torch.bincount(r[(r >= 0) & (r < C - int(trash))].long(), minlength=C)[:C] <= 1
            for r, C in zip(rows_l, sizes)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "bf16m", "bf16p"])
@pytest.mark.parametrize("case", ["many_tiles", "tail_level", "head_elsewhere", "hot_tile",
                                  "det_sorted"])
def test_update_kernel_cases_match_plain(cuda_device, variant, case):
    """The update kernel (csrc/fused_adam.cu) against the plain version on
    CPU copies, each case with more tiles than the card holds CTAs at once
    (over 8 x 132), so the grid runs in several waves: ``many_tiles`` a row
    shard (2 of 2; f32 within rtol 1e-5 / atol 1e-6, single-entry rows
    bit-equal, bf16 p's noise keyed by the whole table); ``tail_level`` K2
    at D 3 with used heads whose element counts are not multiples of 8
    (tail groups, rows past the heads untouched); ``head_elsewhere`` the
    last of 4 shards, where level 2's used head lies in shard 0 (its block:
    zero moments, no entries; the idle groups' path, with -0.0 moments and
    -0.0 parameters among them, which take the full step); ``hot_tile`` K2
    with one level's entries all on one row (the work list's extra items);
    ``det_sorted`` the deterministic sum on the sorted prep (every row
    bit-equal to the CPU's).  Rows with no entry count as single-entry
    rows: bit-equal, idle or not."""
    rng = np.random.default_rng(17)
    pdt = torch.bfloat16 if variant == "bf16p" else torch.float32
    mdt = torch.float32 if variant == "f32" else torch.bfloat16
    kw = dict(grads_bf16=variant != "f32", sr_seed=13 if variant == "bf16p" else None)
    scales = [1.0, 0.5, 0.25]

    def tables(sizes, n_used, M, dim=D):
        tabs, rows_l, g_l = [[], [], []], [], []
        for C, nu in zip(sizes, n_used):
            m = rng.normal(0, 0.01, (C, dim)).astype(np.float32)
            v = np.abs(rng.normal(0, 1e-4, (C, dim))).astype(np.float32)
            m[nu:] = 0.0
            v[nu:] = 0.0
            for k, (a, dt) in enumerate(((rng.normal(0, 0.1, (C, dim)), pdt), (m, mdt),
                                         (v, mdt))):
                tabs[k].append(torch.from_numpy(a.astype(np.float32)).to(dt))
            rows = rng.integers(0, max(nu, 1), M).astype(np.int32)
            rows[M // 2: M // 2 + M // 8] = rows[: M // 8]
            g = rng.normal(0, 1e-3, (M, dim)).astype(np.float32)
            rows_l.append(torch.from_numpy(rows))
            g_l.append(torch.from_numpy(g))
        return tabs, rows_l, g_l

    def on_card(ts):
        return [[t.to(cuda_device) for t in lv] for lv in ts]

    if case in ("many_tiles", "head_elsewhere"):
        n, C = (2, 1 << 18) if case == "many_tiles" else (4, 1 << 19)
        k = n - 1
        b = C // n
        n_used = [C, C, b // 2] if case == "head_elsewhere" else [C] * 3
        tabs, rows_l, g_l = tables([C] * 3, n_used, 20000)
        if case == "head_elsewhere":  # signed zeros in the headroom: not idle
            for t in range(3):
                tabs[t][2][-1000:-500:3] = -0.0
        rl, gl = [], []
        for l in range(3):
            r = rows_l[l].long()
            sel = (r // b == k) & (r != C - 1)  # misses do not route
            rl.append(r[sel] - k * b + l * b)
            gl.append(g_l[l][sel])
        rows, g = torch.cat(rl).to(torch.int32), torch.cat(gl)
        loc = [[t[k * b:(k + 1) * b].clone() for t in lv] for lv in tabs]
        assert 3 * b // ak.tile_rows(D) > 8 * 132
        card = on_card(loc)
        base = ak.shard_row_base([(C, D)] * 3, n, k)
        ak.fused_adam_shard(*card, rows.to(cuda_device), g.to(cuda_device), LR, BC1, BC2,
                            scales, base, **kw)
        ak.fused_adam_shard_plain(*loc, rows, g, LR, BC1, BC2, scales, base, **kw)
        _held(card, loc, _single([rl[l] - l * b for l in range(3)], [b] * 3, trash=False))
        if case == "head_elsewhere":  # no used row of level 2 in this shard
            for t in range(3):
                bits = torch.int16 if tabs[t][2].itemsize == 2 else torch.int32
                assert torch.equal(card[t][2].cpu().view(bits)[:-1000],
                                   tabs[t][2][k * b:-1000].view(bits))
        return
    if case == "tail_level":
        dim, sizes, n_used = 3, [600_032, 400_008, 200_000], [600_001, 400_003, 199_999]
    else:
        dim, sizes, n_used = D, [1 << 18, 1 << 18, 4096], [200_000, 150_000, 1024]
    tabs, rows_l, g_l = tables(sizes, n_used, 30000, dim)
    if case == "hot_tile":
        rows_l[2][:20000] = 5  # one row takes 20,000 entries: 40 work items
    tb = ak.tile_rows(dim)
    assert sum(-(-nu // tb) for nu in n_used) > 8 * 132
    card = on_card(tabs)
    ak.fused_adam_multi(*card, [r.to(cuda_device) for r in rows_l],
                        [g.to(cuda_device) for g in g_l], LR, BC1, BC2, scales, n_used,
                        deterministic=case == "det_sorted", **kw)
    if case == "hot_tile":
        pre = ak.entry_prep([r.to(cuda_device) for r in rows_l], sizes, n_used, dim)
        assert int(pre.n_split) > 0
    ak.fused_adam_multi(*tabs, rows_l, g_l, LR, BC1, BC2, scales, n_used, **kw)
    _held(card, tabs, _single(rows_l, sizes), every_row=case == "det_sorted")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "bf16m", "bf16p"])
def test_deterministic_sum_repeats_and_equals_plain(cuda_device, variant):
    """The update with ``deterministic=True`` (the replicas' sum: each row's
    entries in entry order from the sorted prep) gives the same bits on
    every launch, and the bits of the plain version on the CPU on EVERY row
    (``index_add_`` on the CPU sums in the same order)."""
    rng = np.random.default_rng(4)
    whole, rows_l, g_l = _shard_case(rng, cuda_device, variant)
    kw = dict(grads_bf16=variant != "f32", sr_seed=5 if variant == "bf16p" else None)
    runs = []
    for _ in range(2):
        card = [[t.to(cuda_device) for t in lv] for lv in whole]
        ak.fused_adam_multi(*card, [r.to(cuda_device) for r in rows_l],
                            [g.to(cuda_device) for g in g_l], LR, BC1, BC2, [1.0, 0.5, 0.25],
                            deterministic=True, **kw)
        runs.append(card)
    cpu = [[t.clone() for t in lv] for lv in whole]
    ak.fused_adam_multi(*cpu, rows_l, g_l, LR, BC1, BC2, [1.0, 0.5, 0.25], **kw)
    for t in range(3):
        for a, b, c in zip(runs[0][t], runs[1][t], cpu[t]):
            bits = (lambda x: x.cpu().view(torch.int16 if x.itemsize == 2 else torch.int32))
            assert torch.equal(bits(a), bits(b)), "two launches parted"
            assert torch.equal(bits(a), bits(c)), "the deterministic sum left the plain order"


@pytest.mark.cuda
def test_deterministic_sum_refuses_the_kernel_prep(cuda_device):
    """csrc/entry_prep.cu bins a tile's entries in the order its atomics
    land, so a row's entries may lie in several runs: the deterministic sum
    refuses that prep (it would keep one run of each row) and raises before
    any launch, leaving the tables and the launch count as they were."""
    rng = np.random.default_rng(6)
    whole, rows_l, g_l = _shard_case(rng, cuda_device, "f32")
    card = [[t.to(cuda_device) for t in lv] for lv in whole]
    rows_c = [r.to(cuda_device) for r in rows_l]
    pre = ak.entry_prep(rows_c, [t.shape[0] for t in card[0]], None, card[0][0].shape[1])
    assert not pre.sorted_by_row
    before = [[t.clone() for t in lv] for lv in card]
    ak.reset_launch_counts()
    with pytest.raises(ValueError, match="sorted by row"):
        ak.fused_adam_multi(*card, rows_c, [g.to(cuda_device) for g in g_l], LR, BC1, BC2,
                            [1.0, 0.5, 0.25], pre=pre, deterministic=True)
    assert ak.LAUNCHES["fused_adam_multi"] == 0
    for x, y in zip(card, before):
        for a, b in zip(x, y):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "bf16m"])
def test_shard_kernel_on_a_live_prep(cuda_device, variant):
    """K2's row-sharded caller on the prep of an iid step's live routing:
    csrc/entry_prep.cu bins a shard's received entries (two sample ranks'
    cells padded with -1 rows and NaN gradients, never read) into the same
    tiles and (row, entry) pairs as the sorted ``entry_prep_local``, the pads
    excluded and not dropped; the kernel on that prep against its plain
    version on CPU copies (f32 rtol 1e-5 / atol 1e-6 and every table
    bit-equal on rows with at most one entry; bf16 moments on those rows)."""
    rng = np.random.default_rng(7)
    n, C, L = 2, 1 << 13, 3
    whole, rows_l, g_l = _shard_case(rng, cuda_device, variant, n, C, L)
    b = C // n
    single = [torch.bincount(r[r != C - 1].long(), minlength=C) <= 1 for r in rows_l]
    kw = dict(grads_bf16=variant != "f32")
    for k in range(n):
        rows_list, gs = [], []
        for l in range(L):
            r = rows_l[l].long()
            cells = []
            for half in (slice(0, len(r) // 2), slice(len(r) // 2, len(r))):
                rh, gh = r[half], g_l[l][half]
                sel = (rh // b == k) & (rh != C - 1)
                cells.append((rh[sel] - k * b, gh[sel]))
            E = -(-max(len(c[0]) for c in cells) // 8) * 8
            rows_list.append(torch.cat([torch.cat([c[0], c[0].new_full((E - len(c[0]),), -1)])
                                        for c in cells]).to(torch.int32))
            gs.append(torch.cat([torch.cat([c[1], c[1].new_full((E - len(c[0]), D),
                                                                 float("nan"))])
                                 for c in cells]))
        g_loc = torch.cat(gs)
        ak.reset_launch_counts()
        pre = ak.entry_prep_shard([r.to(cuda_device) for r in rows_list], [b] * L, D)
        assert ak.LAUNCHES["entry_prep"] == 1 and not pre.sorted_by_row
        plain = ak.entry_prep_shard(rows_list, [b] * L, D)
        assert plain.sorted_by_row and int(pre.dropped) == 0
        assert torch.equal(pre.tile_off.cpu(), plain.tile_off)

        def pairs(p):
            return torch.sort((p.rows.cpu().long() << 32) | p.order.cpu().long()).values

        assert torch.equal(pairs(pre), pairs(plain))
        loc = [[t[k * b:(k + 1) * b].clone() for t in lv] for lv in whole]
        card = [[t.to(cuda_device) for t in lv] for lv in loc]
        base = ak.shard_row_base([(C, D)] * L, n, k)
        ak.fused_adam_shard(*card, None, g_loc.to(cuda_device), LR, BC1, BC2,
                            [1.0, 0.5, 0.25], base, pre=pre, **kw)
        ak.fused_adam_shard_plain(*loc, None, g_loc, LR, BC1, BC2, [1.0, 0.5, 0.25], base,
                                  pre=plain, **kw)
        assert ak.LAUNCHES["fused_adam_multi_shard" + ak._SUFFIX[variant]] == 1
        for t in range(3):
            for l in range(L):
                a, c, s_ = card[t][l].cpu(), loc[t][l], single[l][k * b:(k + 1) * b]
                assert torch.equal(a[s_].view(torch.int16) if a.itemsize == 2 else a[s_],
                                   c[s_].view(torch.int16) if c.itemsize == 2 else c[s_])
                if a.dtype == torch.float32:
                    torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ small, hot tables

# run (l)'s final tables (rgbd_incre_reg.yaml, chip_smoke.py phase 11) and
# run (k)'s (rgbd_batch.yaml): 32,768 entries a level
HOT_L = ((65536,) * 4, (20480, 5120, 1024, 1024))
HOT_K = ((524288, 65536, 65536, 65536), (286720, 22528, 21504, 21504))


def _hot_case(rng, sizes, n_used, M, device, one_row=None):
    """chip_smoke.py's kernel inputs (~1e-3 gradients, 30 % trashbin
    entries, a tenth duplicated) at small tables; ``one_row``: that level's
    entries all on one row."""
    import chip_smoke

    tabs0, rows_l, g_l = chip_smoke._kernel_inputs(rng, sizes, n_used, M, D, device)
    if one_row is not None:
        rows_l[one_row] = torch.full_like(rows_l[one_row], n_used[one_row] // 2)
    return tabs0, rows_l, g_l


def _spread(tabs0, rows_l, g_l, lrs, n_used, **kw):
    import chip_smoke

    sp = [chip_smoke._sum_order_spread([t[lv] for t in tabs0], rows_l[lv], g_l[lv], lrs[lv],
                                       BC1, BC2, n_used[lv], **kw) for lv in range(len(lrs))]
    return [[s_[t][0] for s_ in sp] for t in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["l", "l_one_row", "k"])
def test_levels_kernel_on_small_hot_tables_matches_plain(cuda_device, case):
    """K1's per-level step in one launch (``fused_adam_levels``: one prep, a
    work list that splits the hot tiles, each level's lr) on run (l)'s
    tables (levels of 1,024 used rows taking 32,768 entries each), with one
    row taking all of a level's entries, and on run (k)'s 4 levels: against
    L per-level plain steps at chip_smoke.py phase 2's tolerance plus the
    sum-order spread, bit-equal on rows of at most one entry, headroom
    untouched; one launch counted, with 4 levels.  A second launch on the
    same prep gives the same result (the split tiles' scratch was left
    zero)."""
    import chip_smoke

    sizes, n_used = HOT_K if case == "k" else HOT_L
    rng = np.random.default_rng(21)
    tabs0, rows_l, g_l = _hot_case(rng, sizes, n_used, 32768, cuda_device,
                                   one_row=3 if case == "l_one_row" else None)
    scales = [1.0, 0.5, 0.25, 0.125]
    lrs = [LR * s_ for s_ in scales]
    plain = [[t.clone() for t in lv] for lv in tabs0]
    for lv in range(4):
        ak.fused_adam_plain(*(t[lv] for t in plain), rows_l[lv], g_l[lv], lrs[lv], BC1, BC2,
                            n_used[lv])
    single = chip_smoke._single_rows(rows_l, list(sizes), list(n_used))
    spread = _spread(tabs0, rows_l, g_l, lrs, n_used)
    pre = ak.entry_prep(rows_l, list(sizes), list(n_used), D)
    # (l)'s levels of 1,024 used rows hold ~8,192 entries a tile: split;
    # (k)'s tiles hold under ENTRY_CHUNK entries: one launch, one CTA a tile
    assert (int(pre.n_split) > 0) == (case != "k"), int(pre.n_split)
    for given in (None, pre):
        kern = [[t.clone() for t in lv] for lv in tabs0]
        ak.reset_launch_counts()
        ak.fused_adam_levels(*kern, rows_l, g_l, LR, BC1, BC2, scales, list(n_used), pre=given)
        torch.cuda.synchronize()
        assert ak.LAUNCHES["fused_adam"] == 1 and ak.LEVEL_STEPS["fused_adam"] == 4
        assert ak.LAUNCHES["entry_prep"] == (1 if given is None else 0)
        chip_smoke._check_f32(kern, plain, tabs0, list(n_used), single=single,
                              moved_share=None, spread=spread)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "bf16m", "bf16p"])
def test_multi_kernel_variants_on_hot_tables_match_plain(cuda_device, variant):
    """The template's three dtype variants through the split tiles (K2 at
    run (l)'s tables, one level's entries all on one row): f32 p, m, v at
    phase 2's tolerance plus the sum-order spread; bf16 moments within one
    bf16 ulp but for TIE_SHARE ties, their f32 p as f32; bf16 p (stochastic
    rounding) within one bf16 ulp of the plain version, which rounds with
    the kernel's Philox bits; every table bit-equal on rows of at most one
    entry."""
    import chip_smoke

    sizes, n_used = HOT_L
    rng = np.random.default_rng(22)
    tabs0, rows_l, g_l = _hot_case(rng, sizes, n_used, 32768, cuda_device, one_row=2)
    pd = torch.bfloat16 if variant == "bf16p" else torch.float32
    md = torch.float32 if variant == "f32" else torch.bfloat16
    t0 = [[t.to(dt) for t in lv] for lv, dt in zip(tabs0, (pd, md, md))]
    scales = [1.0, 0.5, 0.25, 0.125]
    kw = dict(grads_bf16=variant != "f32", sr_seed=9 if variant == "bf16p" else None)
    kern = [[t.clone() for t in lv] for lv in t0]
    plain = [[t.clone() for t in lv] for lv in t0]
    ak.fused_adam_multi(*kern, rows_l, g_l, LR, BC1, BC2, scales, list(n_used), **kw)
    ak.fused_adam_multi_plain(*plain, rows_l, g_l, LR, BC1, BC2, scales, list(n_used), **kw)
    torch.cuda.synchronize()
    single = chip_smoke._single_rows(rows_l, list(sizes), list(n_used))
    for t in range(3):
        for a, b, s_ in zip(kern[t], plain[t], single):
            bits = (lambda x: x.view(torch.int16 if x.itemsize == 2 else torch.int32))
            assert torch.equal(bits(a[s_]), bits(b[s_])), "a single-entry row differs"
    lrs = [LR * s_ for s_ in scales]
    f32 = [[t.float() for t in lv] for lv in t0]
    spread = _spread(f32, rows_l, g_l, lrs, n_used, grads_bf16=variant != "f32")
    if variant == "f32":
        chip_smoke._check_f32(kern, plain, t0, list(n_used), single=single, moved_share=None,
                              spread=spread)
        return
    chip_smoke._check_bf16_ties(kern[1:], plain[1:], t0[1:], list(n_used), moved_share=None)
    if variant == "bf16m":
        chip_smoke._check_f32(kern[:1], plain[:1], t0[:1], list(n_used), names="p",
                              single=single, moved_share=None, spread=spread[:1])
        return
    for a, b, nu in zip(kern[0], plain[0], n_used):
        a32, b32 = a[:nu].float(), b[:nu].float()
        over = (a32 - b32).abs() - 2.0 ** -7 * b32.abs() - 2.0 ** -20 * float(b32.abs().max())
        assert float(over.max()) <= 0, "bf16 p more than one bf16 ulp from plain"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_shard_kernel_on_hot_live_prep_matches_plain(cuda_device, n):
    """K2's row-sharded caller (the ``_ex`` entry points: each block's place
    in the whole table keys its Philox groups) on a live prep whose tiles
    are split (a third of every level's entries on one row of shard 0):
    each of n shards, bf16 p with stochastic rounding, bit-equal to its
    plain version on rows of at most one entry and within one bf16 ulp
    elsewhere (moments but for TIE_SHARE ties)."""
    import chip_smoke

    rng = np.random.default_rng(23)
    C, L, M = 1 << 14, 3, 24000
    b = C // n
    tabs, rows_l, g_l = _tables_and_entries(rng, [C] * L, [C] * L, M, "cpu")
    for r in rows_l:
        r[: M // 3] = 5  # a hot row of shard 0
    whole = [[torch.from_numpy(a).to(torch.bfloat16) for a in lv] for lv in tabs]
    single = [torch.bincount(r[r != C - 1].long(), minlength=C) <= 1 for r in rows_l]
    kw = dict(grads_bf16=True, sr_seed=13)
    for k in range(n):
        rows_list, gs = [], []
        for l in range(L):
            r = rows_l[l].long()
            sel = (r // b == k) & (r != C - 1)
            rows_list.append((r[sel] - k * b).to(torch.int32))
            gs.append(g_l[l][sel])
        g_loc = torch.cat(gs)
        pre = ak.entry_prep_shard([r.to(cuda_device) for r in rows_list], [b] * L, D)
        if k == 0:
            assert int(pre.n_split) > 0, "no tile was split"
        plain_pre = ak.entry_prep_shard(rows_list, [b] * L, D)
        loc = [[t[k * b:(k + 1) * b].clone() for t in lv] for lv in whole]
        card = [[t.to(cuda_device) for t in lv] for lv in loc]
        base = ak.shard_row_base([(C, D)] * L, n, k)
        ak.fused_adam_shard(*card, None, g_loc.to(cuda_device), LR, BC1, BC2,
                            [1.0, 0.5, 0.25], base, pre=pre, **kw)
        ak.fused_adam_shard_plain(*loc, None, g_loc, LR, BC1, BC2, [1.0, 0.5, 0.25], base,
                                  pre=plain_pre, **kw)
        got = [[t.cpu() for t in lv] for lv in card]
        for t in range(3):
            for l in range(L):
                s_ = single[l][k * b:(k + 1) * b]
                assert torch.equal(got[t][l][s_].view(torch.int16),
                                   loc[t][l][s_].view(torch.int16))
        t0 = [[t[k * b:(k + 1) * b] for t in lv] for lv in whole]
        chip_smoke._check_bf16_ties(got[1:], loc[1:], t0[1:], [b] * L, moved_share=None)
        for a, c in zip(got[0], loc[0]):
            a32, c32 = a.float(), c.float()
            over = (a32 - c32).abs() - 2.0 ** -7 * c32.abs() - 2.0 ** -20 * float(
                c32.abs().max())
            assert float(over.max()) <= 0, "bf16 p more than one bf16 ulp from plain"


# ------------------------------------------------------------------ the recorded iid step


def _graph_world(device, setting, n=40000, capacity=1 << 14):
    """A sphere's band and free-space samples on the card, its map and pool
    lookups: ``room`` (4 feature levels, no eikonal) or ``street`` (3
    levels, the eikonal's second-order backward).  Returns (settings,
    tables, pool, lookups, a function that makes the same fresh state)."""
    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.optimizer import FEATURES, init_opt_state

    rng = np.random.default_rng(17)
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    disp = rng.uniform(-0.08, 0.08, (n, 1))
    coord = (dirs * (0.5 + disp)).astype(np.float32)
    levels = 4 if setting == "room" else 3
    cfg = SHINEConfig()
    cfg.tree_level_world, cfg.tree_level_feat, cfg.bs = 8, levels, 2048
    cfg.ekional_loss_on, cfg.weight_e = setting == "street", 0.1
    cfg.derive()
    grid = HashGridHost(8, levels, D, 0.05, seed=3, init_node_capacity=capacity,
                        init_corner_capacity=capacity, device=device)
    grid.update((dirs * 0.5).astype(np.float32))
    s = trainer.TrainSettings.from_config(cfg, grid.levels, sigma_sigmoid=0.05,
                                          n_used=trainer.used_rows_for(grid))
    near = np.abs(disp[:, 0]) < 0.02
    pool = {"coord": torch.from_numpy(coord).to(device),
            "sdf_label": torch.from_numpy(disp[:, 0].astype(np.float32)).to(device),
            "weight": torch.from_numpy(np.where(near, 1.0, -0.5).astype(np.float32)).to(device),
            "time": torch.zeros(n, device=device)}
    pre = trainer.precompute_pool_lookups(grid.tables, pool["coord"], grid.levels,
                                          [f.shape[0] for f in grid.features])

    def fresh():
        params = trainer.init_params(cfg, grid, torch.Generator(device).manual_seed(0))
        params[FEATURES] = [f.clone() for f in params[FEATURES]]
        return params, init_opt_state(params)

    return s, grid.tables, pool, pre, fresh


def _deterministic_k1(monkeypatch):
    """K1 with its sorted, deterministic sum (the shared-memory atomics sum a
    row's entries in no fixed order); returns the list of each launch's
    dropped count."""
    from shine_mapping_tpu_torch.ops import adam_kernel

    inner, dropped = adam_kernel.fused_adam_levels, []

    def det(*a, **k):
        d = inner(*a, deterministic=True, **k)
        dropped.append(int(d))
        return d

    monkeypatch.setattr(adam_kernel, "fused_adam_levels", det)
    return dropped


def _one_step_chunks(world, steps, eager, state=None, start=0, gen=None, chunk=1):
    """``steps`` steps in chunks of ``chunk`` from ``state`` (default a
    fresh one); ``eager``: one-step chunks with the graph cleared before
    each, so every step is a key's first and runs eagerly.  Returns (params,
    opt state, each chunk's last loss)."""
    from shine_mapping_tpu_torch.train import trainer

    s, tables, pool, pre, fresh = world
    params, opt = state or fresh()
    gen = gen or torch.Generator(pool["coord"].device).manual_seed(9)
    losses = []
    for k in range(0, steps, chunk):
        if eager:
            opt.graph = None
        params, opt, aux = trainer.train_chunk(params, opt, tables, pool,
                                               pool["coord"].shape[0], start + k, gen, s, chunk,
                                               pre_lookups=pre)
        losses.append(aux["last"]["total_loss"])
    return params, opt, losses


def _every_tensor(params, opt):
    from shine_mapping_tpu_torch.train.optimizer import FEATURES, dense_params

    out = dict(dense_params(params))
    out.update({f"features.{i}": f for i, f in enumerate(params[FEATURES])})
    for name, st in (("m", opt.m), ("v", opt.v)):
        out.update({f"{name}.{k}": t for k, t in st.items() if k != FEATURES})
        out.update({f"{name}.features.{i}": t for i, t in enumerate(st[FEATURES])})
    return out


def _assert_bit_equal(a, b):
    ta, tb = _every_tensor(*a[:2]), _every_tensor(*b[:2])
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 5], ids=["one-step-chunks", "one-chunk"])
@pytest.mark.parametrize("setting", ["room", "street"])
def test_recorded_step_equals_eager_steps_bit_for_bit(cuda_device, monkeypatch, setting, chunk):
    """Five steps through the recorded graph (the first eager, the second
    recorded and replayed, three replayed), in one-step chunks as the
    benchmark's checked steps or in one chunk as the batch CLI, against
    five eager steps from the same state on the same draws: every
    parameter, moment, dropped count and loss (each step's, or the chunk's
    last) bit for bit.  K1 takes its deterministic sum on both sides, so
    that the comparison is the graph's."""
    from shine_mapping_tpu_torch.train import trainer

    world = _graph_world(cuda_device, setting)
    dropped = _deterministic_k1(monkeypatch)
    trainer.reset_graph_counts()
    graphed = _one_step_chunks(world, 5, eager=False, chunk=chunk)
    assert trainer.GRAPH_COUNTS == {"eager": 1, "captured": 1, "replayed": 4}
    d_graph = list(dropped)
    trainer.reset_graph_counts()
    eager = _one_step_chunks(world, 5, eager=True)
    assert trainer.GRAPH_COUNTS == {"eager": 5, "captured": 0, "replayed": 0}
    assert d_graph == dropped[5:] and len(d_graph) == 5
    assert float(eager[2][-1]) < float(eager[2][0])  # it trains
    _assert_bit_equal(graphed, eager[:2] + (eager[2][chunk - 1::chunk],))
    assert graphed[1].step == eager[1].step == 5


@pytest.mark.cuda
def test_recorded_step_counts_and_records_anew_for_a_new_table(cuda_device, monkeypatch):
    """Three one-step chunks: 1 eager, 1 recorded, 2 replays.  A table
    reallocated (another address) is a new key: its first step eager, the
    next recorded; the steps stay the eager ones bit for bit."""
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.optimizer import FEATURES

    world = _graph_world(cuda_device, "room")
    _deterministic_k1(monkeypatch)
    out = []
    for eager in (False, True):
        trainer.reset_graph_counts()
        gen = torch.Generator(cuda_device).manual_seed(4)
        p, o, l1 = _one_step_chunks(world, 3, eager, gen=gen)
        if not eager:
            assert trainer.GRAPH_COUNTS == {"eager": 1, "captured": 1, "replayed": 2}
        p[FEATURES][0] = p[FEATURES][0].clone()
        p, o, l2 = _one_step_chunks(world, 3, eager, (p, o), start=3, gen=gen)
        if not eager:
            assert trainer.GRAPH_COUNTS == {"eager": 2, "captured": 2, "replayed": 4}
        out.append((p, o, l1 + l2))
    _assert_bit_equal(*out)


@pytest.mark.cuda
def test_recorded_step_peak_memory_is_the_eager_steps(cuda_device):
    """The allocator's peak over five steps with the graph is at most 1 %
    above five eager steps' (both after a warm-up step on another state,
    so that the eager stream's cuBLAS workspace exists in both), at a map
    and pool of some size."""
    from shine_mapping_tpu_torch.train import trainer

    world = _graph_world(cuda_device, "street", n=1 << 20, capacity=1 << 20)
    _one_step_chunks(world, 1, eager=True)
    peaks = {}
    for eager in (True, False):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state = _one_step_chunks(world, 5, eager)
        torch.cuda.synchronize()
        peaks[eager] = (torch.cuda.max_memory_allocated(), base,
                        torch.cuda.memory_allocated())
        del state
    (pe, be, ae), (pg, bg, ag) = peaks[True], peaks[False]
    print(f"eager peak {pe} (base {be}, after {ae}); graph peak {pg} (base {bg}, after {ag})")
    assert pg <= 1.01 * pe


@pytest.mark.cuda
def test_recorded_step_records_while_another_thread_uploads(cuda_device, monkeypatch):
    """The batch CLI uploads its next sub-pool on a thread of its own while
    the chunk trains: a recording and its replays beside a thread that
    copies host arrays to the card all along still give the eager steps'
    bits, and the thread's copies all succeed."""
    import threading

    from shine_mapping_tpu_torch.train import trainer

    world = _graph_world(cuda_device, "room")
    _deterministic_k1(monkeypatch)
    host = np.random.default_rng(0).normal(size=(1 << 20, 4)).astype(np.float32)
    stop, errors, copies = threading.Event(), [], [0]

    def upload():
        try:
            while not stop.is_set():
                torch.from_numpy(host).to(cuda_device)
                copies[0] += 1
        except BaseException as e:  # noqa: BLE001  (read on the test's thread)
            errors.append(e)

    t = threading.Thread(target=upload, daemon=True)
    t.start()
    try:
        trainer.reset_graph_counts()
        graphed = _one_step_chunks(world, 5, eager=False)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors and copies[0] > 0
    assert trainer.GRAPH_COUNTS == {"eager": 1, "captured": 1, "replayed": 4}
    _assert_bit_equal(graphed, _one_step_chunks(world, 5, eager=True))
