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
    (pc, oc, ac, lc), (pp, op, ap, _) = out["card"], out["cpu"]
    assert lc["fused_adam_multi" if fused_windows else "fused_adam"] == (5 if fused_windows
                                                                           else 15)
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
