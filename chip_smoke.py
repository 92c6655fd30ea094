#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``shine_mapping_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch, and the
   build of every CUDA kernel from ``shine_mapping_tpu_torch/csrc``;
2. kernels: each kernel entry point and table-dtype variant against its
   plain torch version at the main path's shapes (3 levels of 4M-row tables
   with ~3M used rows, D 8, 65,536 entries per level with duplicates,
   trashbin rows and headroom):
   - float32 p/m/v (K1, K2): p, m and v each held at a tolerance set by its
     own scale, and each seen to move;
   - float32 p, bf16 m/v, entries rounded to bf16 (K1, K2): p as above, m
     and v bit-equal but for a stated share of one-ulp ties;
   - bf16 p/m/v with stochastic rounding (K2): each p one of the two bf16
     neighbours of the plain f32 step, unbiased, rounded up as often as its
     fractional position says, the same seed bit-identical, another seed
     not;
   headroom bit-identical in all.  With each: its time (wrapper with and
   without a precomputed entry prep, kernel alone), the plain version's, a
   PyTorch library yardstick where one call computes the same step
   (``index_add_`` + fused ``torch.optim.Adam``, f32 only) and the
   bandwidth bound;
3. training: the batch-mapping main path at full ICRA width
   (config/config_icra2023/maicity_batch.yaml: bs 8192, 3 levels, D 8,
   2x32 MLP, sdf_bce + eikonal 0.1, lr 0.01) on a world built like
   bench.py's ``build_bench_world`` (seed 0, 400k-point surface band, ~3M
   corners per level, 2M-sample pool), six paths, launch counts zeroed
   before and read after each: 200 steps with the multi-level update (one
   launch per step) and 50 with the per-level update (one per level per
   step) on iid batches; then pool lookups + epoch windows (W = 245): 200
   steps of f32 tables and moments on fused windows (K2), 200 of the bf16
   map mode on the same windows (bf16 tables and moments, K2 with
   stochastic rounding), 50 of bf16 moments on per-level windows (K1) and
   50 of bf16 moments on fused windows with f32 tables (K2);
4. query: the trained field at a few thousand points;
5. agreement: a small world trained on the card and on the CPU (the plain
   versions) from the same weights and batches: both iid updates, and bf16
   moments on both window layouts; the bf16-table mode (whose rounding
   bits differ between the two) within a loss band.

Prints the kernels' JSON line, the nvidia-smi line, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
ICRA_CONFIG = "config/config_icra2023/maicity_batch.yaml"
SOURCE = "shine_mapping_tpu_torch/csrc/fused_adam.cu"
DEVICE = "cuda"  # the card; a rehearsal on the CPU may set "cpu"
K1_TPU = "shine_mapping_tpu/ops/adam_kernel.py:65"
K2_TPU = "shine_mapping_tpu/ops/adam_kernel.py:155"
# one-ulp ties allowed between bf16 moments of the kernel and of the plain
# version: the two sum a row's entries in another order, and an f32 value
# one ulp apart rounds to the other bf16 neighbour when it sits on a
# midpoint (about 2**-16 of the elements that differ at all)
TIE_SHARE = 1e-3


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- phase 1


def phase_device():
    import torch

    from shine_mapping_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    cuda_build.load("fused_adam")
    info = cuda_build.BUILD_INFO["fused_adam"]
    print(f"[device] fused_adam.cu: " + ("library already built" if info["log"] == "cached"
                                         else f"built in {info['seconds']:.2f} s"))
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line or "Compiling" in line:
            print(f"[device]   ptxas: {line.strip()}")
    return smi


# ----------------------------------------------------------------- phase 2


def _kernel_inputs(rng, sizes, n_used, M, D, device):
    """Per-level tables [p, m, v] (zero past each used head) and entries at
    main-path shapes.  v is ~1e-4, so one step moves it by ~1e-6 (its 1%
    decay), far beyond the tolerance: a kernel that skipped a store of v
    would not pass."""
    import numpy as np
    import torch

    tabs = [[], [], []]
    rows_l, g_l = [], []
    for C, nu in zip(sizes, n_used):
        init = (rng.normal(0, 0.05, (nu, D)), rng.normal(0, 1e-3, (nu, D)),
                np.abs(rng.normal(0, 1e-4, (nu, D))))
        for k, a in enumerate(init):
            t = torch.zeros(C, D, device=device)
            t[:nu] = torch.from_numpy(a.astype(np.float32)).to(device)
            tabs[k].append(t)
        rows = rng.integers(0, nu, M).astype(np.int32)
        rows[M // 2: M // 2 + M // 10] = rows[: M // 10]  # duplicate rows
        trash = rng.random(M) < 0.3  # missed lookups -> trashbin row
        rows[trash] = C - 1
        g = rng.normal(0, 1e-3, (M, D)).astype(np.float32)
        g[trash] = 0.0
        rows_l.append(torch.from_numpy(rows).to(device))
        g_l.append(torch.from_numpy(g).to(device))
    return tabs, rows_l, g_l


def _bound_ms(n_used, M_total, D, p_bytes=4, m_bytes=4, sr=False):
    """Least time for the step: each input read once, each output written
    once (p, m, v over the used heads in and out, at their dtypes' sizes;
    int32 rows and f32 gradients in), or ~13 f32 operations per table
    element (+ ~10 integer operations of Philox per element with stochastic
    rounding, counted at the f32 rate)."""
    elems = sum(n_used) * D
    nbytes = 2 * (p_bytes + 2 * m_bytes) * elems + M_total * (4 + 4 * D)
    flops = (13 + (10 if sr else 0)) * elems + M_total * D
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _library_ms(ps, rows_l, g_l, n_used, lrs):
    """Yardstick only, never called by the port: index_add_ into dense
    gradients, then torch.optim.Adam(fused=True) with one group per level."""
    import torch

    params, entries = [], []
    for p, nu, rows, g in zip(ps, n_used, rows_l, g_l):
        params.append(p[:nu].clone().requires_grad_())
        keep = (rows >= 0) & (rows < nu)
        entries.append((rows[keep].long(), g[keep]))
    opt = torch.optim.Adam([{"params": [q], "lr": lr} for q, lr in zip(params, lrs)],
                           betas=(0.9, 0.99), eps=1e-15, fused=True)

    def step():
        for q, (rows, g) in zip(params, entries):
            q.grad = torch.zeros_like(q).index_add_(0, rows, g)
        opt.step()

    return cuda_ms(step)


def _check_f32(kern, plain, tabs0, n_used, names="pmv"):
    """Each given table per level: allclose with rtol 1e-5 and an atol of
    1e-5 of that table's own scale (at most 1e-6), every element of the
    used head moved by the step, headroom rows bit-identical."""
    import torch

    err = 0.0
    for name, ks, ps, t0s in zip(names, kern, plain, tabs0):
        for a, b, t0, nu in zip(ks, ps, t0s, n_used):
            a, b, t0 = a.float(), b.float(), t0.float()
            err = max(err, float((a - b).abs().max()))
            atol = min(1e-6, 1e-5 * float(t0[:nu].abs().max()))
            torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
            moved = float((b[:nu] != t0[:nu]).float().mean())
            assert moved > 0.99, f"{name}: only {moved:.4f} of the used head moved"
            assert torch.equal(a[nu:], t0[nu:]), f"{name}: headroom rows changed"
    return err


def _check_bf16_ties(kern, plain, tabs0, n_used, names="mv"):
    """bf16 tables per level: bit-equal but for at most TIE_SHARE of the
    used elements, which may lie one bf16 ulp apart, plus 8 f32 ulps of the
    level's largest value (where b1 m + (1 - b1) g nearly cancels, the
    kernel's fused multiply-add and the plain version's two roundings
    differ by an f32 ulp of the terms, which is large beside the result);
    each used head moved; headroom bit-identical.  Returns (max abs error,
    tie share)."""
    import torch

    err, ties, total = 0.0, 0, 0
    for name, ks, ps, t0s in zip(names, kern, plain, tabs0):
        for a, b, t0, nu in zip(ks, ps, t0s, n_used):
            assert a.dtype == torch.bfloat16, f"{name}: {a.dtype}"
            a32, b32 = a[:nu].float(), b[:nu].float()
            d = (a32 - b32).abs()
            err = max(err, float(d.max()))
            ties += int((d > 0).sum())
            total += d.numel()
            over = d - 2.0 ** -7 * b32.abs() - 2.0 ** -20 * float(b32.abs().max())
            worst = int(over.reshape(-1).argmax())
            assert float(over.reshape(-1)[worst]) <= 0, (
                f"{name}: kernel {float(a32.reshape(-1)[worst]):.6e} vs plain "
                f"{float(b32.reshape(-1)[worst]):.6e} at element {worst}, more than one "
                "bf16 ulp apart")
            moved = float((b[:nu].float() != t0[:nu].float()).float().mean())
            assert moved > 0.99, f"{name}: only {moved:.4f} of the used head moved"
            assert torch.equal(a[nu:].float(), t0[nu:].float()), f"{name}: headroom changed"
    assert ties <= TIE_SHARE * total, f"{ties} of {total} bf16 moments differ"
    return err, ties / total


def _bf16_toward(x, direction):
    """float32 ``x`` rounded to bfloat16 towards -inf (``direction`` -1) or
    +inf (1), as float32."""
    import torch

    t = (x.view(torch.int32) & -65536).view(torch.float32)  # towards zero
    away = (t.view(torch.int32) + 65536).view(torch.float32)
    return torch.where((t == x) | ((x > 0) == (direction < 0)), t, away)


def _check_sr(p_out, p_exact, p0, n_used, p_again, p_other):
    """Stochastic rounding of the new bf16 p against the plain f32 step
    ``p_exact``: every element one of the two bf16 neighbours of a value
    within 16 f32 ulps of p_exact plus 8 f32 ulps of the level's largest
    value (the sum order, and p - lr m / sqrt(v) where it nearly cancels,
    as in :func:`_check_bf16_ties`); the mean rounding error,
    in ulps, within 5 sigma of 0 (unbiased); in each tenth of the fractional
    position, the share rounded away from zero within 0.01 of the tenth's
    mean position; the same seed bit-identical, another seed not; headroom
    bit-identical.  Returns (max abs error vs p_exact, mean error in ulps,
    sigma, worst bin deviation)."""
    import torch

    errs, fracs, ups = [], [], []
    max_err = 0.0
    for a, e, a0, nu, b, c in zip(p_out, p_exact, p0, n_used, p_again, p_other):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a[nu:].view(torch.int16), a0[nu:].view(torch.int16)), \
            "headroom of p changed"
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), \
            "the same sr_seed gave other bits"
        assert float((a[:nu].view(torch.int16) != c[:nu].view(torch.int16)).float().mean()) > 0.1, \
            "another sr_seed gave the same bits"
        e = e[:nu].reshape(-1)
        o = a[:nu].reshape(-1).float()
        max_err = max(max_err, float((o - e).abs().max()))
        slack = 2.0 ** -19 * e.abs() + 2.0 ** -20 * float(e.abs().max())
        ok = (o >= _bf16_toward(e - slack, -1)) & (o <= _bf16_toward(e + slack, 1))
        assert bool(ok.all()), f"{int((~ok).sum())} elements off both bf16 neighbours"
        lo = e.view(torch.int32) & -65536
        down, up = lo.view(torch.float32), (lo + 65536).view(torch.float32)
        exact_nb = (o == down) | (o == up)
        ulp = (up - down).abs()
        frac = ((e - down).abs() / ulp)[exact_nb]
        rounded_up = (o != down)[exact_nb].float()
        errs.append(rounded_up - frac)
        fracs.append(frac)
        ups.append(rounded_up)
    err, frac, up = torch.cat(errs).double(), torch.cat(fracs).double(), torch.cat(ups).double()
    sigma = float(torch.sqrt((frac * (1 - frac)).sum()) / err.numel())
    mean = float(err.mean())
    assert abs(mean) < 5 * sigma, f"biased rounding: mean {mean:.3e} ulp, sigma {sigma:.3e}"
    worst = 0.0
    for k in range(10):
        sel = (frac >= k / 10) & (frac < (k + 1) / 10)
        if int(sel.sum()) > 1000:
            worst = max(worst, abs(float(up[sel].mean()) - float(frac[sel].mean())))
    assert worst < 0.01, f"rounded-up share off its fractional position by {worst:.4f}"
    return max_err, mean, sigma, worst


def phase_kernels(C=1 << 22, corners=(3_180_000, 3_070_000, 2_400_000), M=65536):
    import numpy as np
    import torch

    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    dev = torch.device(DEVICE)
    D = 8
    sizes = [C] * 3
    # the bench world's corner counts (bench.py), rounded up like the trainer
    n_used = list(ak.used_rows_hint(corners, sizes))
    lr, bc1, bc2 = 0.01, 1 - 0.9 ** 5, 1 - 0.99 ** 5
    scales = [1.0, 0.5, 0.25]  # per-level lr routing
    rng = np.random.default_rng(0)
    tabs0, rows_l, g_l = _kernel_inputs(rng, sizes, n_used, M, D, dev)
    offs = [0, sizes[0], sizes[0] + sizes[1]]
    rows_json = []
    dtypes = {"f32": (torch.float32, torch.float32),
              "bf16m": (torch.float32, torch.bfloat16),
              "bf16p": (torch.bfloat16, torch.bfloat16)}

    def tables(levels, variant):
        pd, md = dtypes[variant]
        return [[t.to(dt) for t in tabs0[k][:levels]]
                for k, dt in ((0, pd), (1, md), (2, md))]

    def case(variant, levels):
        """One entry point x variant: correctness, then times."""
        multi = levels > 1
        name = ("fused_adam_multi" if multi else "fused_adam") + ak._SUFFIX[variant]
        nu, rl, gl = n_used[:levels], rows_l[:levels], g_l[:levels]
        sc = scales[:levels]
        kw = dict(grads_bf16=variant != "f32")
        if variant == "bf16p":
            kw["sr_seed"] = 7
        t0 = tables(levels, variant)

        def wrapper(ts, pre=None, **extra):
            if multi:
                return ak.fused_adam_multi(*ts, rl, gl, lr, bc1, bc2, sc, nu, pre=pre,
                                           **{**kw, **extra})
            return ak.fused_adam(*(t[0] for t in ts), rl[0], gl[0], lr, bc1, bc2, nu[0],
                                 pre=pre, grads_bf16=kw["grads_bf16"])

        def plain(ts):
            if multi:
                return ak.fused_adam_multi_plain(*ts, rl, gl, lr, bc1, bc2, sc, nu, **kw)
            return ak.fused_adam_plain(*(t[0] for t in ts), rl[0], gl[0], lr, bc1, bc2,
                                       nu[0], grads_bf16=kw["grads_bf16"])

        kern = [[t.clone() for t in lv] for lv in t0]
        wrapper(kern)
        torch.cuda.synchronize()
        extra = ""
        if variant == "bf16p":
            # the unrounded step: f32 p through the plain bf16-moment version
            exact = [[t.float() for t in t0[0]], [t.clone() for t in t0[1]],
                     [t.clone() for t in t0[2]]]
            ak.fused_adam_multi_plain(*exact, rl, gl, lr, bc1, bc2, sc, nu,
                                      grads_bf16=True)
            again = [[t.clone() for t in lv] for lv in t0]
            other = [[t.clone() for t in lv] for lv in t0]
            wrapper(again)
            wrapper(other, sr_seed=8)
            torch.cuda.synchronize()
            err, mean, sigma, worst = _check_sr(kern[0], exact[0], t0[0], nu, again[0],
                                                other[0])
            _, ties = _check_bf16_ties(kern[1:], exact[1:], t0[1:], nu)
            extra = (f"SR mean error {mean:+.2e} ulp (sigma {sigma:.1e}), worst bin "
                     f"{worst:.4f}, moment ties {ties:.1e}, ")
            del exact, again, other
        else:
            ref = [[t.clone() for t in lv] for lv in t0]
            plain(ref)
            torch.cuda.synchronize()
            if variant == "f32":
                err = _check_f32(kern, ref, t0, nu)
            else:
                err = _check_f32(kern[:1], ref[:1], t0[:1], nu, names="p")
                e2, ties = _check_bf16_ties(kern[1:], ref[1:], t0[1:], nu)
                err = max(err, e2)
                extra = f"moment ties {ties:.1e}, "
            del ref
        sizes_l = sizes[:levels]
        pre = ak.entry_prep(rl, sizes_l, nu)
        t_wrap = cuda_ms(lambda: wrapper(kern))
        t_pre = cuda_ms(lambda: wrapper(kern, pre=pre))
        g_s = ak._sorted_grads(pre, gl, D)
        lrs = [lr * s for s in sc]
        t_kern = cuda_ms(lambda: ak._launch(variant, *kern, pre.rows, g_s, nu, offs[:levels],
                                            lrs, 0.9, 0.99, bc1, bc2, 1e-15,
                                            kw["grads_bf16"], 7))
        scratch = [[t.clone() for t in lv] for lv in t0]
        t_plain = cuda_ms(lambda: plain(scratch), iters=5)
        t_lib = _library_ms(t0[0], rl, gl, nu, lrs) if variant == "f32" else None
        pb, mb = (t.itemsize for t in dtypes[variant])
        bound, by = _bound_ms(nu, levels * M, D, pb, mb, sr=variant == "bf16p")
        rows_json.append(dict(name=name, route="cuda", source=SOURCE,
                              replaces=K2_TPU if multi else K1_TPU, variant=variant,
                              max_abs_err=err, ms=t_wrap, ms_with_pre=t_pre,
                              kernel_only_ms=t_kern, plain_ms=t_plain, bound_ms=bound,
                              bound_by=by, library_ms=t_lib))
        lib = "n/a" if t_lib is None else f"{t_lib:.4f} ms"
        print(f"[kernels] {'K2' if multi else 'K1'} {name} ({levels} level(s), used rows {nu}, "
              f"M {levels * M}): max_abs_err {err:.3e}, {extra}wrapper {t_wrap:.4f} ms, "
              f"with pre {t_pre:.4f} ms, kernel alone {t_kern:.4f} ms, plain {t_plain:.4f} ms, "
              f"library {lib}, bound {bound:.4f} ms ({by})")
        del kern, scratch, g_s, pre
        torch.cuda.empty_cache()

    case("f32", 1)
    case("f32", 3)
    case("bf16m", 1)
    case("bf16m", 3)
    case("bf16p", 3)
    del tabs0
    torch.cuda.empty_cache()
    return rows_json


# ----------------------------------------------------------------- phase 3


def build_bench_world(cfg, device, n_surf=400_000, n_pool=2_000_000, seed=0):
    """bench.py's ``build_bench_world`` recipe (a rolling terrain band through
    the [-1, 1] cube, seed 0), built with the port's own classes."""
    import numpy as np

    from shine_mapping_tpu_torch.data.dataset import SamplePool
    from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost

    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.9, 0.9, (n_surf, 2))
    z = 0.08 * np.sin(4 * xy[:, 0]) * np.cos(3 * xy[:, 1])
    surf = np.stack([xy[:, 0], xy[:, 1], z], axis=1)
    band = surf + rng.normal(0, 0.003, surf.shape)
    grid = HashGridHost(
        max_level=cfg.tree_level_world, featured_level_num=cfg.tree_level_feat,
        feature_dim=cfg.feature_dim, feature_std=cfg.feature_std, seed=seed,
        init_node_capacity=1 << 19, init_corner_capacity=1 << 19, device=device)
    grid.update(band)
    coord = np.repeat(band, 5, axis=0)[:n_pool].astype(np.float32)
    coord += rng.normal(0, 0.01, coord.shape).astype(np.float32)
    pool = SamplePool(
        coord=coord,
        sdf_label=rng.normal(0, 0.01, n_pool).astype(np.float32),
        weight=np.where(rng.random(n_pool) < 0.7, 1.0, -1.0).astype(np.float32),
        time=np.zeros(n_pool, np.float32),
    )
    return grid, pool, band


# the main path's training runs: (label, launch key, launches per step,
# steps, iid multi-level update, windows layout or None, bf16 moments,
# bf16 tables)
RUNS = (
    ("multi-level (K2)", "fused_adam_multi", 1, 200, True, None, False, False),
    ("per-level (K1)", "fused_adam", 3, 50, False, None, False, False),
    ("f32, fused windows (K2)", "fused_adam_multi", 1, 200, False, "fused", False, False),
    ("bf16 map mode (K2, bf16 tables + SR)", "fused_adam_multi_bf16p", 1, 200, False,
     "fused", True, True),
    ("bf16 moments, per-level windows (K1)", "fused_adam_bf16m", 3, 50, False, "level",
     True, False),
    ("bf16 moments, fused windows, f32 tables (K2)", "fused_adam_multi_bf16m", 1, 50,
     False, "fused", True, False),
)


def _train(cfg, grid, pool_dev, n_valid, fuse, steps, chunk, seed, windows=None,
           moments_bf16=False, params_bf16=False, pre=None):
    """Train ``steps`` from fresh decoders; the loss must be finite and fall
    on a fixed set of 65,536 pool samples (a noise-free before/after).
    ``windows`` "fused" / "level" builds epoch windows over ``pre`` (pool
    lookups) first; returns their build time."""
    import numpy as np
    import torch

    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.optimizer import init_opt_state

    s = trainer.TrainSettings.from_config(
        cfg, grid.levels, feature_update="pallas", fuse_update_levels=fuse,
        n_used=trainer.used_rows_for(grid))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = trainer.init_params(cfg, grid, torch.Generator(device=DEVICE).manual_seed(seed))
    if params_bf16:  # the JAX batch driver's cast (shine_batch.py:245-248)
        params["features"] = [f.to(torch.bfloat16) for f in params["features"]]
    opt = init_opt_state(params, moments_bf16=moments_bf16)
    win, t_win = None, 0.0
    if windows is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        win = trainer.precompute_batch_windows(
            pre, n_valid, torch.Generator(device=DEVICE).manual_seed(seed), s,
            [tuple(f.shape) for f in params["features"]], fused=windows == "fused")
        torch.cuda.synchronize()
        t_win = time.perf_counter() - t0
    k = min(65536, n_valid)
    fixed = torch.arange(k, device=DEVICE) * n_valid // k
    before = float(trainer.batch_loss(params, grid.tables, pool_dev, fixed, s)["total_loss"])
    losses, times = [], []
    for start in range(0, steps, chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, aux = trainer.train_chunk(params, opt, grid.tables, pool_dev, n_valid,
                                               start, gen, s, chunk, pre_lookups=pre,
                                               batch_windows=win)
        losses.append(float(aux["mean"]["total_loss"]))  # syncs
        times.append((time.perf_counter() - t0) / chunk * 1e3)
    after = float(trainer.batch_loss(params, grid.tables, pool_dev, fixed, s)["total_loss"])
    assert np.all(np.isfinite(losses + [before, after])), f"non-finite loss {losses}"
    assert after < before, f"loss on the fixed samples did not fall: {before} -> {after}"
    want = (torch.bfloat16 if params_bf16 else torch.float32,
            torch.bfloat16 if moments_bf16 else torch.float32)
    for f, m in zip(params["features"], opt.m["features"]):
        assert (f.dtype, m.dtype) == want, f"tables became {f.dtype}/{m.dtype}"
    if win is not None:
        assert win.n_windows == -(n_valid // -cfg.bs), win.n_windows
    return params, (before, after), losses, float(np.median(times[1:])), t_win, win


def phase_train(cfg, n_surf=400_000, n_pool=2_000_000):
    import torch

    from shine_mapping_tpu_torch.ops import adam_kernel as ak
    from shine_mapping_tpu_torch.train import trainer

    t0 = time.perf_counter()
    grid, pool, band = build_bench_world(cfg, DEVICE, n_surf, n_pool)
    pool_dev, n_valid = trainer.pool_to_device(pool, len(pool), device=DEVICE)
    print(f"[train] bench world: corners per level {grid.corner_counts}, table rows "
          f"{[f.shape[0] for f in grid.features]}, pool {n_valid}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    init_feats = [f.clone() for f in grid.features]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = trainer.precompute_pool_lookups(grid.tables, pool_dev["coord"], grid.levels,
                                          [f.shape[0] for f in grid.features])
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    print(f"[train] pool lookups for {n_valid} samples x {len(grid.levels)} levels: "
          f"{t_pre:.3f} s")

    runs, launches, fixed_loss = {}, {}, {}
    for label, key, per_step, steps, fuse, windows, mbf, pbf in RUNS:
        for f, f0 in zip(grid.features, init_feats):
            f.copy_(f0)
        torch.cuda.reset_peak_memory_stats()
        ak.reset_launch_counts()  # this path of the main path starts here
        params, (before, after), losses, ms, t_win, win = _train(
            cfg, grid, pool_dev, n_valid, fuse, steps, 10, 0, windows, mbf, pbf,
            pre if windows else None)
        counts = dict(ak.LAUNCHES)  # read right after the path
        del win
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        assert counts[key] == steps * per_step, f"{key}: {counts[key]} launches, " \
            f"want {steps * per_step}"
        others = {k: n for k, n in counts.items() if k != key and n}
        assert not others, f"other kernels launched during the {label} run: {others}"
        launches[key] = launches.get(key, 0) + counts[key]
        runs[key] = params
        fixed_loss[label] = after
        beside = ""
        if pbf:
            beside = (f" (f32 on the same windows: {fixed_loss['f32, fused windows (K2)']:.6f}, "
                      f"f32 on iid batches: {fixed_loss['multi-level (K2)']:.6f})")
        win_s = f", windows built in {t_win:.3f} s" if windows else ""
        print(f"[train] {label}: {steps} steps, {counts[key]} launches, fixed-sample loss "
              f"{before:.6f} -> {after:.6f}{beside}, loss per 10 steps "
              f"{[round(x, 5) for x in losses]}, {ms:.3f} ms/step after warm-up (bs "
              f"{cfg.bs}, {cfg.bs / ms * 1e3:.0f} samples/s){win_s}, peak device memory "
              f"{peak:.2f} GiB")
    print(f"[train] launch counts over the main path's runs: {launches}")
    # the last run trained the grid's own (f32) tables in place
    return grid, band, runs[RUNS[-1][1]], launches


# ----------------------------------------------------------------- phase 4


def phase_query(grid, band, params):
    import numpy as np
    import torch

    from shine_mapping_tpu_torch.ops.query import query_feature

    pts = np.concatenate([band[:3000], np.random.default_rng(1).uniform(-1, 1, (1000, 3))])
    x = torch.from_numpy(pts.astype(np.float32)).to(DEVICE)
    with torch.no_grad():
        sdf = params["geo"].sdf(query_feature(x, grid.tables, grid.features, grid.levels,
                                              grid.polynomial_interpolation))
    assert sdf.shape == (x.shape[0],) and bool(torch.isfinite(sdf).all()), "bad sdf"
    print(f"[query] sdf at {x.shape[0]} points: finite, "
          f"range [{float(sdf.min()):.4f}, {float(sdf.max()):.4f}]")


# ----------------------------------------------------------------- phase 5


def phase_agreement():
    """The port on the card (CUDA kernel) vs the port on the CPU (plain
    versions): a small sphere world, 20 steps from the same weights on the
    same batches.  adam_eps 1e-3 so the step is a smooth function of the
    gradient (at 1e-15, rows with rounding-noise gradients move by ~lr
    either way: see tests/test_torch_trainer.py).  f32 tables and moments,
    iid batches, both update entry points: rtol 1e-4, atol 1e-5.  bf16
    moments on both window layouts: a moment one f32 ulp apart may round
    to the neighbouring bf16 value, so p within atol 2e-4 everywhere and
    rtol 1e-4, atol 1e-5 on 99.9% of elements, decoders rtol 1e-3, atol
    1e-5.  bf16 tables: the card's rounding bits (Philox) are not the CPU's
    (torch.Generator), so only the mean loss is held, to rtol 2e-3."""
    import numpy as np
    import torch

    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.data.dataset import SamplePool
    from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.optimizer import init_opt_state

    rng = np.random.default_rng(2)
    n = 4000
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    disp = rng.uniform(-0.04, 0.04, (n, 1))
    surf = dirs * (0.5 + disp)
    free = dirs * rng.uniform(0.2, 0.45, (n, 1))
    pool = SamplePool(
        coord=np.concatenate([surf, free]).astype(np.float32),
        sdf_label=np.concatenate([disp[:, 0], np.linalg.norm(free, axis=1) - 0.5]).astype(np.float32),
        weight=np.concatenate([np.ones(n), -np.ones(n)]).astype(np.float32),
        time=np.zeros(2 * n, np.float32))
    cfg = SHINEConfig()
    cfg.tree_level_world, cfg.tree_level_feat, cfg.bs, cfg.lr = 7, 3, 1024, 0.01
    cfg.ekional_loss_on, cfg.adam_eps = True, 1e-3
    cfg.derive()
    idx = torch.from_numpy(rng.integers(0, 2 * n, (20, cfg.bs)))
    # (label, fuse_update_levels, windows layout, bf16 moments, bf16 tables)
    modes = (("multi-level update", True, None, False, False),
             ("per-level update", False, None, False, False),
             ("bf16 moments, per-level windows", False, "level", True, False),
             ("bf16 moments, fused windows", False, "fused", True, False),
             ("bf16 map mode (bf16 tables)", False, "fused", True, True))
    windows_idx = None
    for label, fuse, layout, mbf, pbf in modes:
        out, init = {}, None
        for device in ("cpu", DEVICE):
            grid = HashGridHost(7, 3, 8, 0.05, seed=3, init_node_capacity=1 << 12,
                                init_corner_capacity=1 << 12, device=device)
            grid.update(surf)
            s = trainer.TrainSettings.from_config(
                cfg, grid.levels, sigma_sigmoid=0.05, fuse_update_levels=fuse,
                feature_update="pallas", n_used=trainer.used_rows_for(grid))
            params = trainer.init_params(cfg, grid)
            if init is None:  # the CPU run's initial decoders, for both runs
                init = {k: {name: t.clone() for name, t in params[k].state_dict().items()}
                        for k in ("geo", "sem")}
            for k in ("geo", "sem"):
                params[k].load_state_dict(init[k])
            if pbf:
                params["features"] = [f.to(torch.bfloat16) for f in params["features"]]
            opt = init_opt_state(params, moments_bf16=mbf)
            dev, nv = trainer.pool_to_device(pool, len(pool), device=device)
            kw = dict(batch_indices=idx)
            if layout is not None:
                pre = trainer.precompute_pool_lookups(grid.tables, dev["coord"], grid.levels,
                                                      [f.shape[0] for f in grid.features])
                if windows_idx is None:
                    windows_idx = torch.randperm(2 * n, generator=torch.Generator().manual_seed(4))
                    windows_idx = windows_idx[: (2 * n // cfg.bs) * cfg.bs].reshape(-1, cfg.bs)
                win = trainer.precompute_batch_windows(
                    pre, nv, None, s, [tuple(f.shape) for f in params["features"]],
                    fused=layout == "fused", window_indices=windows_idx)
                kw = dict(pre_lookups=pre, batch_windows=win)
            params, opt, aux = trainer.train_chunk(params, opt, grid.tables, dev, nv, 0,
                                                   None, s, 20, **kw)
            out[device] = ([f.float().cpu() for f in params["features"]],
                           {k: t.cpu() for k, t in params["geo"].state_dict().items()},
                           float(aux["mean"]["total_loss"]))
        card, cpu = out[DEVICE], out["cpu"]
        if pbf:
            np.testing.assert_allclose(card[2], cpu[2], rtol=2e-3)
            what = "mean loss within rtol 2e-3"
        elif mbf:
            for a, b in zip(card[0], cpu[0]):
                torch.testing.assert_close(a, b, rtol=0, atol=2e-4)
                share = float(torch.isclose(a, b, rtol=1e-4, atol=1e-5).float().mean())
                assert share >= 0.999, f"{label}: only {share:.5f} of p agree"
            for k in cpu[1]:
                torch.testing.assert_close(card[1][k], cpu[1][k], rtol=1e-3, atol=1e-5)
            what = "parameters agree"
        else:
            for a, b in zip(card[0], cpu[0]):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
            for k in cpu[1]:
                torch.testing.assert_close(card[1][k], cpu[1][k], rtol=1e-4, atol=1e-5)
            what = "parameters agree"
        print(f"[agreement] {label}, 20 steps: card loss {card[2]:.6f} vs CPU "
              f"{cpu[2]:.6f}; {what}")


# ----------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    import shine_mapping_tpu_torch  # noqa: F401  (fails outside a checkout)
    from shine_mapping_tpu_torch.config import SHINEConfig

    t_start = time.perf_counter()
    smi = phase_device()
    kernels = phase_kernels()
    cfg = SHINEConfig().load(ICRA_CONFIG)
    print(f"[train] {ICRA_CONFIG}: bs {cfg.bs}, levels {cfg.tree_level_feat}, dim "
          f"{cfg.feature_dim}, mlp {cfg.geo_mlp_level}x{cfg.geo_mlp_hidden_dim}, "
          f"{cfg.main_loss_type} + eikonal {cfg.weight_e if cfg.ekional_loss_on else 0}, "
          f"lr {cfg.lr}, device {cfg.device}")
    grid, band, params, launches = phase_train(cfg)
    phase_query(grid, band, params)
    phase_agreement()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        assert k["launches"] > 0, f"{k['name']} never launched on the main path"
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
