#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``shine_mapping_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch, and the
   build of every CUDA kernel from ``shine_mapping_tpu_torch/csrc``;
2. kernels: the entry prep (csrc/entry_prep.cu) against its plain version
   (a stable sort: the same tile offsets, dropped count and binned pairs),
   then each update entry point and table-dtype variant against its plain
   torch version at the main path's shapes (3 levels of 4M-row tables with
   ~3M used rows, D 8, 65,536 entries per level with duplicates, trashbin
   rows and headroom):
   - float32 p/m/v (K1, K2): p, m and v each held at a tolerance set by its
     own scale, each seen to move, and bit-equal on every row with at most
     one entry (the kernel rounds each operation as torch does);
   - float32 p, bf16 m/v, entries rounded to bf16 (K1, K2): p as above, m
     and v bit-equal but for a stated share of one-ulp ties;
   - bf16 p/m/v with stochastic rounding (K2): each p one of the two bf16
     neighbours of the plain f32 step, unbiased, rounded up as often as its
     fractional position says, the same seed bit-identical, another seed
     not, and bit-equal to the plain version (which rounds with the
     kernel's Philox bits) on every row with at most one entry;
   headroom bit-identical in all.  With each: its time (wrapper with and
   without a precomputed entry prep, kernel alone), the plain version's, a
   PyTorch library yardstick where one call computes the same step
   (``index_add_`` + fused ``torch.optim.Adam``, f32 only) and the
   bandwidth bound.  Where the parent commit's fused_adam.cu (with this
   commit's C interface) was copied to
   ``shine_mapping_tpu_torch/csrc/build/parent/`` (git-ignored), its kernel
   is built too and timed beside the new one in turns (old, new, new, old)
   on the same inputs, and its stochastic-rounding bits compared;
2b. kernel study: each kernel of the JAX round's kernel studies against
   its plain version at the study scripts' bench shapes (tables of
   4,194,304 rows of 8, 65,536 sorted entries; a (262,144, 128) table and
   32,768 row jobs for K7), with its times (the wrapper's back to back, and
   the kernel alone: 20 launches captured in a CUDA graph, the replay
   timed), a library yardstick where one call computes the same function
   (fused ``torch.optim.Adam`` over the entries' or a zero gradient,
   ``torch.stack`` for K4's copy, ``torch.add``, ``index_add_``; timed both
   ways too), and its bound: the one-hot windowed Adam
   (csrc/onehot_adam.cu) as K3 over exp_fused_adam.py's four (tb, w)
   tilings, K4's six variants, K5 with a float32 and a bfloat16 copy of p;
   the Triton sweep (K6) and the tile read-modify-write (K7), bit-equal.
   K7's data fits the L2, so it and ``index_add_`` are also timed cold
   (256 MB written and read back before each launch).  Where the parent
   commit's onehot_adam.cu and tile_rmw.cu were copied to
   ``shine_mapping_tpu_torch/csrc/build/parent/``, their kernels are timed
   alone beside the new ones in turns (K7 warm and cold).
   Then the five study programs of ``shine_mapping_tpu_torch.experiments`` run at
   their bench shapes (depth cut to 5 calls per timing), launch counts
   zeroed before and read after;
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
   50 of bf16 moments on fused windows with f32 tables (K2); the entry
   prep's launches counted beside the update's;
4. query: the trained field at a few thousand points;
5. agreement: a small world trained on the card and on the CPU (the plain
   versions) from the same weights and batches: both iid updates, and bf16
   moments on both window layouts; the bf16-table mode (whose rounding
   bits differ between the two) within a loss band.  Then the trainer's
   other update modes and terms, 20 steps each from the same weights,
   batches and near points (``OPTION_CASES``): sparse lazy Adam alone and
   with the continual reg, the semantic head on K1 (iid) and on K2 with
   bf16 moments (fused windows), consistency with its near points' rows as
   extra K1 entries, normal + projective correction + sdf_l1, dr_neus on a
   ray-major pool, a time-conditioned decoder, dense autodiff Adam and
   SGD; every K1 / K2 launch of the semantic and consistency cases held
   against its plain version (``_KernelCheck``);
6. map: the port's batch CLI (``cli.shine_batch.run_shine_mapping_batch``)
   end to end on tests/synth.py's analytic world (20 frames of 64 x 1024
   rays, exact ground truth), launch counts zeroed before and read after
   each run.  Run A: the ICRA config at full width, 1,500 steps (K1 per
   level), dense-bbx meshing through the node lattices, native marching,
   ``eval_mesh``; held to Chamfer-L1 < 0.15 m and F-score > 75 %.  Its
   final checkpoint loaded by the port gives the live map's SDF bit for bit,
   and the card's dense lattice query of a sub-box agrees with the plain
   path on CPU tensors (masks equal, |d sdf| <= 1e-5).  Run B: the bf16 map
   mode through the CLI, 500 steps (K2 with stochastic rounding), held to
   the same bars;
7. incre: the port's incremental CLI (``cli.shine_incre``) with continual
   learning on phase 6's world, launch counts zeroed before and read after
   each run.  Run C: ``config/maicity/maicity_incre_reg.yaml`` as written
   (bs 4096, 50 steps a frame, lambda 1e6, live probes, K1 per level with
   the reg folded into its entries, the importance sweep after each frame,
   a dense-bbx mesh every 5 frames); run D: ``maicity_incre_replay.yaml``
   (bs 8192, eikonal, window replay, K1); run E: run C on per-frame fused
   windows with the reg's owner flags and bf16 moments (K2), the work-ratio
   gate forced open.  Cuts (printed on ``[incre] reduced:`` lines): the
   world's 20 frames, the decoder frozen after 10.  Each run: the launches
   of its update and preps and no other kernel, finite losses, the reg
   after frame 0, importance, decoders bit-unchanged through the frozen
   frames, the last-frame snapshot unmoved by training, per-frame medians,
   and the final mesh's F-score within 5 points of the JAX driver's on the
   CPU (``JAX_INCRE_FSCORE``).  After run C, card = CPU on its final state:
   the importance sweep, then 5 reg steps with every K1 launch held against
   its plain version;
8. city: semantic mapping at street scale through the batch CLI on
   tests/synth_city.py's labelled city (seed 0, 150 frames of 1,024 x 48
   rays, 8 x 3 blocks, parked and moving cars, a turn), with
   experiments/demo_tpu_kitti_scale.py's config at its full width
   (``CITY_CFG``: pc_radius 50 m, vox 0.05, leaf 0.2, world level 12, 3
   levels, D 8, bs 4096, semantics and the moving-object filter, the bf16
   map mode, 2^22-sample rotating sub-pools, octree meshing at 0.2 m with
   vertex semantics).  Run F: that config as written (K2 bf16 p + SR on
   fused windows); run G: ``feature_update: sparse`` (f32 tables, iid
   batches, no kernel).  Cuts (``[city] reduced:`` lines): iters 20,000 ->
   4,000, pool_rotate_iters 2,000 -> 1,000, the ground truth's rescans every
   15th pose at the scans' resolution.  Each run: its launches (F: one K2
   bf16-p launch a step and one entry prep per device pool; G: none), at
   least one rotation, finite losses with sem_loss falling, Chamfer-L1 <
   0.15 m and F-score > 75 % against the ground truth, >= 80 % of the
   vertices near one labelled class carrying it; G's F-score within 5
   points of F's.  ``--only agreement,city`` (any of agreement, map,
   incre, city) runs those phases alone and prints no result line.

Prints the kernels' JSON line, the nvidia-smi line, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
ICRA_CONFIG = "config/config_icra2023/maicity_batch.yaml"
SOURCE = "shine_mapping_tpu_torch/csrc/fused_adam.cu"
PREP_SOURCE = "shine_mapping_tpu_torch/csrc/entry_prep.cu"
# the JAX package's entry prep of K2 (XLA: it sorts outside the Pallas kernel)
PREP_TPU = "shine_mapping_tpu/ops/adam_kernel.py:307"
# git-ignored copies of the parent commit's fused_adam.cu, onehot_adam.cu and
# tile_rmw.cu, when the command that measures kernels old beside new puts
# them there
PARENT_DIR = os.path.join("shine_mapping_tpu_torch", "csrc", "build", "parent")
DEVICE = "cuda"  # the card; a rehearsal on the CPU may set "cpu"
K1_TPU = "shine_mapping_tpu/ops/adam_kernel.py:65"
K2_TPU = "shine_mapping_tpu/ops/adam_kernel.py:155"
CUDA_SOURCES = ("fused_adam", "entry_prep", "onehot_adam", "tile_rmw")
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


def graph_ms(fn, n=20, reps=5):
    """Device time of one ``fn()`` alone: ``n`` calls captured in a CUDA
    graph (ctypes launches on the current stream are captured too) and the
    graph replayed ``reps`` times between two events, so no host time is in
    it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # first call outside the capture (library loads, workspaces)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def cold_ms(fn, iters=50):
    """Mean device time of one ``fn()`` that finds the 50 MB L2 cold: before
    each call a 256 MB scratch buffer is written and then read back, so
    neither ``fn``'s data nor a dirty line waiting to be written back is left
    in the cache; events around the call alone."""
    import torch

    scratch = torch.empty(64 << 20, device=DEVICE)
    fn()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(iters)]
    for start, end in evs:
        scratch.fill_(1.0)
        scratch.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in evs) / iters


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
    t0 = time.perf_counter()
    cuda_build.build_all(CUDA_SOURCES)  # one nvcc per source, all at once
    print(f"[device] {len(CUDA_SOURCES)} CUDA sources built in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in CUDA_SOURCES:
        cuda_build.load(name)
        info = cuda_build.BUILD_INFO[name]
        print(f"[device] {name}.cu: " + ("library already built" if info["log"] == "cached"
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


def _check_f32(kern, plain, tabs0, n_used, names="pmv", single=None, moved_share=0.99,
               scale_of="before", spread=None):
    """Each given table per level: allclose with rtol 1e-5 and an atol of
    1e-5 of that table's own scale (at most 1e-6; the scale taken before
    the step, or after it for tables that start at zero), plus, where
    ``spread`` is given (per table and level, elementwise), how far the
    summation order of a row's entries can move the element
    (:func:`_sum_order_spread`); bit-equal on the rows
    ``single[l]`` (rows with at most one entry, where no sum order can
    separate the two), more than ``moved_share`` of the used head moved by
    the step (None: not checked), headroom rows bit-identical."""
    import torch

    err = 0.0
    for t, (name, ks, ps, t0s) in enumerate(zip(names, kern, plain, tabs0)):
        for l, (a, b, t0, nu) in enumerate(zip(ks, ps, t0s, n_used)):
            a, b, t0 = a.float(), b.float(), t0.float()
            err = max(err, float((a - b).abs().max()))
            ref = t0 if scale_of == "before" else b
            atol = min(1e-6, 1e-5 * float(ref[:nu].abs().max()))
            if spread is None:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
            else:
                d, allow = (a - b).abs(), atol + 1e-5 * b.abs() + spread[t][l]
                bad = ~(d <= allow)
                assert not bad.any(), (
                    f"{name}: {int(bad.sum())} elements past rtol 1e-5, atol {atol:.3g} and "
                    f"the sum-order spread; worst |d| {float(d.max()):.4g}, at most "
                    f"{float(allow.flatten()[int(d.argmax())]):.4g} allowed there")
            if single is not None:
                diff = int((a[single[l]] != b[single[l]]).sum())
                assert diff == 0, f"{name}: {diff} elements of rows with at most one entry differ"
            moved = float((b[:nu] != t0[:nu]).float().mean())
            assert moved_share is None or moved > moved_share, \
                f"{name}: only {moved:.4f} of the used head moved"
            assert torch.equal(a[nu:], t0[nu:]), f"{name}: headroom rows changed"
    return err


def _share_used(a, b, allow):
    """The largest share of an elementwise allowance that |a - b| uses."""
    return float(((a - b).abs() / allow.clamp(min=1e-30)).max())


def _sum_order_spread(tabs0, rows, grads, lr, bc1, bc2, n_used, **kw):
    """How far one level's plain update moves p, m and v (from ``tabs0``)
    when each row's summed gradient moves by as much as two summation
    orders can part it.  The kernel and ``index_add_`` on the card both sum
    a row's entries by atomics, in no fixed order; any order of k terms
    lies within gamma_{k-1} sum |g_i| of the exact sum, so two orders lie
    within twice that.  Where a row's entries nearly cancel (the reg
    gradient against the loss's) that is many ulps of the sum.  Returns per
    table a (C, D) tensor: the larger change of the plain update's result
    under a shift of + or - that much; zero on rows of at most one entry."""
    import torch

    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    kw.pop("pre", None)  # the shifted steps carry more entries: a prep of their own
    C, D = tabs0[0].shape
    r, g = rows.reshape(-1).long(), grads.reshape(-1, D)
    keep = (r >= 0) & (r < n_used) & (r != C - 1)
    r, g = r[keep], g[keep]
    km1 = (torch.bincount(r, minlength=C).double() - 1).clamp(min=0)[:, None]
    abs_sum = torch.zeros((C, D), dtype=torch.float64, device=g.device).index_add_(
        0, r, g.double().abs())
    u = 2.0 ** -24
    shift = (2 * km1 * u / (1 - km1 * u) * abs_sum).float()
    touched = torch.nonzero(km1[:, 0] > 0).squeeze(1)
    outs = []
    for sign in (0.0, 1.0, -1.0):
        tabs = [x.clone() for x in tabs0]
        ak.fused_adam_plain(*tabs, torch.cat([rows.reshape(-1), touched.to(rows.dtype)]),
                            torch.cat([grads.reshape(-1, D), sign * shift[touched]]),
                            lr, bc1, bc2, n_used, **kw)
        outs.append(tabs)
    return [[torch.maximum((a - b).abs(), (c - b).abs())] for b, a, c in zip(*outs)]


def _single_rows(rows_l, sizes, n_used):
    """Per level, a (C,) mask of the rows with at most one entry."""
    import torch

    out = []
    for rows, C, nu in zip(rows_l, sizes, n_used):
        r = rows.long()
        keep = (r >= 0) & (r < nu) & (r != C - 1)
        out.append(torch.bincount(r[keep], minlength=C) <= 1)
    return out


def _check_bf16_ties(kern, plain, tabs0, n_used, names="mv", moved_share=0.99):
    """bf16 tables per level: bit-equal but for at most TIE_SHARE of the
    used elements, which may lie one bf16 ulp apart, plus 8 f32 ulps of the
    level's largest value (where b1 m + (1 - b1) g nearly cancels, the
    kernel's fused multiply-add and the plain version's two roundings
    differ by an f32 ulp of the terms, which is large beside the result);
    more than ``moved_share`` of each used head moved (None: not checked);
    headroom bit-identical.  Returns (max abs error, tie share)."""
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
            assert moved_share is None or moved > moved_share, \
                f"{name}: only {moved:.4f} of the used head moved"
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


def _parent_lib():
    """The parent commit's fused_adam.cu library, when the source was copied
    to PARENT_DIR (git-ignored; the command that measures old beside new
    puts it there) with this commit's interface, else None."""
    from shine_mapping_tpu_torch.ops import cuda_build

    if not os.path.exists(os.path.join(PARENT_DIR, "fused_adam.cu")):
        return None
    return cuda_build.load("fused_adam", PARENT_DIR, PARENT_DIR)


def _in_turns(old, new, timer=cuda_ms):
    """Device ms of ``old`` and ``new``, timed old, new, new, old."""
    a = timer(old)
    b = timer(new)
    c = timer(new)
    d = timer(old)
    return (a + d) / 2, (b + c) / 2


def _check_prep(kern, plain, T):
    """The card's prep against the plain one (a stable sort): the same tile
    offsets and dropped count, the same (row, entry) pairs, and each
    position of the kernel's inside the tile its row belongs to."""
    import torch

    assert torch.equal(kern.tile_off, plain.tile_off), "tile offsets differ"
    assert torch.equal(kern.dropped, plain.dropped), "dropped counts differ"

    def pairs(p):
        return torch.sort((p.rows.long() << 32) | p.order.long()).values

    assert torch.equal(pairs(kern), pairs(plain)), "the binned (row, entry) pairs differ"
    pos = torch.arange(kern.rows.shape[0], dtype=torch.int32, device=kern.rows.device)
    pos_tile = torch.searchsorted(kern.tile_off, pos, right=True) - 1
    kept = kern.rows != 2 ** 31 - 1
    # the tile of each kept row: the last tile whose first row is <= it
    row_tile = torch.searchsorted(_tile_starts(kern), kern.rows[kept], right=True) - 1
    assert torch.equal(pos_tile[kept], row_tile), "an entry lies outside its tile"
    assert bool((pos_tile[~kept] == T).all()), "an excluded entry lies in a tile"


def _tile_starts(pre):
    """Each tile's first global row (int32, ascending)."""
    import torch

    starts, off = [], 0
    for C, nu in zip(pre.sizes, pre.n_used):
        starts.append(torch.arange(0, nu, pre.tb, dtype=torch.int64) + off)
        off += C
    return torch.cat(starts).to(torch.int32).to(pre.rows.device)


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
    single = _single_rows(rows_l, sizes, n_used)
    offs = [0, sizes[0], sizes[0] + sizes[1]]
    ent_off = [0, M, 2 * M]
    rows_json = []
    dtypes = {"f32": (torch.float32, torch.float32),
              "bf16m": (torch.float32, torch.bfloat16),
              "bf16p": (torch.bfloat16, torch.bfloat16)}
    print(f"[kernels] parent kernel: "
          + ("timed beside the new one" if os.path.exists(os.path.join(PARENT_DIR, "fused_adam.cu"))
             else f"absent ({PARENT_DIR}/fused_adam.cu not present), not timed"))

    # the entry prep (csrc/entry_prep.cu) at the multi-level step's shapes
    tb = ak.tile_rows(D)
    kern_pre = ak.entry_prep(rows_l, sizes, n_used, D)
    torch.cuda.synchronize()
    plain_pre = ak.window_prep(ak.entry_prep_stack_plain([r.reshape(1, -1) for r in rows_l],
                                                         sizes, n_used, tb), 0)
    T = kern_pre.tile_off.shape[0] - 1
    _check_prep(kern_pre, plain_pre, T)
    t_prep = cuda_ms(lambda: ak.entry_prep(rows_l, sizes, n_used, D))
    t_prep_plain = cuda_ms(lambda: ak.entry_prep_stack_plain(
        [r.reshape(1, -1) for r in rows_l], sizes, n_used, tb), iters=5)
    Mt = 3 * M
    bound, by = _bound(12 * Mt + 4 * (T + 1) + 8, 0)
    rows_json.append(dict(name="entry_prep", route="cuda", source=PREP_SOURCE,
                          replaces=PREP_TPU, max_abs_err=0.0, ms=t_prep, plain_ms=t_prep_plain,
                          bound_ms=bound, bound_by=by, library_ms=None))
    print(f"[kernels] prep entry_prep (3 levels, M {Mt}, {T} tiles of {tb} rows, kept "
          f"{int(kern_pre.tile_off[-1])}, dropped {int(kern_pre.dropped)}): tile offsets, "
          f"dropped count and binned pairs equal to plain; kernel {t_prep:.4f} ms (memset + 3 "
          f"launches), plain {t_prep_plain:.4f} ms, library n/a, bound {bound:.4f} ms ({by})")
    del kern_pre, plain_pre

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
            # the plain version with the kernel's noise (philox_noise16): bit-equal
            # on every row with at most one entry
            ref = [[t.clone() for t in lv] for lv in t0]
            plain(ref)
            torch.cuda.synchronize()
            for k in range(3):
                for a, b, s_ in zip(kern[k], ref[k], single):
                    diff = int((a[s_].view(torch.int16) != b[s_].view(torch.int16)).sum())
                    assert diff == 0, f"bf16p: {diff} elements of single-entry rows differ"
            extra = (f"SR mean error {mean:+.2e} ulp (sigma {sigma:.1e}), worst bin "
                     f"{worst:.4f}, moment ties {ties:.1e}, bit-equal to plain with "
                     f"philox_noise16 on single-entry rows, ")
            del exact, again, other, ref
        else:
            ref = [[t.clone() for t in lv] for lv in t0]
            plain(ref)
            torch.cuda.synchronize()
            if variant == "f32":
                err = _check_f32(kern, ref, t0, nu, single=single)
                extra = "bit-equal on single-entry rows, "
            else:
                err = _check_f32(kern[:1], ref[:1], t0[:1], nu, names="p", single=single)
                e2, ties = _check_bf16_ties(kern[1:], ref[1:], t0[1:], nu)
                err = max(err, e2)
                extra = f"p bit-equal on single-entry rows, moment ties {ties:.1e}, "
            del ref
        sizes_l = sizes[:levels]
        pre = ak.entry_prep(rl, sizes_l, nu, D)
        t_wrap = cuda_ms(lambda: wrapper(kern))
        t_pre = cuda_ms(lambda: wrapper(kern, pre=pre))
        lrs = [lr * s for s in sc]
        seed = kw.get("sr_seed", 0)

        def new():
            ak._launch(variant, *kern, gl, ent_off[:levels], pre, nu, offs[:levels], lrs,
                       0.9, 0.99, bc1, bc2, 1e-15, kw["grads_bf16"], seed)

        parent = _parent_lib()
        t_parent = None
        if parent is not None:
            def old(ts=kern):
                ak._launch(variant, *ts, gl, ent_off[:levels], pre, nu, offs[:levels], lrs,
                           0.9, 0.99, bc1, bc2, 1e-15, kw["grads_bf16"], seed, lib=parent)

            t_parent, t_kern = _in_turns(old, new)
            if variant == "bf16p":  # the same keying: the same bits, but where the two
                # kernels' f32 p_new differ by an ulp and the noise lands between
                a = [[t.clone() for t in lv] for lv in t0]
                b = [[t.clone() for t in lv] for lv in t0]
                old(a)
                ak._launch(variant, *b, gl, ent_off[:levels], pre, nu, offs[:levels], lrs,
                           0.9, 0.99, bc1, bc2, 1e-15, True, seed)
                torch.cuda.synchronize()
                same = sum(int((x[s_].view(torch.int16) == y[s_].view(torch.int16)).sum())
                           for x, y, s_ in zip(a[0], b[0], single))
                total = sum(int(s_.sum()) * D for s_ in single[:levels])
                assert same >= 0.999 * total, f"parent vs new SR bits: {same} of {total} equal"
                extra += f"SR bits as the parent's on {same / total:.6f} of single-entry rows, "
                del a, b
        else:
            t_kern = cuda_ms(new)
        scratch = [[t.clone() for t in lv] for lv in t0]
        t_plain = cuda_ms(lambda: plain(scratch), iters=5)
        t_lib = _library_ms(t0[0], rl, gl, nu, lrs) if variant == "f32" else None
        pb, mb = (t.itemsize for t in dtypes[variant])
        bound, by = _bound_ms(nu, levels * M, D, pb, mb, sr=variant == "bf16p")
        rows_json.append(dict(name=name, route="cuda", source=SOURCE,
                              replaces=K2_TPU if multi else K1_TPU, variant=variant,
                              max_abs_err=err, ms=t_wrap, ms_with_pre=t_pre,
                              kernel_only_ms=t_kern, parent_kernel_ms=t_parent,
                              plain_ms=t_plain, bound_ms=bound, bound_by=by, library_ms=t_lib))
        lib = "n/a" if t_lib is None else f"{t_lib:.4f} ms"
        par = "" if t_parent is None else f"parent kernel {t_parent:.4f} ms (in turns), "
        print(f"[kernels] {'K2' if multi else 'K1'} {name} ({levels} level(s), used rows {nu}, "
              f"M {levels * M}): max_abs_err {err:.3e}, {extra}wrapper {t_wrap:.4f} ms, "
              f"with pre {t_pre:.4f} ms, kernel alone {t_kern:.4f} ms, {par}plain "
              f"{t_plain:.4f} ms, library {lib}, bound {bound:.4f} ms ({by}), "
              f"{bound / t_kern:.0%} of bound")
        del kern, scratch, pre
        torch.cuda.empty_cache()

    case("f32", 1)
    case("f32", 3)
    case("bf16m", 1)
    case("bf16m", 3)
    case("bf16p", 3)
    del tabs0
    torch.cuda.empty_cache()
    return rows_json


# ----------------------------------------------------------------- phase 2b

# the kernel-study kernels: JSON name -> (kernel, TPU kernel it replaces,
# route, source)
_ONEHOT_SRC = "shine_mapping_tpu_torch/csrc/onehot_adam.cu"
STUDY_KERNELS = {
    "fused_adam_onehot": ("K3", "experiments/exp_fused_adam.py:58", "cuda", _ONEHOT_SRC),
    **{f"fused_adam_onehot_{v}": ("K4", "experiments/exp_pallas_debug.py:41", "cuda",
                                  _ONEHOT_SRC)
       for v in ("copy", "sweep", "window", "onehot", "dot_bf16", "dot_hi")},
    **{f"fused_adam_onehot_copy_{c}": ("K5", "experiments/exp_pallas_trainer.py:310", "cuda",
                                       _ONEHOT_SRC) for c in ("f32", "bf16")},
    "sweep": ("K6", "experiments/exp_narrow_blocks.py:18", "triton",
              "shine_mapping_tpu_torch/csrc/sweep_triton.py"),
    "tile_rmw": ("K7", "experiments/pallas_tile_rmw.py:29", "cuda",
                 "shine_mapping_tpu_torch/csrc/tile_rmw.cu"),
}
ADAM_FLOPS = 15  # f32 operations per table element of one Adam step


def _bound(nbytes, flops):
    """Least time: the bytes over the card's memory rate or the operations
    over its f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _adam_library_ms(C, D, lr, rows=None, grads=None):
    """Yardstick only, never called by the port: torch.optim.Adam(fused=True)
    on a (C, D) table, its gradient index_add_-ed from the entries into a
    dense one, or held at zero when none are given (K4's g = 0 variants).
    Returns (ms of back-to-back calls, ms alone by graph replay)."""
    import torch

    q = torch.zeros((C, D), device=DEVICE, requires_grad=True)
    opt = torch.optim.Adam([q], lr=lr, betas=(0.9, 0.99), eps=1e-15, fused=True,
                           capturable=True)
    if rows is None:
        q.grad = torch.zeros_like(q)
        return cuda_ms(opt.step), graph_ms(opt.step)
    rows_l = rows.long()

    def step():
        q.grad = torch.zeros_like(q).index_add_(0, rows_l, grads)
        opt.step()

    return cuda_ms(step), graph_ms(step)


def _library_times(fn):
    """(ms of back-to-back calls, ms alone by graph replay) of a library call."""
    return cuda_ms(fn), graph_ms(fn)


def _study_parents():
    """Per study source, the ctypes entry of the parent commit's copy when
    it was put in PARENT_DIR (git-ignored), else None."""
    from shine_mapping_tpu_torch.ops import cuda_build
    from shine_mapping_tpu_torch.ops import onehot_adam as oa
    from shine_mapping_tpu_torch.ops import tile_rmw as tr

    out = {}
    for name, mod in (("onehot_adam", oa), ("tile_rmw", tr)):
        here = os.path.exists(os.path.join(PARENT_DIR, f"{name}.cu"))
        out[name] = mod.c_entry(cuda_build.load(name, PARENT_DIR, PARENT_DIR)) if here else None
        print(f"[kernels] parent {name}.cu: " + ("timed beside the new one" if here else
              f"absent ({PARENT_DIR}/{name}.cu not present), not timed"))
    return out


def _kernel_times(launch, parent):
    """(kernel alone, the parent's kernel alone or None), by graph replay,
    in turns when the parent is there; ``launch(fn)`` launches with the
    entry ``fn`` (None: this commit's)."""
    if parent is None:
        return graph_ms(launch), None
    t_parent, t_kern = _in_turns(lambda: launch(parent), launch, graph_ms)
    return t_kern, t_parent


def _drive_study(extra=()):
    """The kernel-study path: the five programs of
    shine_mapping_tpu_torch.experiments at their bench shapes, depth cut to
    5 chained calls per timing."""
    import importlib

    cut = ["--iters", "5", "--reps", "1", "--device", DEVICE, *extra]
    runs = (("exp_fused_adam", cut), ("exp_pallas_debug", cut + [
                "--variants", "copy,sweep,window,onehot,dot_bf16,dot_hi"]),
            ("exp_pallas_trainer", cut), ("exp_narrow_blocks", cut),
            ("pallas_tile_rmw", cut))
    for name, argv in runs:
        mod = importlib.import_module(f"shine_mapping_tpu_torch.experiments.{name}")
        assert mod.main(argv) == 0, f"{name} failed"


def phase_study(C=1 << 22, M=65536, T=262144, N=32768, drive_args=()):
    """Each kernel-study kernel (K3-K7) and variant against its plain
    version at the study scripts' bench shapes, with its times (wrapper,
    kernel alone, the parent's kernel in turns, K7 also with a cold L2) and
    bound; then the study programs, launch counts zeroed before and read
    after."""
    import numpy as np
    import torch

    from shine_mapping_tpu_torch.ops import onehot_adam as oa
    from shine_mapping_tpu_torch.ops import sweep as sw
    from shine_mapping_tpu_torch.ops import tile_rmw as tr

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(3)
    D = 8
    E = C * D  # table elements
    R = E // 128
    parents = _study_parents()
    par_oa = parents["onehot_adam"]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    base = [t(rng.normal(0, 1, (C, D)).astype(np.float32)),
            t(rng.normal(0, 1e-3, (C, D)).astype(np.float32)),
            t(np.abs(rng.normal(0, 1e-4, (C, D))).astype(np.float32))]
    rows = t(np.sort(rng.integers(0, C - 1, M)).astype(np.int32))
    grads = t(rng.normal(0, 1e-3, (M, D)).astype(np.float32))
    lr, bc1, bc2 = 0.01, 1 - 0.9 ** 5, 1 - 0.99 ** 5
    scal = torch.tensor([lr, bc1, bc2, 0.0], device=dev)
    lib_adam = _adam_library_ms(C, D, lr, rows, grads)
    lib_zero = _adam_library_ms(C, D, lr)
    out = []

    def record(name, err, ms, t_kern, t_parent, plain_ms, nbytes, flops, lib, note="",
               **extra):
        """One JSON row and its [kernels] line; ``lib`` is (call ms, alone
        ms) or None."""
        kernel, tpu, route, source = STUDY_KERNELS[name]
        bound, by = _bound(nbytes, flops)
        lib_ms, lib_kern = (None, None) if lib is None else lib
        out.append(dict(name=name, route=route, source=source, replaces=tpu,
                        max_abs_err=err, ms=ms, kernel_only_ms=t_kern,
                        parent_kernel_ms=t_parent, plain_ms=plain_ms, bound_ms=bound,
                        bound_by=by, library_ms=lib_ms, library_kernel_ms=lib_kern, **extra))
        lib_s = "n/a" if lib is None else f"{lib_ms:.4f} ms (alone {lib_kern:.4f} ms)"
        par = ("parent absent" if t_parent is None
               else f"parent kernel {t_parent:.4f} ms (in turns)")
        print(f"[kernels] {kernel} {name}: max_abs_err {err:.3e}, {note}wrapper {ms:.4f} ms, "
              f"kernel alone {t_kern:.4f} ms, {par}, plain {plain_ms:.4f} ms, library "
              f"{lib_s}, bound {bound:.4f} ms ({by}), {bound / t_kern:.0%} of bound")

    def check(kern, plain):
        """p, m, v as phase 2 holds them (tolerance by each table's scale,
        each moved)."""
        return _check_f32([[a.reshape(C, D)] for a in kern],
                          [[b.reshape(C, D)] for b in plain], [[x] for x in base], [C])

    # K3: the (tb, w) sweep of exp_fused_adam.py; its first tiling in the JSON
    prow = (rows // oa.PACK).to(torch.int32)
    for tb, w in ((256, 256), (128, 128), (512, 512), (256, 512)):
        kern = oa.fused_adam_onehot(*base, rows, grads, lr, bc1, bc2, tb, w)
        torch.cuda.synchronize()
        plain = oa.fused_adam_onehot_plain(*base, rows, grads, lr, bc1, bc2, tb, w)
        err = check(kern, plain)
        Mpad = oa.padded_len(M, w)
        offs = oa.window_offsets(prow, R // tb, tb, w, Mpad)
        ok = bool(oa.windows_ok(prow, offs, tb, w))
        ms = cuda_ms(lambda: oa.fused_adam_onehot(*base, rows, grads, lr, bc1, bc2, tb, w))
        if (tb, w) != (256, 256):
            print(f"[study] K3 tb={tb} w={w}: max_abs_err {err:.3e}, windows_ok {ok}, "
                  f"wrapper {ms:.4f} ms")
            continue
        outs = [torch.empty_like(x) for x in base]
        t_kern, t_parent = _kernel_times(
            lambda fn=None: oa._launch(oa._MODE["narrow"], 0, *base, *outs, None, rows, grads,
                                       None, offs, None, lr, bc1, bc2, R // tb, tb, w, M,
                                       0.9, 0.99, 1e-15, fn=fn), par_oa)
        t_plain = cuda_ms(lambda: oa.fused_adam_onehot_plain(*base, rows, grads, lr, bc1, bc2,
                                                             tb, w), iters=5)
        record("fused_adam_onehot", err, ms, t_kern, t_parent, t_plain, 24 * E + 36 * M,
               ADAM_FLOPS * E, lib_adam, f"windows_ok {ok}, tb {tb} w {w}, ", windows_ok=ok)
        del outs
    del kern, plain

    # K4: the six variants of exp_pallas_debug.py at TB 256, W 256
    tb, w = 256, 256
    win = oa.window_inputs(rows, grads, C, tb, w)
    Mpad = win[0].shape[1]
    ok = bool(oa.windows_ok(prow, win[3], tb, w))
    lanes_bytes = 4 * Mpad * 128 + 4 * Mpad + 4 * (R // tb)  # hi + lo, prow_p, offs
    for variant in oa.VARIANTS:
        kern = oa.fused_adam_onehot_variant(*base, *win, scal, tb, w, variant)
        torch.cuda.synchronize()
        plain = oa.fused_adam_onehot_variant_plain(*base, *win, scal, tb, w, variant)
        if variant == "copy":
            for a, b, x in zip(kern, plain, base):
                assert torch.equal(a, x) and torch.equal(b, x), "copy changed a table"
            err = 0.0
        else:
            err = check(kern, plain)
        del plain
        ms = cuda_ms(lambda: oa.fused_adam_onehot_variant(*base, *win, scal, tb, w, variant))

        def launch(fn=None):
            oa._launch(oa._MODE[variant], 0, *base, *kern, None, *win, scal, 0.0, 1.0, 1.0,
                       R // tb, tb, w, Mpad, oa.B1, oa.B2, oa.EPS, fn=fn)

        t_kern, t_parent = _kernel_times(launch, par_oa)
        t_plain = cuda_ms(lambda: oa.fused_adam_onehot_variant_plain(*base, *win, scal, tb, w,
                                                                     variant), iters=5)
        dot = variant.startswith("dot")
        # library: the entries' step for the dot variants, a zero-gradient
        # step for the g = 0 ones, and for copy torch.stack, whose three
        # slices are fresh copies of p, m and v; it is within a few percent
        # of the kernel, so it is timed alone in turns with it
        lib, note = (lib_adam if dot else lib_zero), ""
        if variant == "copy":
            t_stack, t_beside = _in_turns(lambda: torch.stack(base), launch, graph_ms)
            lib = (cuda_ms(lambda: torch.stack(base)), t_stack)
            note = f"kernel alone {t_beside:.4f} ms in turns with torch.stack, "
        del kern
        record(f"fused_adam_onehot_{variant}", err, ms, t_kern, t_parent, t_plain,
               24 * E + (lanes_bytes if dot else 0), 0 if variant == "copy" else ADAM_FLOPS * E,
               lib, f"windows_ok {ok}, {note}", windows_ok=ok)
        torch.cuda.empty_cache()
    del win

    # K5: exp_pallas_trainer.main2's update at choose_tiles, both copy types
    tb, w = oa.choose_tiles(C, D, M)
    win = oa.window_inputs(rows, grads, C, tb, w)
    Mpad = win[0].shape[1]
    ok = bool(oa.windows_ok(prow, win[3], tb, w))
    lanes_bytes = 4 * Mpad * 128 + 4 * Mpad + 4 * (R // tb)
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        kern = [x.clone().view(R, 128) for x in base]
        plain = [x.clone().view(R, 128) for x in base]
        pc = oa.fused_adam_onehot_copy(*kern, *win, scal, tb, w, dt)[3]
        torch.cuda.synchronize()
        oa.fused_adam_onehot_copy_plain(*plain, *win, scal, tb, w, dt)
        err = check(kern, plain)
        assert pc.dtype == dt and torch.equal(pc, kern[0].to(dt)), "pc is not the new p"
        ms = cuda_ms(lambda: oa.fused_adam_onehot_copy(*kern, *win, scal, tb, w, dt))
        t_kern, t_parent = _kernel_times(
            lambda fn=None: oa._launch(oa._MODE["dot_bf16"], oa._COPY[dt], *kern, *kern, pc,
                                       *win, scal, 0.0, 1.0, 1.0, R // tb, tb, w, Mpad, oa.B1,
                                       oa.B2, oa.EPS, fn=fn), par_oa)
        t_plain = cuda_ms(lambda: oa.fused_adam_onehot_copy_plain(*plain, *win, scal, tb, w,
                                                                  dt), iters=5)
        record(f"fused_adam_onehot_copy_{name}", err, ms, t_kern, t_parent, t_plain,
               24 * E + E * pc.element_size() + lanes_bytes, ADAM_FLOPS * E, lib_adam,
               f"windows_ok {ok}, tb {tb} w {w}, pc == p_new.to({name}), ", windows_ok=ok)
        del kern, plain, pc
        torch.cuda.empty_cache()
    del win, base

    # K6: the narrow-block sweep, Triton (no parent: its source is unchanged)
    x = t(rng.normal(0, 100, (C, D)).astype(np.float32))
    t0 = time.perf_counter()
    y = sw.sweep(x)
    torch.cuda.synchronize()
    t_jit = time.perf_counter() - t0
    assert torch.equal(y, sw.sweep_plain(x)), "sweep differs from its plain version"
    one = torch.ones((), device=dev)
    record("sweep", 0.0, cuda_ms(lambda: sw.sweep(x)), graph_ms(lambda: sw.sweep(x)), None,
           cuda_ms(lambda: sw.sweep_plain(x)), 8 * E, 2 * E,
           _library_times(lambda: torch.add(one, x, alpha=0.5)),
           f"bit-equal, Triton compile + first call {t_jit:.2f} s, ")
    del x, y

    # K7: the tile read-modify-write of pallas_tile_rmw.py; its data (34 MB)
    # fits the L2, so it is timed warm (repeated launches) and cold
    table = t(rng.standard_normal((T, 128)).astype(np.float32))
    tiles = t(np.sort(rng.choice(T, N, replace=False)).astype(np.int32))
    deltas = t(rng.standard_normal((N, 128)).astype(np.float32))
    kern = tr.tile_rmw(table.clone(), tiles, deltas)
    torch.cuda.synchronize()
    assert torch.equal(kern, tr.tile_rmw_plain(table.clone(), tiles, deltas)), \
        "tile_rmw differs from its plain version"
    rows_l = tiles.long()

    def rmw(fn=None):
        tr.launch(kern, tiles, deltas, fn)

    def lib7():
        kern.index_add_(0, rows_l, deltas)

    t_kern, t_parent = _kernel_times(rmw, parents["tile_rmw"])
    if parents["tile_rmw"] is None:
        t_cold, t_parent_cold = cold_ms(rmw), None
    else:
        t_parent_cold, t_cold = _in_turns(lambda: rmw(parents["tile_rmw"]), rmw, cold_ms)
    t_lib_cold = cold_ms(lib7)
    nbytes = N * (4 + 3 * 512)
    bound, _ = _bound(nbytes, N * 128)
    par = "" if t_parent_cold is None else f"parent {t_parent_cold:.4f} ms (in turns), "
    record("tile_rmw", 0.0, cuda_ms(lambda: tr.tile_rmw(kern, tiles, deltas)), t_kern,
           t_parent, cuda_ms(lambda: tr.tile_rmw_plain(kern, tiles, deltas)), nbytes,
           N * 128, _library_times(lib7),
           f"bit-equal, cold L2: kernel alone {t_cold:.4f} ms ({bound / t_cold:.0%} of "
           f"bound), {par}index_add_ {t_lib_cold:.4f} ms; warm (L2-resident, against the "
           f"same DRAM bound): ", cold_ms=t_cold, parent_cold_ms=t_parent_cold,
           library_cold_ms=t_lib_cold)
    del table, kern, deltas
    torch.cuda.empty_cache()

    for mod in (oa, sw, tr):
        mod.reset_launch_counts()  # the kernel-study path starts here
    t0 = time.perf_counter()
    _drive_study(drive_args)
    counts = {**oa.LAUNCHES, **sw.LAUNCHES, **tr.LAUNCHES}  # read right after the path
    print(f"[study] the five study programs ran in {time.perf_counter() - t0:.1f} s; "
          f"launches {counts}")
    for r in out:
        r["launches"] = counts[r["name"]]
    torch.cuda.empty_cache()
    return out


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
        # the entry prep: live before every update launch, or once per
        # windows build (per prep of the layout)
        preps = steps * per_step if windows is None else (1 if windows == "fused" else 3)
        assert counts["entry_prep"] == preps, \
            f"entry_prep: {counts['entry_prep']} launches, want {preps}"
        others = {k: n for k, n in counts.items() if k not in (key, "entry_prep") and n}
        assert not others, f"other kernels launched during the {label} run: {others}"
        for k in (key, "entry_prep"):
            launches[k] = launches.get(k, 0) + counts[k]
        runs[key] = params
        fixed_loss[label] = after
        beside = ""
        if pbf:
            beside = (f" (f32 on the same windows: {fixed_loss['f32, fused windows (K2)']:.6f}, "
                      f"f32 on iid batches: {fixed_loss['multi-level (K2)']:.6f})")
        win_s = f", windows built in {t_win:.3f} s" if windows else ""
        print(f"[train] {label}: {steps} steps, {counts[key]} launches (entry_prep "
              f"{counts['entry_prep']}), fixed-sample loss "
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


# (label, settings, pool fields, a shadow for the reg, windows layout)
OPTION_CASES = (
    ("sparse lazy Adam", dict(feature_update="sparse"), (), False, None),
    ("sparse lazy Adam + continual reg",
     dict(feature_update="sparse", continual_reg_on=True, lambda_forget=1e3), (), True, None),
    ("semantic head, K1 on iid batches", dict(semantic_on=True), ("sem",), False, None),
    ("semantic head, K2 with bf16 moments on fused windows", dict(semantic_on=True),
     ("sem",), False, "fused"),
    ("consistency, K1 with near-point entries", dict(consistency_loss_on=True), (), False,
     None),
    ("normal + projective correction + sdf_l1",
     dict(normal_loss_on=True, proj_correction_on=True, main_loss_type="sdf_l1"),
     ("normal",), False, None),
    ("dr_neus on a ray pool", dict(ray_loss=True, main_loss_type="dr_neus"), ("ray",), False,
     None),
    ("time-conditioned decoder", dict(time_conditioned=True), ("time",), False, None),
    ("dense autodiff Adam", dict(feature_update="dense"), (), False, None),
    ("SGD", dict(opt_adam=False), (), False, None),
)


class _KernelCheck:
    """While active, every K1 (``fused_adam``) and K2 (``fused_adam_multi``)
    launch on CUDA tensors is held against its plain version on the same
    inputs: phase 2's tolerance plus each element's sum-order spread
    (:func:`_sum_order_spread`, the card's atomics sum a row's entries in no
    fixed order), bit-equal on rows with at most one entry, headroom
    untouched; bf16 moments bit-equal but for TIE_SHARE one-ulp ties."""

    def __init__(self):
        from shine_mapping_tpu_torch.ops import adam_kernel as ak

        self.ak, self.n, self.err = ak, 0, 0.0
        self.inner = (ak.fused_adam, ak.fused_adam_multi)

    def __enter__(self):
        ak, (k1, k2) = self.ak, self.inner

        def one(p, m, v, rows, grads, lr, bc1, bc2, n_used=None, **kw):
            return self._check([p], [m], [v], [rows], [grads], lr, bc1, bc2, [1.0],
                               [p.shape[0] if n_used is None else n_used], kw,
                               lambda: k1(p, m, v, rows, grads, lr, bc1, bc2, n_used, **kw))

        def multi(ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales, n_used=None, **kw):
            nu = [p.shape[0] for p in ps] if n_used is None else list(n_used)
            return self._check(ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales, nu, kw,
                               lambda: k2(ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales,
                                          n_used, **kw))

        ak.fused_adam, ak.fused_adam_multi = one, multi
        return self

    def __exit__(self, *exc):
        self.ak.fused_adam, self.ak.fused_adam_multi = self.inner

    def _check(self, ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales, n_used, kw, launch):
        import torch

        ak = self.ak
        if ps[0].device.type != "cuda":
            return launch()
        t0 = [[x.clone() for x in tabs] for tabs in (ps, ms, vs)]
        plain = [[x.clone() for x in tabs] for tabs in (ps, ms, vs)]
        ak.fused_adam_multi_plain(*plain, rows_l, g_l, lr, bc1, bc2, lr_scales, n_used, **kw)
        dropped = launch()
        assert not int(dropped), "entries dropped"
        sizes = [p.shape[0] for p in ps]
        single = _single_rows([r.reshape(-1) for r in rows_l], sizes, n_used)
        step = {k: kw[k] for k in ("eps", "grads_bf16") if k in kw}
        spread = [[], [], []]
        for l in range(len(ps)):
            sp = _sum_order_spread([t0[0][l], t0[1][l].float(), t0[2][l].float()], rows_l[l],
                                   g_l[l], lr * lr_scales[l], bc1, bc2, n_used[l], **step)
            for t in range(3):
                spread[t].append(sp[t][0])
        if ms[0].dtype == torch.bfloat16:
            _check_f32([ps], [plain[0]], [t0[0]], n_used, names="p", single=single,
                       moved_share=None, scale_of="after", spread=[spread[0]])
            _check_bf16_ties([ms, vs], plain[1:], t0[1:], n_used, moved_share=None)
        else:
            _check_f32([ps, ms, vs], plain, t0, n_used, single=single, moved_share=None,
                       scale_of="after", spread=spread)
        for a, b in zip(ps, plain[0]):
            self.err = max(self.err, float((a.float() - b.float()).abs().max())
                           / max(float(b.float().abs().max()), 1e-30))
        self.n += 1
        return dropped


def _option_world(fields, n=4000, S=7):
    """phase_agreement's sphere pool with the fields a case reads: class
    labels by height (building above z = 0, road below), outward normals,
    origins at the centre, timestamps 0-4; ``ray``: a ray-major pool of
    n / 4 rays of S samples each."""
    import numpy as np

    from shine_mapping_tpu_torch.data.dataset import SamplePool

    rng = np.random.default_rng(2)
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    if "ray" in fields:
        R = n // 4
        ratios = np.sort(rng.uniform(0.3, 1.1, (R, S)), axis=1)
        coord = (dirs[:R, None, :] * (ratios * 0.5)[:, :, None]).reshape(-1, 3)
        return SamplePool(coord=coord.astype(np.float32),
                          sdf_label=np.zeros(R * S, np.float32),
                          weight=np.ones(R * S, np.float32),
                          sample_depth=(ratios * 0.5).reshape(-1).astype(np.float32),
                          ray_depth=np.full(R, 0.5, np.float32),
                          origin=np.zeros((R * S, 3), np.float32),
                          time=np.zeros(R * S, np.float32)), dirs * 0.5
    disp = rng.uniform(-0.04, 0.04, (n, 1))
    surf = dirs * (0.5 + disp)
    free = dirs * rng.uniform(0.2, 0.45, (n, 1))
    coord = np.concatenate([surf, free]).astype(np.float32)
    pool = SamplePool(
        coord=coord,
        sdf_label=np.concatenate([disp[:, 0], np.linalg.norm(free, axis=1) - 0.5]
                                 ).astype(np.float32),
        weight=np.concatenate([np.ones(n), -np.ones(n)]).astype(np.float32),
        origin=np.zeros((2 * n, 3), np.float32),
        time=(rng.integers(0, 5, 2 * n).astype(np.float32) if "time" in fields
              else np.zeros(2 * n, np.float32)))
    if "sem" in fields:
        pool.sem_label = np.where(coord[:, 2] > 0, 13, 9).astype(np.int32)
    if "normal" in fields:
        pool.normal_label = (coord / np.linalg.norm(coord, axis=1, keepdims=True)
                             ).astype(np.float32)
    return pool, surf


def phase_agreement_options(steps=20, cases=OPTION_CASES):
    """Phase 5's second half: the trainer's other update modes and loss
    terms on the card against the CPU (plain versions), from the same
    weights on the same batches (and near points), at adam_eps 1e-3:
    loss rtol 1e-4, f32 parameters, moments and decoders rtol 1e-4, atol
    1e-5 (under the reg the moments' atol is also 1e-6 of each table's
    largest: they sum large terms of both signs, as in phase 7); bf16
    moments as phase_agreement holds them.  The consistency case runs
    ``steps // 4`` steps: its loss, 1 - cos of two point gradients through
    second derivatives, carries float rounding on tenfold every few steps
    (scripts/consistency_spread.py on an NVIDIA H100 80GB HBM3: the card
    against itself from the same start 1.5e-8, 1e-7 and 1.2e-6 of p after
    1, 5 and 20 steps, against the CPU 1.8e-7, 5.3e-7 and 8.9e-6, where the
    plain, eikonal and dense cases stay within 2.3e-8 after 20; from
    another start this check at 20 steps found 1.6 % of p past rtol 1e-4),
    and within 5 steps it holds to the same tolerance as the others.  Every K1 / K2 launch of the
    semantic and consistency cases is held against its plain version
    (:class:`_KernelCheck`)."""
    import copy

    import numpy as np
    import torch

    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.ops import adam_kernel as ak
    from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.optimizer import init_opt_state

    checked = {}
    for label, over, fields, reg, layout in cases:
        pool, surf = _option_world(fields)
        cfg = SHINEConfig()
        cfg.tree_level_world, cfg.tree_level_feat, cfg.bs, cfg.lr = 7, 3, 1024, 0.01
        cfg.adam_eps = 1e-3
        cfg.time_conditioned = over.get("time_conditioned", False)
        if "ray" in fields:
            cfg.bs, cfg.surface_sample_n, cfg.free_sample_n, cfg.clearance_sample_n = 128, 5, 2, 0
        cfg.derive()
        n_steps = steps // 4 if over.get("consistency_loss_on") else steps
        rng = np.random.default_rng(7)
        B = cfg.bs * (7 if "ray" in fields else 1)
        hi = len(pool) // 7 if "ray" in fields else len(pool)
        kw0 = {"batch_indices": torch.from_numpy(rng.integers(0, hi, (n_steps, cfg.bs)))}
        if over.get("consistency_loss_on"):
            cnt = min(cfg.consistency_count, B)
            r = cfg.consistency_range * cfg.scale
            kw0["near_indices"] = torch.from_numpy(rng.integers(0, B, (n_steps, cnt)))
            kw0["near_shifts"] = torch.from_numpy(
                rng.uniform(-r, r, (n_steps, cnt, 3)).astype(np.float32))
        out, init = {}, None
        for device in ("cpu", DEVICE):
            grid = HashGridHost(7, 3, 8, 0.05, seed=3, init_node_capacity=1 << 12,
                                init_corner_capacity=1 << 12, device=device)
            grid.update(surf)
            s = trainer.TrainSettings.from_config(
                cfg, grid.levels, sigma_sigmoid=0.05,
                **dict(dict(feature_update="pallas", n_used=trainer.used_rows_for(grid)),
                       **over))
            params = trainer.init_params(cfg, grid, torch.Generator(device).manual_seed(0))
            if init is None:  # the CPU run's initial decoders, for both runs
                init = {k: copy.deepcopy(params[k].state_dict()) for k in ("geo", "sem")}
            for k in ("geo", "sem"):
                params[k].load_state_dict(init[k])
            opt = init_opt_state(params, moments_bf16=layout is not None)
            dev, nv = trainer.pool_to_device(pool, len(pool), device=device, settings=s)
            kw = dict(kw0)
            if reg:
                g = torch.Generator().manual_seed(5)
                kw["shadow"] = {
                    "importance": [torch.rand(f.shape, generator=g).to(device)
                                   for f in params["features"]],
                    "last_frame": [(f.cpu() + 0.01 * torch.randn(f.shape, generator=g)).to(device)
                                   for f in params["features"]]}
            if layout is not None:
                pre = trainer.precompute_pool_lookups(grid.tables, dev["coord"], grid.levels,
                                                      [f.shape[0] for f in grid.features])
                widx = torch.randperm(nv, generator=torch.Generator().manual_seed(4))
                widx = widx[: (nv // cfg.bs) * cfg.bs].reshape(-1, cfg.bs)
                win = trainer.precompute_batch_windows(
                    pre, nv, None, s, [tuple(f.shape) for f in params["features"]],
                    fused=True, window_indices=widx)
                kw = dict(pre_lookups=pre, batch_windows=win)
            check = _KernelCheck()
            ak.reset_launch_counts()
            t0 = time.perf_counter()
            with check:
                params, opt, aux = trainer.train_chunk(params, opt, grid.tables, dev, nv, 0,
                                                       None, s, n_steps, **kw)
            if device != "cpu":
                torch.cuda.synchronize()
            out[device] = (params, opt, {k: float(v) for k, v in aux["mean"].items()},
                           time.perf_counter() - t0, dict(ak.LAUNCHES), check)
        (pc, oc, ac, tc, lc, kc), (pp, op, ap, tp, _, _) = out[DEVICE], out["cpu"]
        for k in ap:
            np.testing.assert_allclose(ac[k], ap[k], rtol=1e-4, err_msg=f"{label}: {k}")
        for a, b in zip(pc["features"], pp["features"]):
            a = a.cpu()
            if layout is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=2e-4)
                share = float(torch.isclose(a, b, rtol=1e-4, atol=1e-5).float().mean())
                assert share >= 0.999, f"{label}: only {share:.5f} of p agree"
            else:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        if layout is None:
            for name in ("m", "v"):
                for a, b in zip(getattr(oc, name)["features"], getattr(op, name)["features"]):
                    atol = max(1e-5, 1e-6 * float(b.abs().max())) if reg else 1e-5
                    torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=atol)
        dtol = dict(rtol=1e-3, atol=1e-5) if layout is not None else dict(rtol=1e-4, atol=1e-5)
        for grp in ("geo", "sem"):
            for k, b in pp[grp].state_dict().items():
                torch.testing.assert_close(pc[grp].state_dict()[k].cpu(), b, **dtol)
        torch.testing.assert_close(pc["sigma"].detach().cpu(), pp["sigma"].detach(),
                                   rtol=1e-4, atol=1e-5)
        kernels = {k: n for k, n in lc.items() if n}
        if over.get("feature_update") in ("sparse", "dense") or not over.get("opt_adam", True):
            assert not kernels, f"{label}: kernels launched: {kernels}"
        if (over.get("semantic_on") or over.get("consistency_loss_on")) and DEVICE != "cpu":
            assert kc.n == n_steps * (1 if layout else 3), f"{label}: {kc.n} launches checked"
            checked[label] = (kc.n, kc.err)
        print(f"[agreement] {label}, {n_steps} steps: card loss {ac['total_loss']:.6f} vs CPU "
              f"{ap['total_loss']:.6f} (" + ", ".join(f"{k} {ac[k]:.5g}" for k in ac
                                                      if k != "total_loss")
              + f"); parameters agree; card {tc:.2f} s, CPU {tp:.2f} s; launches {kernels}"
              + (f"; {kc.n} kernel launches held against their plain versions, max |d p| "
                 f"{kc.err:.3e} of each table's largest" if kc.n else ""))
    return checked


# ----------------------------------------------------------------- phase 6


# Chamfer-L1 (m) under, F-score (%) over: the bars the JAX package holds its
# batch driver to on this scene (tests/test_e2e.py::test_batch_driver_end_to_end)
MAP_BARS = (0.15, 75.0)
# an eval of tests/test_e2e.py's parameters
EVAL_KW = dict(down_sample_res=0.05, threshold=0.2, truncation_acc=0.4, truncation_com=2.0,
               mesh_sample_point=300_000)


def _load_tests_module(name):
    """A numpy-only module of tests/ by its path (a package named ``tests``
    elsewhere on the path must not shadow it)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_synth_sequence(root, n_frames=20, n_az=1024, n_el=64, seed=0):
    """tests/synth.py's analytic world (a ground plane and a sphere) in KITTI
    layout, as ``make_kitti_dataset`` writes it but at a 64-beam x
    1024-azimuth scan: ``n_frames`` poses 1 m apart along +x at 1.5 m
    height; and its exact ground-truth surface (200k points) as gt.ply.
    Returns (the scans' point count, gt.ply's path)."""
    import numpy as np

    from shine_mapping_tpu_torch.data import io

    synth = _load_tests_module("synth")
    rng = np.random.default_rng(seed)
    pc_dir = os.path.join(root, "velodyne")
    os.makedirs(pc_dir, exist_ok=True)
    poses, n_pts = [], 0
    for i in range(n_frames):
        T = np.eye(4)
        T[:3, 3] = [i * 1.0, 0.0, 1.5]
        poses.append(T)
        pts = synth.simulate_scan(T, n_az=n_az, n_el=n_el, rng=rng).astype(np.float32)
        n_pts += len(pts)
        np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1).tofile(
            os.path.join(pc_dir, f"{i:06d}.bin"))
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write("Tr: " + " ".join(str(v) for v in np.eye(4)[:3].reshape(-1)) + "\n")
    with open(os.path.join(root, "poses.txt"), "w") as f:
        for T in poses:
            f.write(" ".join(str(v) for v in T[:3].reshape(-1)) + "\n")
    gt_path = os.path.join(root, "gt.ply")
    io.write_ply(gt_path, io.PointCloud(points=synth.gt_surface_points(200_000)))
    return n_pts, gt_path


def _map_config(root, out, iters, **tpu):
    """The ICRA MaiCity batch config at its full width, on the synthetic
    world: only the data paths, the output root, the depth (iters) and the
    checkpoint / mesh cadence (= iters) change, and the ``tpu:`` knobs."""
    from shine_mapping_tpu_torch.config import SHINEConfig

    cfg = SHINEConfig().load(ICRA_CONFIG)
    cut = {"iters": iters, "vis_freq_iters": iters, "save_freq_iters": iters}
    print(f"[map] reduced: " + ", ".join(f"{k} {getattr(cfg, k)} -> {v}" for k, v in cut.items())
          + "; data paths and output_root: the synthetic world"
          + (f"; tpu: {tpu}" if tpu else ""))
    cfg.pc_path = os.path.join(root, "velodyne")
    cfg.pose_path = os.path.join(root, "poses.txt")
    cfg.calib_path = os.path.join(root, "calib.txt")
    cfg.output_root, cfg.device = out, DEVICE
    for k, v in {**cut, **tpu}.items():
        setattr(cfg, k, v)
    return cfg


def _map_run(label, cfg, gt_path, launch_key, per_step, preps):
    """One run of the port's batch CLI in this process, launch counts zeroed
    just before it and read just after; then its final mesh scored against
    the ground truth and held to MAP_BARS.  Returns (run_path, grid,
    params, launch counts)."""
    import numpy as np

    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
    from shine_mapping_tpu_torch.eval.metrics import eval_mesh
    from shine_mapping_tpu_torch.ops import adam_kernel as ak
    from shine_mapping_tpu_torch.utils import profiling

    ak.reset_launch_counts()  # this path of the main path starts here
    t0 = time.perf_counter()
    run_path, grid, params = run_shine_mapping_batch(cfg=cfg)
    counts = dict(ak.LAUNCHES)  # read right after the path
    wall = time.perf_counter() - t0
    assert counts[launch_key] == cfg.iters * per_step, \
        f"{label}: {counts[launch_key]} {launch_key} launches, want {cfg.iters * per_step}"
    assert counts["entry_prep"] == preps, f"{label}: {counts['entry_prep']} preps, want {preps}"
    others = {k: n for k, n in counts.items() if k not in (launch_key, "entry_prep") and n}
    assert not others, f"other kernels launched during {label}: {others}"
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    rec = recs[-1]
    ms = [r["timing(s)/per_iter"] * 1e3 for r in recs]
    peaks = profiling.last_hbm_monitor.samples
    print(f"[map] {label}: data phase {rec['phase(s)/data']:.2f} s, pool "
          f"{int(rec['pool_samples'])} samples, tables {[f.shape[0] for f in grid.features]} "
          f"rows, corners {grid.corner_counts}; {cfg.iters} steps at "
          f"{float(np.median(ms[1:] or ms)):.3f} ms/step (median over the {len(ms) - 1} "
          f"chunks after the first; first {ms[0]:.3f}), {counts[launch_key]} {launch_key} "
          f"launches, {counts['entry_prep']} entry_prep; loss {recs[0]['loss/total_loss']:.4f} "
          f"-> {rec['loss/total_loss']:.4f}; peak device memory training "
          f"{peaks['train'] / 2**30:.3f} GiB, meshing {peaks['mesh'] / 2**30:.3f} GiB; "
          f"run {wall:.1f} s")
    print(f"[map] {label}: mesh {int(rec['mesh/vertices'])} vertices, "
          f"{int(rec['mesh/triangles'])} triangles; meshing "
          + ", ".join(f"{k} {rec['mesh(s)/' + k]:.3f} s"
                      for k in ("query", "readback", "marching", "finalize")))
    m = eval_mesh(os.path.join(run_path, f"mesh/mesh_iter_{cfg.iters}.ply"), gt_path, **EVAL_KW)
    print(f"[map] {label}: eval_mesh F-score {m['F-score (%)']:.3f} %, precision "
          f"{m['Precision [Accuracy] (%)']:.3f} %, recall {m['Recall [Completeness] (%)']:.3f} "
          f"%, Chamfer-L1 {m['Chamfer_L1 (m)']:.4f} m (bars: < {MAP_BARS[0]} m, > "
          f"{MAP_BARS[1]} %)")
    assert m["Chamfer_L1 (m)"] < MAP_BARS[0] and m["F-score (%)"] > MAP_BARS[1], \
        f"{label}: map quality under the bars: {m}"
    return run_path, grid, params, counts


def _map_checkpoint_roundtrip(cfg, run_path, grid, params, gt_path, n=100_000):
    """model_final.npz loaded by the port into a fresh grid and decoder
    gives the live map's SDF and mask bit for bit at n points near the
    surface."""
    import numpy as np

    from shine_mapping_tpu_torch.cli.common import build_grid
    from shine_mapping_tpu_torch.data import io
    from shine_mapping_tpu_torch.mesher import Mesher
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.utils import checkpoint as ckpt

    skeleton = trainer.init_params(cfg, build_grid(cfg))
    grid2, params2, _, iters = ckpt.load_checkpoint(
        os.path.join(run_path, "model", "model_final.npz"), skeleton)
    rng = np.random.default_rng(5)
    gt = io.read_point_cloud(gt_path).points
    pts = (gt[rng.integers(0, len(gt), n)] + rng.normal(0, 0.1, (n, 3))) * cfg.scale
    live = Mesher(cfg, grid, params["geo"]).query_points(pts, cfg.infer_bs)
    loaded = Mesher(cfg, grid2, params2["geo"]).query_points(pts, cfg.infer_bs)
    assert iters == cfg.iters
    assert np.array_equal(live[2], loaded[2]), "checkpoint: masks differ"
    assert np.array_equal(live[0], loaded[0]), \
        f"checkpoint: sdf differs by up to {np.abs(live[0] - loaded[0]).max()}"
    print(f"[map] checkpoint round trip: model_final.npz (iter {iters}) loaded by the port, "
          f"sdf and mask at {n} points bit-equal to the live map ({int(live[2].sum())} "
          "inside the map)")


def _map_agreement(cfg, grid, params):
    """The dense lattice query of a sub-box around the sphere on the card
    against the plain path on CPU tensors (the same map carried over)."""
    import copy

    import numpy as np

    from shine_mapping_tpu_torch.mesher import Mesher
    from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost

    box = (np.array([3.0, -3.0, -0.5]), np.array([9.0, 3.0, 2.5]))
    card = Mesher(cfg, grid, params["geo"])
    cpu = Mesher(cfg, HashGridHost.from_state_dict(grid.state_dict(), device="cpu"),
                 copy.deepcopy(params["geo"]).cpu())
    vn, vo = card.grid_shape_from_bbx(box, cfg.mc_res_m)
    sdf_a, _, mask_a = card.query_grid_lattice(vn, vo, cfg.mc_res_m)
    t_card = card.timing["query"]
    sdf_b, _, mask_b = cpu.query_grid_lattice(vn, vo, cfg.mc_res_m)
    diff = float(np.abs(sdf_a - sdf_b).max())
    assert np.array_equal(mask_a, mask_b), \
        f"mesher: masks differ at {int((mask_a != mask_b).sum())} voxels"
    assert diff <= 1e-5, f"mesher: max |d sdf| {diff}"
    print(f"[agreement] mesher: query_grid_lattice of a {tuple(int(v) for v in vn)} box "
          f"({int(np.prod(vn))} voxels, {int(mask_a.sum())} in the map), card vs CPU: masks "
          f"equal, max |d sdf| {diff:.3e} (<= 1e-5); query {t_card:.3f} s on the card, "
          f"{cpu.timing['query']:.3f} s on the CPU")


def phase_map(n_frames=20, iters_a=1500, iters_b=500, n_az=1024, n_el=64):
    """Phase 6: the port's batch CLI end to end on the card (module doc)."""
    import tempfile

    launches = {}
    with tempfile.TemporaryDirectory(prefix="smoke_map_") as tmp:
        t0 = time.perf_counter()
        n_pts, gt_path = write_synth_sequence(os.path.join(tmp, "world"), n_frames, n_az, n_el)
        print(f"[map] synthetic world: {n_frames} frames of {n_el} x {n_az} rays, {n_pts} "
              f"points, ground truth 200k points, written in {time.perf_counter() - t0:.1f} s")
        # run A: the ICRA config as written (iid batches, pool lookups, K1
        # per level with its live entry prep) and dense-bbx meshing
        cfg = _map_config(os.path.join(tmp, "world"), os.path.join(tmp, "a"), iters_a)
        run_path, grid, params, counts = _map_run(
            "run A (ICRA config, K1)", cfg, gt_path, "fused_adam", 3, 3 * iters_a)
        launches.update(counts)
        _map_checkpoint_roundtrip(cfg, run_path, grid, params, gt_path)
        _map_agreement(cfg, grid, params)
        del grid, params
        # run B: the bf16 map mode through the CLI (pool lookups, fused
        # epoch windows, bf16 moments and tables, K2 with stochastic rounding)
        cfg = _map_config(os.path.join(tmp, "world"), os.path.join(tmp, "b"), iters_b,
                          feature_update="pallas", moments_bf16=True, batch_windows=True,
                          params_bf16=True)
        _, grid, params, counts = _map_run(
            "run B (bf16 map mode, K2 + SR)", cfg, gt_path, "fused_adam_multi_bf16p", 1, 1)
        assert grid.features[0].dtype.itemsize == 2, "run B did not keep bf16 tables"
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    return launches


# ----------------------------------------------------------------- phase 7


# (label, config, tpu knobs, the work-ratio gate forced open, the update's
# launch key, its launches per step)
INCRE_RUNS = (
    ("C", "config/maicity/maicity_incre_reg.yaml", {}, False, "fused_adam", 3),
    ("D", "config/maicity/maicity_incre_replay.yaml", {}, False, "fused_adam", 3),
    ("E", "config/maicity/maicity_incre_reg.yaml",
     {"feature_update": "pallas", "moments_bf16": True, "batch_windows": True}, True,
     "fused_adam_multi_bf16m", 1),
)
# F-score (%) of the final mesh that the JAX package's incremental driver
# reaches on the CPU on the same world, with the same config and cuts: the
# mean over setting.seed 42 (the config's), 1 and 2, since one run's
# F-score moves with the seed by up to 5 points (C 83.141 / 86.681 /
# 81.845, D 98.303 / 98.927 / 98.586, E 78.549 / 83.922 / 84.291;
# JAX_PLATFORMS=cpu python3 scripts/jax_incre_reference.py --seeds 42,1,2).
# The port's run on the card must come within INCRE_FSCORE_GAP of it.
JAX_INCRE_FSCORE = {"C": 83.889, "D": 98.605, "E": 82.254}
INCRE_FSCORE_GAP = 5.0


def incre_config(cls, run, root, out, n_frames, device=None):
    """Run ``run``'s config (one of INCRE_RUNS) as written, cut to the
    synthetic world at ``root``: the world's frames, the decoder frozen
    half way (so the freeze runs), the data paths and output root, the
    run's ``tpu:`` knobs.  ``cls``: either package's SHINEConfig.  Returns
    (config, the ``[incre] reduced:`` line)."""
    label, path, tpu, open_gate = run[:4]
    cfg = cls().load(path)
    cut = {"end_frame": n_frames - 1, "freeze_after_frame": n_frames // 2}
    line = (f"[incre] reduced: run {label} ({path}): "
            + ", ".join(f"{k} {getattr(cfg, k)} -> {v}" for k, v in cut.items())
            + " (the world's frames); data paths and output_root: the synthetic world"
            + (f"; tpu: {tpu}" if tpu else "")
            + ("; shine_incre.PRECOMPUTE_WORK_RATIO 4.0 -> 0.0" if open_gate else ""))
    cfg.pc_path = os.path.join(root, "velodyne")
    cfg.pose_path = os.path.join(root, "poses.txt")
    cfg.calib_path = os.path.join(root, "calib.txt")
    cfg.output_root = out
    if device is not None:
        cfg.device = device
    for k, v in {**cut, **tpu}.items():
        setattr(cfg, k, v)
    return cfg, line


def _watch_chunks(trainer):
    """Wrap ``trainer.train_chunk`` as the incremental driver calls it: a
    frozen chunk must leave the decoders bit for bit, no chunk may move the
    last-frame snapshot (a copy, never the trained tables).  Returns (the
    list of (frozen, reg) per chunk, the unwrapped function)."""
    import torch

    seen, inner = [], trainer.train_chunk

    def wrapped(params, *args, **kw):
        s = args[6]
        dec = {(g, n): t.clone() for g in ("geo", "sem")
               for n, t in params[g].state_dict().items()}
        last = kw["shadow"]["last_frame"] if kw.get("shadow") else []
        last0 = [t.clone() for t in last]
        out = inner(params, *args, **kw)
        if s.freeze_decoder:
            for (g, n), t in dec.items():
                assert torch.equal(params[g].state_dict()[n], t), f"frozen {g}.{n} moved"
        for a, b, f in zip(last0, last, params["features"]):
            assert torch.equal(a, b) and b.data_ptr() != f.data_ptr(), \
                "training moved the last-frame snapshot"
        seen.append((s.freeze_decoder, s.continual_reg_on))
        return out

    trainer.train_chunk = wrapped
    return seen, inner


def _incre_run(run, world, out, gt_path, n_frames):
    """One run of the port's incremental CLI in this process, launch counts
    zeroed just before it and read just after; its records, freeze and
    snapshot checked, its final mesh scored against the ground truth and
    the JAX driver's F-score.  Returns (launch counts, config, grid,
    params)."""
    import numpy as np

    from shine_mapping_tpu_torch.cli import shine_incre
    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.eval.metrics import eval_mesh
    from shine_mapping_tpu_torch.ops import adam_kernel as ak
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.utils import profiling

    label, _, _, open_gate, key, per_step = run
    cfg, line = incre_config(SHINEConfig, run, world, out, n_frames, DEVICE)
    print(line)
    reg = cfg.continual_learning_reg
    seen, inner = _watch_chunks(trainer)
    ratio = shine_incre.PRECOMPUTE_WORK_RATIO
    if open_gate:
        shine_incre.PRECOMPUTE_WORK_RATIO = 0.0
    try:
        ak.reset_launch_counts()  # this path of the main path starts here
        t0 = time.perf_counter()
        run_path, grid, params = shine_incre.run_shine_mapping_incremental(cfg=cfg)
        counts = dict(ak.LAUNCHES)  # read right after the path
        wall = time.perf_counter() - t0
    finally:
        trainer.train_chunk = inner
        shine_incre.PRECOMPUTE_WORK_RATIO = ratio
    steps = n_frames * cfg.iters
    preps = n_frames if open_gate else steps * per_step  # window stacks, or live
    assert counts[key] == steps * per_step, \
        f"run {label}: {counts[key]} {key} launches, want {steps * per_step}"
    assert counts["entry_prep"] == preps, f"run {label}: {counts['entry_prep']} preps"
    others = {k: n for k, n in counts.items() if k not in (key, "entry_prep") and n}
    assert not others, f"other kernels launched during run {label}: {others}"
    assert seen == [(f >= cfg.freeze_after_frame, reg) for f in range(n_frames)], seen
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == n_frames and all(np.isfinite(r["loss/total_loss"]) for r in recs)
    if reg:
        assert all(r["loss/reg_loss"] > 0 for r in recs[1:]), "no reg after frame 0"
        assert all(float(w.max()) > 0 for w in grid.importance_weight), "no importance"
    med = {k: float(np.median([r[f"timing(s)/{k}"] for r in recs]))
           for k in ("preprocess", "mapping", "importance")}
    meshed = [r["timing(s)/reconstruct"] for i, r in enumerate(recs)
              if i == 0 or (i + 1) % cfg.mesh_freq_frame == 0]
    ms_step = float(np.median([(r["timing(s)/mapping"] - r["timing(s)/importance"])
                               / cfg.iters for r in recs[1:]])) * 1e3
    peaks = profiling.last_hbm_monitor.samples
    print(f"[incre] run {label}: {n_frames} frames x {cfg.iters} steps, bs {cfg.bs}, pool "
          f"{int(recs[0]['pool_samples'])} -> {int(recs[-1]['pool_samples'])} samples, "
          f"tables {[f.shape[0] for f in grid.features]} rows, corners {grid.corner_counts}; "
          f"{counts[key]} {key} launches, {counts['entry_prep']} entry_prep; loss "
          f"{recs[0]['loss/total_loss']:.4f} -> {recs[-1]['loss/total_loss']:.4f}"
          + (f", reg_loss {recs[1]['loss/reg_loss']:.4g} -> {recs[-1]['loss/reg_loss']:.4g}"
             if reg else "") + f"; run {wall:.1f} s")
    print(f"[incre] run {label}: per frame (median) preprocess {med['preprocess']:.3f} s, "
          f"mapping {med['mapping']:.3f} s (training {ms_step:.3f} ms/step, importance "
          f"{med['importance']:.3f} s), reconstruct {float(np.median(meshed)):.3f} s over "
          f"the {len(meshed)} meshed frames; peak device memory training "
          f"{peaks['train'] / 2**30:.3f} GiB, meshing {peaks['mesh'] / 2**30:.3f} GiB")
    m = eval_mesh(os.path.join(run_path, f"mesh/mesh_frame_{n_frames}.ply"), gt_path,
                  **EVAL_KW)
    want = JAX_INCRE_FSCORE[label]
    print(f"[incre] run {label}: eval_mesh F-score {m['F-score (%)']:.3f} %, precision "
          f"{m['Precision [Accuracy] (%)']:.3f} %, recall {m['Recall [Completeness] (%)']:.3f} "
          f"%, Chamfer-L1 {m['Chamfer_L1 (m)']:.4f} m; the JAX driver on the CPU {want} % "
          f"(mean of 3 seeds; bar: within {INCRE_FSCORE_GAP} points)")
    assert abs(m["F-score (%)"] - want) < INCRE_FSCORE_GAP, \
        f"run {label}: F-score {m['F-score (%)']} vs the JAX driver's {want}"
    return counts, cfg, grid, params


def _incre_agreement(cfg, grid, params, n_frames, steps=5):
    """Card = CPU on run C's final state and its last frame's pool: the
    importance sweep (rtol 1e-5, atol 1e-6 of each table's largest value,
    on all but 1e-4 of the elements, and within 1e-4 of the largest value
    on all: a row's per-batch gradient sum that nearly cancels keeps its
    terms' rounding, which cuBLAS and the card's atomics leave in another
    order than the CPU's; measured 1-6 of 524,288 elements off, by up to
    1.8e-3 of their value and 1.2e-5 of the largest), then 5 reg steps at
    adam_eps 1e-3 (so the step is a smooth function of the gradient, as in
    phase 5) on the same batches: p and the decoders rtol 1e-4, atol 1e-5;
    m and v rtol 1e-4 with an atol of 1e-6 of the table's largest value (at least 1e-5: the reg gradients reach
    2 lambda imp |p - last|).  On the card every K1 launch of those steps is
    held against its plain version on the same inputs at phase 2's
    tolerance plus each element's sum-order spread (:func:`_sum_order_spread`:
    at lambda 1e6 a row's reg and loss gradients nearly cancel, and the
    card's atomics sum them in no fixed order; no share of the head needs
    to move: a fresh Adam state leaves untouched rows in place)."""
    import copy

    import numpy as np
    import torch

    from shine_mapping_tpu_torch.cli.common import build_grid
    from shine_mapping_tpu_torch.data.dataset import LiDARDataset
    from shine_mapping_tpu_torch.ops import adam_kernel as ak
    from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.importance import cal_feature_importance
    from shine_mapping_tpu_torch.train.optimizer import init_opt_state

    cpu_cfg = copy.copy(cfg)
    cpu_cfg.device = "cpu"
    ds = LiDARDataset(cpu_cfg, build_grid(cpu_cfg))  # its own grid: the frame's pool only
    ds.process_frame(n_frames - 1, incremental_on=True)
    state = grid.state_dict()
    sides = {}
    for side, dev in (("card", DEVICE), ("cpu", "cpu")):
        g = HashGridHost.from_state_dict(state, device=dev)
        g.features_last_frame = [t.to(dev, copy=True) for t in grid.features_last_frame]
        p = {"geo": copy.deepcopy(params["geo"]).to(dev),
             "sem": copy.deepcopy(params["sem"]).to(dev),
             "features": list(g.features), "sigma": params["sigma"].detach().to(dev, copy=True)}
        pool, n = trainer.pool_to_device(ds.pool, len(ds.pool), device=dev)
        sides[side] = (g, p, pool, n)
    s = trainer.TrainSettings.from_config(
        cfg, grid.levels, continual_reg_on=True, adam_eps=1e-3,
        n_used=trainer.used_rows_for(grid, granularity=4))
    t = {}
    for side, (g, p, pool, n) in sides.items():
        t0 = time.perf_counter()
        cal_feature_importance(g, p["geo"], pool["coord"], pool["sdf_label"], s.sigma_sigmoid,
                               cfg.bs, cfg.cal_importance_weight_down_rate, cfg.loss_reduction)
        if g.device.type == "cuda":
            torch.cuda.synchronize()
        t[side] = time.perf_counter() - t0
    imp_err, imp_share = 0.0, 1.0
    for a, b in zip(sides["card"][0].importance_weight, sides["cpu"][0].importance_weight):
        a = a.cpu()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))
        close = torch.isclose(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
        imp_share = min(imp_share, float(close.float().mean()))
        imp_err = max(imp_err, float((a - b).abs().max()))
    assert imp_share >= 1 - 1e-4, f"importance: only {imp_share:.6f} within rtol 1e-5"

    n = sides["cpu"][3]
    idx = torch.from_numpy(np.random.default_rng(9).integers(0, n, (steps, cfg.bs)))
    kernel_err, inner = [0.0, 0, 0, 0.0], ak.fused_adam

    def checked(p, m, v, rows, grads, lr, bc1, bc2, n_used=None, **kw):
        t0 = [x.clone() for x in (p, m, v)]
        out = inner(p, m, v, rows, grads, lr, bc1, bc2, n_used, **kw)
        plain = [x.clone() for x in t0]
        ak.fused_adam_plain(*plain, rows, grads, lr, bc1, bc2, n_used, **kw)
        single = _single_rows([rows], [p.shape[0]], [n_used])
        spread = _sum_order_spread(t0, rows, grads, lr, bc1, bc2, n_used, **kw)
        _check_f32([[p], [m], [v]], [[x] for x in plain], [[x] for x in t0], [n_used],
                   single=single, moved_share=None, scale_of="after", spread=spread)
        for a, b, (sp,) in zip((p, m, v), plain, spread):  # v reaches ~1e13 here
            rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            kernel_err[0] = max(kernel_err[0], rel)
            allow = min(1e-6, 1e-5 * float(b[:n_used].abs().max())) + 1e-5 * b.abs()
            kernel_err[2] += int(((a - b).abs() > allow).sum())  # needed their spread
            kernel_err[3] = max(kernel_err[3], _share_used(a, b, allow + sp))
        kernel_err[1] += 1
        return out

    out = {}
    for side, (g, p, pool, n) in sides.items():
        shadow = {"importance": g.importance_weight, "last_frame": g.features_last_frame}
        ak.fused_adam = checked if side == "card" else inner
        try:
            p, opt, aux = trainer.train_chunk(p, init_opt_state(p), g.tables, pool, n, 0, None,
                                              s, steps, batch_indices=idx, shadow=shadow)
        finally:
            ak.fused_adam = inner
        out[side] = (p, opt, float(aux["mean"]["reg_loss"]), float(aux["mean"]["total_loss"]))
    (pc, oc, rc, lc), (pp, op, rp, lp) = out["card"], out["cpu"]
    np.testing.assert_allclose(rc, rp, rtol=1e-5)
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    used = {"p": 0.0, "m": 0.0, "v": 0.0, "decoder": 0.0}
    for a, b in zip(pc["features"], pp["features"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
        used["p"] = max(used["p"], _share_used(a.cpu(), b, 1e-5 + 1e-4 * b.abs()))
    for name in ("m", "v"):
        for a, b in zip(getattr(oc, name)["features"], getattr(op, name)["features"]):
            atol = max(1e-5, 1e-6 * float(b.abs().max()))
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=atol)
            used[name] = max(used[name], _share_used(a.cpu(), b, atol + 1e-4 * b.abs()))
    for k, b in pp["geo"].state_dict().items():
        a = pc["geo"].state_dict()[k].cpu()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        used["decoder"] = max(used["decoder"], _share_used(a, b, 1e-5 + 1e-4 * b.abs()))
    assert kernel_err[1] == 3 * steps, kernel_err
    print(f"[agreement] incremental reg (run C's final state, its last frame's "
          f"{len(ds.pool)} samples): importance card vs CPU max |d| {imp_err:.3e}, "
          f"{imp_share:.6f} of the elements within rtol 1e-5 (card "
          f"{t['card']:.3f} s, CPU {t['cpu']:.3f} s); {steps} reg steps (lambda "
          f"{cfg.lambda_forget:g}) reg_loss {rc:.6g} vs {rp:.6g}, parameters and moments "
          f"agree (largest share of their tolerance used: "
          + ", ".join(f"{k} {x:.3f}" for k, x in used.items())
          + f"); the {kernel_err[1]} K1 launches vs their plain versions: max |d| "
          f"{kernel_err[0]:.3e} of each table's largest value, at phase 2's tolerance "
          f"plus the sum-order spread ({kernel_err[2]} elements past phase 2's tolerance "
          f"alone; largest share of the allowance used {kernel_err[3]:.3f})")


def phase_incre(n_frames=20, n_az=1024, n_el=64):
    """Phase 7: the port's incremental CLI on the card (module doc)."""
    import tempfile

    launches = {}
    with tempfile.TemporaryDirectory(prefix="smoke_incre_") as tmp:
        world = os.path.join(tmp, "world")
        n_pts, gt_path = write_synth_sequence(world, n_frames, n_az, n_el)
        print(f"[incre] synthetic world: {n_frames} frames of {n_el} x {n_az} rays, {n_pts} "
              "points (phase 6's)")
        for run in INCRE_RUNS:
            counts, cfg, grid, params = _incre_run(run, world, os.path.join(tmp, run[0]),
                                                   gt_path, n_frames)
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
            if run[0] == "C":
                _incre_agreement(cfg, grid, params, n_frames)
            del grid, params
    return launches


# ----------------------------------------------------------------- phase 8


# experiments/demo_tpu_kitti_scale.py's config (its lines 39-118), the shape
# of the reference's config/kitti/docker_kitti_batch.yaml: pc_radius 50 m,
# vox 0.05 m, leaf 0.2 m, world level 12, 3 levels, D 8, 2x32 MLP, bs 4096,
# semantics and the moving-object filter on, the bf16 map mode, rotating
# sub-pools, octree meshing at 0.2 m
CITY_CFG = """\
setting:
  name: demo_city
  output_root: {out}
  pc_path: {root}/velodyne
  pose_path: {root}/poses.txt
  calib_path: {root}/calib.txt
  label_path: {root}/labels
  load_model: false
  model_path: ''
  first_frame_ref: false
  begin_frame: 0
  end_frame: 10000
  every_frame: 1
  device: {device}
  gpu_id: '0'
process:
  min_range_m: 3.0
  pc_radius_m: 50.0
  min_z_m: -3.5
  rand_downsample: false
  vox_down_m: {vox}
  rand_down_r: 0.2
  semantic_on: true
  filter_moving_object: true
sampler:
  surface_sample_range_m: 0.3
  surface_sample_n: 3
  free_sample_begin_ratio: 0.3
  free_sample_end_dist_m: 0.8
  free_sample_n: 3
octree:
  leaf_vox_size: {leaf}
  tree_level_world: {world_level}
  tree_level_feat: 3
  feature_dim: 8
  poly_int_on: true
  octree_from_surface_samples: true
decoder:
  mlp_level: 2
  mlp_hidden_dim: 32
  freeze_after_frame: 0
loss:
  ray_loss: false
  main_loss_type: sdf_bce
  sigma_sigmoid_m: 0.1
  loss_weight_on: false
  behind_dropoff_on: false
  ekional_loss_on: false
  weight_e: 0.1
continual:
  continual_learning_reg: false
  lambda_forget: 0
  window_replay_on: false
  window_radius_m: 0
optimizer:
  iters: {iters}
  batch_size: {bs}
  learning_rate: 0.01
  weight_decay: 1.0e-07
eval:
  wandb_vis_on: false
  o3d_vis_on: false
  vis_freq_iters: {iters}
  save_freq_iters: 0
  mesh_freq_frame: 1
  mc_res_m: {mc_res}
  mc_with_octree: true
  mc_local: false
  mc_vis_level: 1
  save_map: false
tpu:
  feature_update: pallas
  moments_bf16: true
  precompute_lookups: true
  batch_windows: true
  params_bf16: true
  max_device_pool: {max_pool}
  pool_rotate_iters: {rotate}
"""
# the demo's full-size values (vox, leaf, world level, bs, mc_res, pool budget)
CITY_FULL = dict(vox=0.05, leaf=0.2, world_level=12, bs=4096, mc_res=0.2, max_pool=1 << 22)


def city_config(cls, root, out, iters, rotate=2000, device=None, **over):
    """:data:`CITY_CFG` written into ``out`` and loaded by ``cls`` (either
    package's SHINEConfig); ``over`` replaces values of :data:`CITY_FULL`."""
    vals = dict(CITY_FULL, **over)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "city.yaml")
    with open(path, "w") as f:
        f.write(CITY_CFG.format(out=out, root=root, iters=iters, rotate=rotate,
                                device=device or DEVICE, **vals))
    return cls().load(path)


# (label, what, config changes beyond CITY_CFG, the update's launch key or
# None: no kernel)
CITY_RUNS = (
    ("F", "semantic, bf16 map mode (K2 + SR on fused windows)", {}, "fused_adam_multi_bf16p"),
    ("G", "semantic, sparse lazy Adam (f32 tables, iid batches)",
     {"feature_update": "sparse"}, None),
)
CITY_GAP = 5.0  # run G's F-score within this many points of run F's
SEM_BAR = 80.0  # % of the mesh vertices near a labelled static box in its class
SEM_NEAR = 0.1  # m


def _city_geometry(args):
    """Frame ``i``'s noise-free scan of the city: the first half of
    ``synth_city.simulate_city_scan`` (the rays, the road plane, the static
    boxes, the moving cars at the frame's positions), which draws nothing
    at random.  Returns (world points float64, raw labels)."""
    import numpy as np

    fields, pose, i, n_az, n_el, max_range = args
    sc = _load_tests_module("synth_city")
    city = sc.City(**fields)
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    el = np.linspace(np.deg2rad(-24.0), np.deg2rad(4.0), n_el)
    aa, ee = np.meshgrid(az, el, indexing="ij")
    dirs_s = np.stack([np.cos(ee) * np.cos(aa), np.cos(ee) * np.sin(aa), np.sin(ee)],
                      axis=-1).reshape(-1, 3)
    R, t = pose[:3, :3], pose[:3, 3]
    dirs = dirs_s @ R.T
    origins = np.tile(t[None, :], (dirs.shape[0], 1))
    dz = dirs[:, 2]
    tp = (0.0 - origins[:, 2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
    t_best = np.where((tp > 0.1) & (dz < 0), tp, np.inf)
    label = np.full(dirs.shape[0], sc.ROAD_RAW, np.int64)
    tb, jb, okb = sc._ray_boxes(origins, dirs, city.bmin, city.bmax)
    closer = okb & (tb < t_best)
    t_best = np.where(closer, tb, t_best)
    label = np.where(closer, city.blabel[jb], label)
    mmin, mmax = city.moving_boxes(i)
    tm, jm, okm = sc._ray_boxes(origins, dirs, mmin, mmax)
    closer = okm & (tm < t_best)
    t_best = np.where(closer, tm, t_best)
    label = np.where(closer, sc.MOVING_CAR_RAW, label)
    valid = np.isfinite(t_best) & (t_best < max_range)
    return origins[valid] + dirs[valid] * t_best[valid][:, None], label[valid]


def _city_gt(args):
    fields, root, n_frames, every, n_az, n_el = args
    sc = _load_tests_module("synth_city")
    return sc.city_gt_points(sc.City(**fields), root, n_frames, every=every, n_az=n_az,
                             n_el=n_el, max_range=45.0)


def write_city(root, n_frames=150, n_az=1024, n_el=48, blocks=(8, 3), gt_every=15, workers=8):
    """tests/synth_city.py's labelled city in KITTI layout, the files
    ``make_city_dataset(root, n_frames, seed=0, ...)`` writes byte for byte:
    the scans' geometry (which draws nothing at random) cast by ``workers``
    processes, then in frame order each frame's noise from the one seeded
    generator and the sensor-frame transform, as ``simulate_city_scan``
    does them.  And its ground truth (``city_gt_points``): rescans of the
    static surfaces from every ``gt_every``-th pose at the scans'
    resolution, within 45 m, cast beside them (``workers`` 0: all in this
    process).  Returns (city, gt.ply's path, points written, moving-car
    points)."""
    import contextlib
    import multiprocessing

    import numpy as np

    from shine_mapping_tpu_torch.data import io

    sc = _load_tests_module("synth_city")
    city = sc.build_city(0, n_blocks_x=blocks[0], n_blocks_y=blocks[1])
    poses = sc.city_trajectory(n_frames)
    pc_dir, lb_dir = os.path.join(root, "velodyne"), os.path.join(root, "labels")
    os.makedirs(pc_dir, exist_ok=True)
    os.makedirs(lb_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    n_pts = n_mov = 0
    # the City by its fields: a class of a module loaded by path does not pickle
    fields = dict(vars(city))
    gt_job = [(fields, root, n_frames, gt_every, n_az, n_el)]
    with (multiprocessing.get_context("spawn").Pool(workers) if workers
          else contextlib.nullcontext()) as pool:
        gt = pool.map_async(_city_gt, gt_job) if workers else None
        scans = (pool.imap if workers else map)(
            _city_geometry, [(fields, T, i, n_az, n_el, 70.0) for i, T in enumerate(poses)])
        for i, (T, (pts_w, raw)) in enumerate(zip(poses, scans)):
            pts_w = pts_w + rng.normal(0, 0.008, pts_w.shape)
            pts = ((pts_w - T[:3, 3][None, :]) @ T[:3, :3]).astype(np.float32)
            np.concatenate([pts, np.zeros((pts.shape[0], 1), np.float32)], axis=1).tofile(
                os.path.join(pc_dir, f"{i:06d}.bin"))
            raw.astype(np.uint32).tofile(os.path.join(lb_dir, f"{i:06d}.label"))
            n_pts += raw.size
            n_mov += int((raw == sc.MOVING_CAR_RAW).sum())
        gt = gt.get()[0] if workers else _city_gt(gt_job[0])
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write("Tr: " + " ".join(str(v) for v in np.eye(4)[:3].reshape(-1)) + "\n")
    with open(os.path.join(root, "poses.txt"), "w") as f:
        for T in poses:
            f.write(" ".join(str(v) for v in T[:3].reshape(-1)) + "\n")
    gt_path = os.path.join(root, "gt.ply")
    io.write_ply(gt_path, io.PointCloud(points=gt))
    return city, gt_path, n_pts, n_mov


def vertex_semantics_share(mesh_path, city, device):
    """Of the mesh's vertices within SEM_NEAR of exactly one class of
    labelled static surface (a box of the city, or the road plane z = 0),
    the share (%) whose colour is that class's (raw labels mapped to
    classes by ``data/semantic_kitti.py``).  Returns (share, vertices
    counted, vertices)."""
    import numpy as np
    import torch

    from shine_mapping_tpu_torch.data import io
    from shine_mapping_tpu_torch.data.semantic_kitti import labels_to_colors, map_labels

    mesh = io.read_ply(mesh_path)
    v = torch.from_numpy(mesh.vertices.astype(np.float32)).to(device)
    rgb = np.round(mesh.vertex_colors * 255).astype(np.int64)
    palette = np.round(labels_to_colors(np.arange(21)) * 255).astype(np.int64)
    key = lambda c: (c[..., 0] * 256 + c[..., 1]) * 256 + c[..., 2]  # noqa: E731
    lut = {int(k): c for c, k in enumerate(key(palette))}
    got = torch.from_numpy(np.array([lut.get(int(k), -1) for k in key(rgb)])).to(device)
    bmin = torch.from_numpy(city.bmin.astype(np.float32)).to(device)
    bmax = torch.from_numpy(city.bmax.astype(np.float32)).to(device)
    bcls = torch.from_numpy(map_labels(city.blabel.astype(np.uint32))).to(device)
    road = int(map_labels(np.array([_load_tests_module("synth_city").ROAD_RAW], np.uint32))[0])
    n_ok = n_counted = 0
    for a in range(0, v.shape[0], 1 << 15):
        x = v[a:a + (1 << 15)]
        d = torch.linalg.norm(torch.clamp(torch.maximum(bmin[None] - x[:, None], x[:, None]
                                                        - bmax[None]), min=0), dim=-1)
        near = d <= SEM_NEAR  # (n, boxes)
        cls = torch.where(near, bcls[None], -1)
        lo = torch.where(near, bcls[None], 1 << 20).min(dim=1).values
        hi = cls.max(dim=1).values
        on_road = x[:, 2].abs() <= SEM_NEAR
        lo = torch.where(on_road, torch.minimum(lo, torch.full_like(lo, road)), lo)
        hi = torch.where(on_road, torch.maximum(hi, torch.full_like(hi, road)), hi)
        one = (lo == hi) & (hi >= 0)  # near surfaces of exactly one class
        n_counted += int(one.sum())
        n_ok += int((one & (got[a:a + (1 << 15)] == hi)).sum())
    return 100.0 * n_ok / max(n_counted, 1), n_counted, int(v.shape[0])


def _city_run(label, what, cfg, gt_path, city, launch_key):
    """One run of the port's batch CLI on the city, launch counts zeroed just
    before it and read just after; its checks (module doc).  Returns (the
    run's numbers, launch counts)."""
    import numpy as np

    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
    from shine_mapping_tpu_torch.eval.metrics import eval_mesh
    from shine_mapping_tpu_torch.ops import adam_kernel as ak
    from shine_mapping_tpu_torch.utils import profiling

    ak.reset_launch_counts()  # this path of the main path starts here
    t0 = time.perf_counter()
    run_path, grid, params = run_shine_mapping_batch(cfg=cfg)
    counts = dict(ak.LAUNCHES)  # read right after the path
    wall = time.perf_counter() - t0
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    rot = int(recs[-1]["pool/rotations"])
    if launch_key is None:
        assert not any(counts.values()), f"run {label}: kernels launched: {counts}"
    else:
        assert counts[launch_key] == cfg.iters, \
            f"run {label}: {counts[launch_key]} {launch_key} launches, want {cfg.iters}"
        # one window stack (and its entry prep) per device pool
        assert counts["entry_prep"] == rot + 1, \
            f"run {label}: {counts['entry_prep']} preps, want {rot + 1}"
        others = {k: n for k, n in counts.items() if k not in (launch_key, "entry_prep") and n}
        assert not others, f"other kernels launched during run {label}: {others}"
        assert grid.features[0].dtype.itemsize == 2, f"run {label} did not keep bf16 tables"
    assert rot >= 1, f"run {label}: no pool rotation"
    for r in recs:
        assert all(np.isfinite(v) for k, v in r.items() if k.startswith("loss/")), r
    sem0, sem1 = recs[0]["loss/sem_loss"], recs[-1]["loss/sem_loss"]
    assert sem1 < sem0, f"run {label}: sem_loss {sem0} -> {sem1} did not fall"
    rec = recs[-1]
    ms = [r["timing(s)/per_iter"] * 1e3 for r in recs]
    peaks = {k: round(v / 2**30, 3) for k, v in profiling.last_hbm_monitor.samples.items()}
    mesh_path = os.path.join(run_path, f"mesh/mesh_iter_{cfg.iters}.ply")
    m = eval_mesh(mesh_path, gt_path, **EVAL_KW)
    share, counted, n_vert = vertex_semantics_share(mesh_path, city, DEVICE)
    out = {"ms_step": float(np.median(ms[1:] or ms)), "wall_s": wall,
           "fscore": m["F-score (%)"], "chamfer": m["Chamfer_L1 (m)"], "sem_share": share,
           "peak_gb": max(peaks.values())}
    print(f"[city] run {label} ({what}): data phase {rec['phase(s)/data']:.2f} s, pool "
          f"{int(rec['pool_samples'])} samples in sub-pools of {cfg.max_device_pool} "
          f"({rot} rotations); map corners per level {grid.corner_counts}, tables "
          f"{[f.shape[0] for f in grid.features]} rows {grid.features[0].dtype}; {cfg.iters} "
          f"steps at {out['ms_step']:.3f} ms/step (median of the {len(ms) - 1} chunks after "
          f"the first; first {ms[0]:.3f}); launches "
          f"{ {k: n for k, n in counts.items() if n} }; sem_loss {sem0:.4f} -> {sem1:.4f}, "
          f"total {recs[0]['loss/total_loss']:.4f} -> {rec['loss/total_loss']:.4f}; peak "
          f"device memory by phase (GiB) {peaks}; run {wall:.1f} s")
    print(f"[city] run {label}: mesh {int(rec['mesh/vertices'])} vertices, "
          f"{int(rec['mesh/triangles'])} triangles; meshing "
          + ", ".join(f"{k} {rec['mesh(s)/' + k]:.3f} s"
                      for k in ("query", "readback", "marching", "finalize")))
    print(f"[city] run {label}: eval_mesh F-score {m['F-score (%)']:.3f} %, precision "
          f"{m['Precision [Accuracy] (%)']:.3f} %, recall {m['Recall [Completeness] (%)']:.3f} "
          f"%, Chamfer-L1 {m['Chamfer_L1 (m)']:.4f} m (bars: < {MAP_BARS[0]} m, > "
          f"{MAP_BARS[1]} %); vertex semantics {share:.2f} % of the {counted} of {n_vert} "
          f"vertices within {SEM_NEAR} m of one labelled class carry it (bar: >= {SEM_BAR} %)")
    assert m["Chamfer_L1 (m)"] < MAP_BARS[0] and m["F-score (%)"] > MAP_BARS[1], \
        f"run {label}: map quality under the bars: {m}"
    assert share >= SEM_BAR, f"run {label}: vertex semantics {share:.2f} % < {SEM_BAR} %"
    return out, counts


def phase_city(n_frames=150, iters=4000, rotate=1000, n_az=1024, n_el=48, blocks=(8, 3),
               gt_every=15, **small):
    """Phase 8: semantic mapping of the 150-frame city (module doc).
    ``small`` (a rehearsal on the CPU) replaces values of CITY_FULL."""
    import tempfile

    from shine_mapping_tpu_torch.config import SHINEConfig

    launches, runs = {}, {}
    with tempfile.TemporaryDirectory(prefix="smoke_city_") as tmp:
        root = os.path.join(tmp, "city")
        t0 = time.perf_counter()
        city, gt_path, n_pts, n_mov = write_city(root, n_frames, n_az, n_el, blocks, gt_every)
        print(f"[city] tests/synth_city.py world: {n_frames} frames of {n_el} x {n_az} rays, "
              f"{blocks[0]} x {blocks[1]} blocks, {n_pts} points ({n_mov} on moving cars), "
              f"{len(city.blabel)} labelled static boxes, ground truth from every "
              f"{gt_every}th pose; written in {time.perf_counter() - t0:.1f} s")
        print(f"[city] reduced: iters 20000 -> {iters}, pool_rotate_iters 2000 -> {rotate}, "
              f"ground truth every 5th pose at 2048 x 96 -> every {gt_every}th at {n_az} x "
              f"{n_el}" + (f", frames 150 -> {n_frames}" if n_frames != 150 else "")
              + (f"; rehearsal values {small}" if small else "")
              + "; widths as written (experiments/demo_tpu_kitti_scale.py:39-118)")
        for label, what, over, key in CITY_RUNS:
            cfg = city_config(SHINEConfig, root, os.path.join(tmp, label), iters,
                              rotate=rotate, **small)
            for k, v in over.items():
                setattr(cfg, k, v)
            runs[label], counts = _city_run(label, what, cfg, gt_path, city, key)
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
    gap = abs(runs["G"]["fscore"] - runs["F"]["fscore"])
    print(f"[city] run G's F-score {runs['G']['fscore']:.3f} % vs run F's "
          f"{runs['F']['fscore']:.3f} %: {gap:.3f} points apart (bar: <= {CITY_GAP})")
    assert gap <= CITY_GAP, f"run G {gap:.3f} points from run F"
    return launches, runs


# ----------------------------------------------------------------- main


# phases that run alone with ``--only`` (a check while developing; the
# smoke itself is the run with no arguments)
ALONE = {"agreement": lambda: (phase_agreement(), phase_agreement_options()),
         "map": lambda: phase_map(), "incre": lambda: phase_incre(),
         "city": lambda: phase_city()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    import shine_mapping_tpu_torch  # noqa: F401  (fails outside a checkout)
    from shine_mapping_tpu_torch.config import SHINEConfig

    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        t_start = time.perf_counter()
        print(phase_device())
        for name in sys.argv[2].split(","):
            ALONE[name]()
        print(f"[done] {time.perf_counter() - t_start:.1f} s (phases {sys.argv[2]} only: "
              "no result line)")
        return 0

    t_start = time.perf_counter()
    smi = phase_device()
    kernels = phase_kernels()
    study = phase_study()
    cfg = SHINEConfig().load(ICRA_CONFIG)
    print(f"[train] {ICRA_CONFIG}: bs {cfg.bs}, levels {cfg.tree_level_feat}, dim "
          f"{cfg.feature_dim}, mlp {cfg.geo_mlp_level}x{cfg.geo_mlp_hidden_dim}, "
          f"{cfg.main_loss_type} + eikonal {cfg.weight_e if cfg.ekional_loss_on else 0}, "
          f"lr {cfg.lr}, device {cfg.device}")
    grid, band, params, launches = phase_train(cfg)
    phase_query(grid, band, params)
    phase_agreement()
    phase_agreement_options()
    del grid, band, params
    map_launches = phase_map()
    incre_launches = phase_incre()
    city_launches, _ = phase_city()
    for k in kernels:  # K1/K2: counted over the training runs and the CLI runs
        k["launches"] = (launches[k["name"]] + map_launches.get(k["name"], 0)
                         + incre_launches.get(k["name"], 0) + city_launches.get(k["name"], 0))
    kernels += study  # K3-K7: counted over the kernel-study programs
    for k in kernels:
        assert k["launches"] > 0, f"{k['name']} never launched on its path"
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
